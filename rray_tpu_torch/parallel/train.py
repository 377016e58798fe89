"""Inverse rendering: scene parameters trained against a target image
(rray_tpu parallel/train.py, on one device).

Every floating-point leaf of a SceneData (transforms, materials, lights,
pattern payloads) is a parameter that autograd reaches through
`render`, on every route (integrator.WhittedKernel on the kernel route,
the torch nodes elsewhere). Leaves are named by the key-path strings of
rray_tpu's `jax.tree_util.keystr` (".prim_inv", ".lights[0].intensity",
".patterns[0].a.color"), so one `trainable` predicate selects the same
leaves in both packages. `torch.optim` takes the place of optax; the
optimizer's state travels in TrainState as its state_dict, as optax's
does. The step runs on the scene's device.

The sharded step (`mesh=`, parallel/mesh.py): each entry renders its
block of raster rows and takes its share of the whole frame's mean, the
sum of its squared errors over vsize * hsize * 3. (A mean per entry,
averaged over the entries, would weigh the pixels of a short block
more.) Over a process group the gradients (and the loss) are summed
over the ranks in one all-reduce, so every rank steps the same
parameters with the single-process gradients. Over a local mesh each
entry renders from differentiable `.to(device)` copies of the one set
of parameters (mesh.run_entries; on the parameters' own device the
parameters themselves), the shares are summed on the first entry's
device, and one backward reaches the parameters through the copies; no
collective runs.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

import torch.distributed as dist

from ..config import RenderSettings
from ..ops.vec import div
from ..render.camera import CameraData
from ..render.integrator import render, render_block
from ..scene import data as sd
from .mesh import Mesh, replica, row_block, run_entries


def partition_scene(scene: sd.SceneData, trainable=None):
    """Split a scene into (params, rest): params maps the key path of
    every float leaf that `trainable` (a predicate over the key path;
    None takes every float leaf) selects to the scene's tensor; rest is
    the scene, which holds the other leaves and the structure."""
    params = {k: t for k, t in sd.float_leaves(scene)
              if trainable is None or trainable(k)}
    return params, scene


def merge_scene(params: dict, rest: sd.SceneData) -> sd.SceneData:
    """The scene `rest` with the tensors of `params` in place of its
    own: a new SceneData, so no table cached for the old tensors
    carries over."""
    return sd.replace_leaves(rest, params)


def render_loss(params: dict, rest, cam: CameraData, target, settings,
                seed: int = 0, mesh: Mesh = None):
    """Mean-squared pixel loss of a full render against `target`. With a
    process-group mesh, this rank's share of it: the squared errors of
    its block of rows (mesh.row_block) summed and divided by the whole
    frame's vsize * hsize * 3, which the ranks' shares sum to. With a
    local mesh, every entry's share, from replicas of the parameters,
    summed in entry order on the mesh's first device: the whole loss."""
    if mesh is None:
        image = render(merge_scene(params, rest), cam, settings, seed)
        return torch.mean((image - target) ** 2)
    if not mesh.devices:
        return _share(merge_scene(params, rest), cam, target, settings,
                      seed, row_block(cam.vsize, mesh))
    parts = [(merge_scene({k: t.to(d) for k, t in params.items()},
                          replica(rest, d)), replica(cam, d), target.to(d))
             for d in mesh.devices]
    shares = run_entries(mesh, lambda i, device: _share(
        *parts[i], settings, seed, row_block(cam.vsize, mesh, i)))
    return sum((s.to(mesh.device) for s in shares[1:]),
               shares[0].to(mesh.device))


def _share(scene, cam: CameraData, target, settings, seed, rows):
    """The squared errors of raster rows rows[0]:rows[1] against the
    target's, over the whole frame's vsize * hsize * 3."""
    r0, r1, _ = rows
    block = render_block(scene, cam, r0, r1, settings, seed)
    return div(((block - target[r0:r1]) ** 2).sum(),
               cam.vsize * cam.hsize * 3)


def all_reduce_grads(params: dict, loss, mesh: Mesh):
    """Sum every parameter's gradient and the loss over the mesh's ranks
    in one all-reduce of one flat buffer -> the summed loss; the
    gradients are replaced in place. A parameter that no rank's graph
    reached keeps grad None, as in a single-process step."""
    tensors = list(params.values())
    ref = tensors[0]
    flat = torch.cat(
        [(t.grad if t.grad is not None else torch.zeros_like(t)).reshape(-1)
         for t in tensors]
        + [loss.detach().reshape(1).to(ref.dtype),
           torch.tensor([float(t.grad is not None) for t in tensors],
                        dtype=ref.dtype, device=ref.device)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    *grads, total, present = flat.split(
        [t.numel() for t in tensors] + [1, len(tensors)])
    for t, g, reached in zip(tensors, grads, present.tolist()):
        t.grad = g.reshape(t.shape).clone() if reached else None
    return total.reshape(())


class TrainState(NamedTuple):
    params: dict      # key path -> leaf tensor (requires grad)
    opt_state: Any    # the optimizer's state_dict
    step: int


def init_train_state(scene: sd.SceneData, optimizer: Callable,
                     trainable=None):
    """-> (TrainState, rest). The parameters are copies of the scene's
    leaves that require grad; `optimizer` makes a torch.optim optimizer
    from a list of tensors (e.g. lambda p: torch.optim.Adam(p, lr=5e-2))
    and gives the initial state."""
    params, rest = partition_scene(scene, trainable)
    params = {k: t.detach().clone().requires_grad_() for k, t in
              params.items()}
    opt_state = optimizer(list(params.values())).state_dict()
    return TrainState(params, opt_state, 0), rest


def make_train_step(rest, cam: CameraData, settings: RenderSettings,
                    optimizer: Callable, mesh: Mesh = None,
                    axis: str = "rays"):
    """A train step closed over the scene's structure: step(state,
    target, seed=0) -> (new state, the loss before the update). The
    optimizer `optimizer` makes (the factory given to init_train_state)
    takes the state's opt_state, one gradient of render_loss, and steps
    the parameters in place. With a process-group mesh (parallel/mesh.py,
    its axis named `axis`), every rank calls the step with the whole
    target: it renders its rows, all_reduce_grads sums the gradients and
    the loss over the ranks, and each rank steps its own copy of the
    parameters identically. With a local mesh, render_loss renders every
    entry's rows from copies of the parameters and one backward sums
    their gradients into the parameters."""
    if mesh is not None and axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")

    def step(state: TrainState, target, seed: int = 0):
        opt = optimizer(list(state.params.values()))
        opt.load_state_dict(state.opt_state)
        opt.zero_grad(set_to_none=True)
        loss = render_loss(state.params, rest, cam,
                           target.to(rest.device), settings, seed, mesh)
        if loss.requires_grad:
            loss.backward()
        if mesh is not None and mesh.size > 1 and not mesh.devices:
            loss = all_reduce_grads(state.params, loss, mesh)
        opt.step()
        return TrainState(state.params, opt.state_dict(),
                          state.step + 1), loss.detach()

    return step
