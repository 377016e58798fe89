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
does. The step runs on the scene's device. rray_tpu's sharded step
(`mesh=`, `axis=`) is not ported here.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..config import RenderSettings
from ..render.camera import CameraData
from ..render.integrator import render
from ..scene import data as sd


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
                seed: int = 0):
    """Mean-squared pixel loss of a full render against `target`."""
    image = render(merge_scene(params, rest), cam, settings, seed)
    return torch.mean((image - target) ** 2)


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
                    optimizer: Callable):
    """A train step closed over the scene's structure: step(state,
    target, seed=0) -> (new state, the loss before the update). The
    optimizer `optimizer` makes (the factory given to init_train_state)
    takes the state's opt_state, one gradient of render_loss, and steps
    the parameters in place."""
    def step(state: TrainState, target, seed: int = 0):
        opt = optimizer(list(state.params.values()))
        opt.load_state_dict(state.opt_state)
        opt.zero_grad(set_to_none=True)
        loss = render_loss(state.params, rest, cam,
                           target.to(rest.device), settings, seed)
        loss.backward()
        opt.step()
        return TrainState(state.params, opt.state_dict(),
                          state.step + 1), loss.detach()

    return step
