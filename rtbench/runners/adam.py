"""Inverse rendering: Adam steps of rray_tpu_torch.parallel.train's step
function, back to back, against a target image.

The trainable leaves are every `.color` and `.intensity` leaf of the
scene (pattern colours, light intensities). The target is the
configuration's true scene, rendered in set-up by the frozen reference
(float32, TF32 off), so both sides fit the same image; setup_s leaves
that render out. The seed scales
each colour and intensity of the scene's YAML by a factor drawn from
[lo, hi] (colours clipped to [0, 1]); the program loads that YAML, and
the reference loads it again.

Set-up builds one train state and one step function, and drives them
through the first `followed` steps with the window's own call; the
window goes on with the same objects. The check, after the window: the
reference follows those first steps (its own loss and gradients through
reference/whitted.py in blocks of rows, Adam by its formula) and gives
three numbers, each the worst over the steps or the leaves:

    loss_gap    |program loss - reference loss| per step, over the
                reference's first loss (the fit drives later losses toward
                0, and a steady gap of 1e-7 would read large against them)
    grad_gap    per leaf, | |g| - |g_ref| | / max(|g_ref|, median leaf's
                |g_ref|); g is the first gradient as Adam holds it,
                exp_avg / (1 - beta1) after one step
    change_gap  the same of each leaf's change over the followed steps;
                leaves whose reference gradient is under a thousandth of
                the median leaf's are left out (Adam moves them by
                round-off alone)
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
import types

import numpy as np

UNIT = "step"
SPANS = (("rray_tpu_torch.parallel.train:render_loss", "render_loss"),)

BETAS = (0.9, 0.999)
EPS = 1e-8
ROUNDOFF = 1e-3


def trainable(key: str) -> bool:
    return ".color" in key or ".intensity" in key


def perturbed(scene: dict, seed: int, lo: float, hi: float) -> dict:
    """The scene with every colour (pattern colours, colour_a/colour_b)
    and light colour scaled by its own factor from [lo, hi] drawn from
    the seed, colours clipped to [0, 1], in the order they appear."""
    from rtbench.harness import seed_words

    rng = np.random.default_rng(seed_words(seed))

    def scaled(v, clip):
        f = float(rng.uniform(lo, hi))
        return [min(max(float(c) * f, 0.0), 1.0) if clip else float(c) * f
                for c in v]

    def walk(node):
        if isinstance(node, dict):
            return {k: (scaled(v, True) if k in ("color", "color_a", "color_b")
                        and isinstance(v, list) else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    out = dict(scene)
    out["scene"] = walk(scene["scene"])
    out["lights"] = [{**light, "color": scaled(light["color"], False)}
                     for light in scene["lights"]]
    return out


def _reference_scene(st, text, dtype):
    from rtbench.reference import whitted as rw

    spec, scene = rw.load(text, st.folder, dtype, st.run.device)
    cfg = st.run.config
    return scene, rw.camera(spec, cfg["width"], cfg["height"], dtype,
                            st.run.device)


def _settings(cfg):
    from rtbench.reference.rconfig import RenderSettings

    return RenderSettings(depth=cfg["depth"],
                          wavefront_capacity=cfg["wavefront_capacity"])


def reference_image(st, text, dtype):
    """The reference's frame of a scene's YAML text, [H, W, 3]."""
    import torch

    from rtbench.reference import whitted as rw

    scene, cam = _reference_scene(st, text, dtype)
    rows = st.run.mix["check_rows"]
    with torch.no_grad():
        return torch.cat([rw.frame_rows(scene, cam, r, min(r + rows, cam.vsize),
                                        _settings(st.run.config))
                          for r in range(0, cam.vsize, rows)])


def setup(run):
    import torch
    import yaml

    from rray_tpu_torch import Camera, compile_camera, compile_scene
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.io.yaml_loader import load_scene_file
    from rray_tpu_torch.parallel import train

    from rtbench.harness import reference_mode
    from rtbench.harness.core import load_libraries

    st = types.SimpleNamespace(run=run)
    cfg, mix = run.config, run.mix
    dev = run.device
    cuda = dev.startswith("cuda")
    load_libraries(run, host=False)
    st.folder = tempfile.mkdtemp(prefix="rtbench-")
    st.true_text = yaml.safe_dump(cfg["scene"])
    st.start_text = yaml.safe_dump(perturbed(cfg["scene"], run.seed,
                                             mix["scale_lo"], mix["scale_hi"]))
    start = os.path.join(st.folder, "start.yaml")
    with open(start, "w") as f:
        f.write(st.start_text)

    t0 = time.perf_counter()
    with reference_mode(torch, dev):
        st.target = reference_image(st, st.true_text, torch.float32)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run.reference_s += time.perf_counter() - t0

    spec, lights, shapes = load_scene_file(start)
    scene = compile_scene(shapes, lights, device=dev)
    cam = Camera(cfg["width"], cfg["height"], spec["fov"])
    cam.transform = spec["transform"]
    cam = compile_camera(cam, torch.float32, dev)
    lr = mix["lr"]
    st.adam = lambda params: torch.optim.Adam(params, lr=lr, betas=BETAS,
                                              eps=EPS)
    settings = RenderSettings(depth=cfg["depth"],
                              wavefront_capacity=cfg["wavefront_capacity"])
    st.state, rest = train.init_train_state(scene, st.adam, trainable)
    st.step = train.make_train_step(rest, cam, settings, st.adam)
    st.keys = list(st.state.params)
    st.p0 = {k: t.detach().clone() for k, t in st.state.params.items()}
    st.losses = []
    for i in range(mix["followed"]):
        step(st, i, first=True)
        if i == 0:
            st.g1 = first_gradient(st.state)
    st.p_followed = {k: t.detach().clone()
                     for k, t in st.state.params.items()}
    return st


def first_gradient(state):
    """The first gradient as Adam holds it after one step: exp_avg /
    (1 - beta1), per leaf in the parameters' order."""
    keys = list(state.params)
    per = state.opt_state["state"]
    return {k: per[i]["exp_avg"].detach().clone() / (1.0 - BETAS[0])
            for i, k in enumerate(keys) if i in per}


def step(st, i, first=False):
    import torch

    st.state, loss = st.step(st.state, st.target)
    if first:
        st.losses.append(float(loss))
    elif st.run.device.startswith("cuda"):
        torch.cuda.synchronize()


def reference_follow(st, dtype, half=False):
    """The reference's losses, first gradient and parameters after the
    followed steps, from the same start; `half`: the loss is the mean
    over the upper half of the rows alone (a planted fault)."""
    import torch

    from rtbench.reference import data as rsd
    from rtbench.reference import whitted as rw

    scene, cam = _reference_scene(st, st.start_text, dtype)
    params = {k: t.detach().clone() for k, t in rsd.float_leaves(scene)
              if trainable(k)}
    if list(params) != st.keys:
        raise ValueError(f"reference leaves {list(params)} are not the "
                         f"program's {st.keys}")
    target = st.target.to(dtype)
    settings = _settings(st.run.config)
    rows = st.run.mix["check_rows"]
    H = cam.vsize // 2 if half else cam.vsize
    n = H * cam.hsize * 3
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    losses, g1 = [], None
    lr = st.run.mix["lr"]
    for t in range(1, st.run.mix["followed"] + 1):
        leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
        sc = rsd.canonicalize(rsd.replace_leaves(scene, leaves))
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        loss = 0.0
        for r in range(0, H, rows):
            r1 = min(r + rows, H)
            with torch.enable_grad():
                img = rw.frame_rows(sc, cam, r, r1, settings)
                part = ((img - target[r:r1]) ** 2).sum() / n
                got = torch.autograd.grad(part, list(leaves.values()),
                                          allow_unused=True)
            loss += float(part.detach())
            for k, g in zip(leaves, got):
                if g is not None:
                    grads[k] += g
        losses.append(loss)
        if t == 1:
            g1 = {k: g.clone() for k, g in grads.items()}
        for k, p in params.items():  # torch.optim.Adam's update
            g = grads[k]
            m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
            v[k] = BETAS[1] * v[k] + (1 - BETAS[1]) * g * g
            mhat = m[k] / (1 - BETAS[0] ** t)
            vhat = v[k] / (1 - BETAS[1] ** t)
            params[k] = p - lr * mhat / (vhat.sqrt() + EPS)
    return losses, g1, params


def _norm(t):
    return float(t.double().norm())


def leaf_gap(ours: dict, ref: dict, keep) -> float:
    """Worst leaf of | |ours| - |ref| | / max(|ref|, median leaf |ref|)
    over the leaves `keep` names."""
    keys = [k for k in ref if k in keep]
    if not keys:
        return float("nan")
    med = float(np.median([_norm(ref[k]) for k in keys]))
    return max(abs(_norm(ours[k]) - _norm(ref[k])) / max(_norm(ref[k]), med)
               for k in keys)


def compare(st, losses, g1, params, ref_losses, ref_g1, ref_params):
    gnorm = {k: _norm(g) for k, g in ref_g1.items()}
    med = float(np.median(list(gnorm.values())))
    moved = {k for k, g in gnorm.items() if g >= ROUNDOFF * med}
    dev = st.run.device
    change = {k: params[k].to(dev).double() - st.p0[k].double()
              for k in params}
    ref_change = {k: ref_params[k].to(dev).double() - st.p0[k].double()
                  for k in ref_params}
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(losses, ref_losses))
        / abs(ref_losses[0]),
        "grad_gap": leaf_gap({k: g1.get(k, ref_g1[k] * 0) for k in ref_g1},
                             ref_g1, set(ref_g1)),
        "change_gap": leaf_gap(change, ref_change, moved),
    }


def check(st, control=False, fault=None):
    """The numbers. `control`: the reference in bfloat16 stands in for
    the program. `fault` ("half"): the reference with half of the rows
    left out of its loss stands in for the program."""
    import torch

    from rtbench.harness import reference_mode

    with reference_mode(torch, st.run.device):
        ref = reference_follow(st, torch.float32)
        if control:
            ours = reference_follow(st, torch.bfloat16)
        elif fault == "half":
            ours = reference_follow(st, torch.float32, half=True)
        else:
            ours = (st.losses, st.g1, st.p_followed)
        st.losses_compared = (ours[0], ref[0])
        return compare(st, *ours, *ref)


def close(st):
    shutil.rmtree(st.folder, ignore_errors=True)
