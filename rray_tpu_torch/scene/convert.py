"""Scene state carried across from rray_tpu.

A scene compiled (or trained) in rray_tpu travels as plain data: its
tensor leaves as numpy arrays (`fields`) and its structural metadata as
plain Python (`meta`), split the way rray_tpu's pytree registration
splits SceneData, PatternData and LightData. `scene_from_numpy` builds
the port's SceneData from that pair, so the two packages can compute on
the very same tables.

`scene_to_numpy` produces the pair from either package's SceneData: it
reads attributes and copies each leaf to a host numpy array (a torch
tensor detached first, so a scene trained in the port, on the card or
with leaves that require grad, carries back to rray_tpu); it needs no
JAX import.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import checked_device
from . import data as sd


def _np(v):
    """A leaf of either package as a host numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _pattern_to_numpy(p):
    if p is None:
        return None, None
    a_f, a_m = _pattern_to_numpy(p.a)
    b_f, b_m = _pattern_to_numpy(p.b)
    tex = None if p.texture is None else _np(p.texture)
    fields = dict(inv=_np(p.inv), color=_np(p.color), scale=_np(p.scale),
                  persistence=_np(p.persistence), texture=tex,
                  a=a_f, b=b_f)
    return fields, dict(ptype=p.ptype, octaves=int(p.octaves), a=a_m, b=b_m)


def scene_to_numpy(scene):
    """(fields, meta) of a SceneData from either package."""
    fields = {name: _np(getattr(scene, name)) for name in sd.TENSOR_FIELDS}
    meta = {name: getattr(scene, name) for name in sd.STATIC_FIELDS}
    light_f, light_m = [], []
    for light in scene.lights:
        opt = lambda v: None if v is None else _np(v)
        light_f.append(dict(position=_np(light.position),
                            intensity=_np(light.intensity),
                            corner=opt(light.corner), uvec=opt(light.uvec),
                            vvec=opt(light.vvec)))
        light_m.append(dict(kind=light.kind, level=int(light.level)))
    fields["lights"], meta["lights"] = light_f, light_m
    pats = [_pattern_to_numpy(p) for p in scene.patterns]
    fields["patterns"] = [f for f, _ in pats]
    meta["patterns"] = [m for _, m in pats]
    return fields, meta


_FLOAT_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def _to_tensor(arr, dtype, device):
    # torch.tensor copies: the arrays may be read-only views of another
    # framework's buffers.
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        return torch.tensor(arr, dtype=torch.bool, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        # Packed RGB8 textures arrive as uint32; every value is < 2^24.
        return torch.tensor(arr.astype(np.int32), dtype=torch.int32,
                            device=device)
    return torch.tensor(arr, dtype=dtype, device=device)


def _pattern_from_numpy(f, m, dtype, device):
    if f is None:
        return None
    t = lambda v: _to_tensor(v, dtype, device)
    return sd.PatternData(
        ptype=m["ptype"], octaves=int(m["octaves"]), inv=t(f["inv"]),
        color=t(f["color"]), scale=t(f["scale"]),
        persistence=t(f["persistence"]),
        texture=None if f["texture"] is None else t(f["texture"]),
        a=_pattern_from_numpy(f["a"], m["a"], dtype, device),
        b=_pattern_from_numpy(f["b"], m["b"], dtype, device))


def scene_from_numpy(fields, meta, device="cuda",
                     dtype=None) -> sd.SceneData:
    """Build the port's SceneData from (fields, meta) on `device` (the
    card unless the caller passes "cpu"; config.checked_device).

    `dtype` is the float dtype of the tables; by default the float dtype
    of `fields["cls_table"]` is kept."""
    device = checked_device(device)
    dtype = dtype or _FLOAT_DTYPES[np.asarray(fields["cls_table"]).dtype]
    t = lambda v: _to_tensor(v, dtype, device)
    opt = lambda v: None if v is None else t(v)
    lights = tuple(
        sd.LightData(kind=m["kind"], level=int(m["level"]),
                     position=t(f["position"]), intensity=t(f["intensity"]),
                     corner=opt(f["corner"]), uvec=opt(f["uvec"]),
                     vvec=opt(f["vvec"]))
        for f, m in zip(fields["lights"], meta["lights"]))
    patterns = tuple(_pattern_from_numpy(f, m, dtype, device)
                     for f, m in zip(fields["patterns"], meta["patterns"]))
    statics = {name: meta[name] for name in sd.STATIC_FIELDS}
    return sd.SceneData(
        **{name: t(fields[name]) for name in sd.TENSOR_FIELDS},
        lights=lights, patterns=patterns, **statics)
