"""The whitted kernel's launch layout, checked without a card: the tile
map (kernels/whitted.py tile_ray_index mirrors csrc/whitted.cu tile_ray),
the CSG slot bucket, the pattern programs' frame counts, and the wrapper's
shared-memory limit."""
import os

import numpy as np
import pytest
import torch

from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.kernels import whitted
from rray_tpu_torch.scene.data import (Material, PointLight, Shape,
                                       compile_scene)

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    _, lights, shapes = load_scene_file(os.path.join(BASE, "examples", name))
    return compile_scene(shapes, lights, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("w,h", [(9600, 5400), (161, 97), (7, 5), (300, 1)])
def test_tile_map_is_a_permutation(w, h):
    """Every ray of a w x h raster lands on exactly one (tile, thread)
    slot: masked slots are -1 and the rest are a permutation of [0, R)."""
    idx = whitted.tile_ray_index(w * h, w)
    live = idx[idx >= 0]
    assert live.numel() == w * h
    assert torch.equal(torch.sort(live).values, torch.arange(w * h))


def test_tile_map_puts_warps_on_8x4_subtiles():
    """Warp k of a 16x8 tile covers the 8x4 pixels (8 (k % 2) + 0..7,
    4 (k // 2) + 0..3) of that tile; without a raster width tiles are
    128 rays in row order."""
    w = 40
    idx = whitted.tile_ray_index(w * 24, w).reshape(-1, 4, 32)
    tiles_x = (w + 15) // 16
    for tile in (0, 1, tiles_x + 1):
        for warp in range(4):
            x, y = idx[tile, warp] % w, idx[tile, warp] // w
            x0 = (tile % tiles_x) * 16 + 8 * (warp % 2)
            y0 = (tile // tiles_x) * 8 + 4 * (warp // 2)
            assert sorted(set(x.tolist())) == list(range(x0, x0 + 8))
            assert sorted(set(y.tolist())) == list(range(y0, y0 + 4))
    rows = whitted.tile_ray_index(1000)
    assert torch.equal(rows[:1000], torch.arange(1000))
    assert bool((rows[1000:] == -1).all())


def _csg_of(n):
    """A union of n spheres in a row, as one CSG tree."""
    leaves = [Shape("sphere", transform=np.array(
        [[1, 0, 0, 2.5 * k], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]]))
        for k in range(n)]
    node = leaves[0]
    for leaf in leaves[1:]:
        node = Shape("csg", operation="union", left=node, right=leaf)
    return compile_scene([node], [PointLight(np.array([-5.0, 5.0, -5.0]),
                                             np.ones(3))],
                         dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("case,bucket", [("csg_showcase.yaml", 8),
                                         ("example1.yaml", 8), (16, 80),
                                         (4, 8), (5, 80)])
def test_slot_bucket(case, bucket):
    """The CSG member-slot bucket of the W = 1 stage-e kernel: 8 for
    config 5 (a cube and a sphere: 4 slots), 80 for a 16-prim CSG."""
    scene = _example(case) if isinstance(case, str) else _csg_of(case)
    inputs = whitted.kernel_inputs(scene, RenderSettings())
    assert whitted.slot_bucket(inputs["kinds"],
                               inputs.get("csg", ((), ()))) == bucket
    if whitted.uses_ext(inputs["kinds"], inputs["pat_descrs"],
                        inputs.get("csg", ((), ()))):
        args = {k: v for k, v in inputs.items() if k != "tex_tbl"}
        assert whitted.kernel_tables(**args, R=1).KB == bucket


@pytest.mark.parametrize("name,frames", [("example1.yaml", 0),
                                         ("glass.yaml", 0),
                                         ("csg_showcase.yaml", 1)])
def test_pattern_program_frames(name, frames):
    """Select nodes push nothing; config 5's gradient and noise nodes push
    one frame each, so a thread's stack holds one frame there."""
    inputs = whitted.kernel_inputs(_example(name), RenderSettings())
    prog, roots, n = whitted.pattern_program(inputs["pat_descrs"],
                                             inputs["prim_pat"])
    assert n == frames
    assert len(roots) == len(inputs["prim_pat"])
    assert sum(op == whitted.OP_END for op, _, _, _ in prog) == len(
        inputs["pat_descrs"])


def test_launch_refuses_tables_past_the_opt_in_limit():
    """Tables past the 227 KB a block may opt in to raise before any
    launch, naming each table's size."""
    inputs = whitted.kernel_inputs(_example("example1.yaml"),
                                   RenderSettings())
    depth = 60000
    inputs.update(depth=depth, seeds=torch.zeros((depth + 1, 1),
                                                 dtype=torch.int32))
    rays = tuple(torch.zeros(8) for _ in range(3))
    with pytest.raises(ValueError, match=r"jitter seeds 240004.*opt in"):
        whitted._launch(rays, rays, **inputs, width=8)


def test_wrapper_takes_a_raster_width_on_the_cpu():
    """The plain version ignores the raster width: the image is the same
    with and without it."""
    scene = _example("example1.yaml")
    inputs = whitted.kernel_inputs(scene, RenderSettings())
    rng = np.random.default_rng(0)
    d = rng.normal(size=(3, 64)) + np.array([[0.0], [0.0], [1.0]])
    d /= np.linalg.norm(d, axis=0)
    ro = tuple(torch.tensor(v, dtype=torch.float32)
               for v in ([0.0] * 64, [1.5] * 64, [-5.0] * 64))
    rd = tuple(torch.tensor(v, dtype=torch.float32) for v in d)
    a = whitted.whitted_compact(ro, rd, **inputs, width=8)
    b = whitted.whitted_compact(ro, rd, **inputs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
