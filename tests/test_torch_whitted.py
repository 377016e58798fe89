"""rray_tpu_torch/kernels/whitted.py: the plain version of the CUDA
kernel against rray_tpu's Pallas kernel (interpret mode, as
tests/test_wavefront.py runs it), routing, and the launch counter. The
CUDA kernel itself runs only on the card (chip_smoke.py holds it
against this plain version there); the compact W=4 glass case is in
test_torch_whitted_glass.py and the float64 checks against rray_tpu's
XLA path in test_torch_whitted_xla.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rray_tpu.api as jax_api
import torch_parity as tp
from rray_tpu_torch import api
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.kernels import whitted
from rray_tpu_torch.ops import jitter
from rray_tpu_torch.render import integrator


def test_example1_depth0_matches_pallas_kernel():
    jscene, tscene = tp.scenes(tp.EXAMPLE1, "float32")
    o, d = tp.seeded_rays()
    port, shape = tp.port_render_rays(tscene, o, d)
    assert shape == (0, 1)
    tp.assert_f32_budget(port, tp.jax_kernel_rays(jscene, o, d, *shape))


def test_reflection_chain_matches_pallas_kernel():
    """Glass without transparency: the width-1 reflection chain, depth 5."""
    jscene, tscene = tp.scenes(tp.GLASS, "float32", reflection_only=True)
    assert tscene.has_reflective and not tscene.has_transparent
    o, d = tp.seeded_rays()
    port, shape = tp.port_render_rays(tscene, o, d)
    assert shape == (5, 1)
    tp.assert_f32_budget(port, tp.jax_kernel_rays(jscene, o, d, *shape))


def test_cpu_tensors_never_launch_the_kernel():
    _, tscene = tp.scenes(tp.GLASS, "float32")
    o, d = tp.seeded_rays(n=64)
    before = whitted.launches
    tp.port_render_rays(tscene, o, d)
    api.render_scene_from_file(tp.GLASS, 8, 6, "", device="cpu")
    assert whitted.launches == before


@pytest.mark.parametrize("name", ["transparent_operand", "mesh_operand"],
                         ids=["transparent_operand-A10", "mesh_operand-A10"])
def test_unported_scenes_raise(name, tmp_path):
    """CSG scenes the whitted kernel rejects (rray_tpu whitted.py:110-115):
    config 5 with a transparent operand, or with a tetrahedron OBJ as
    its operand. They once raised; the sorted torch node renders them
    now, as rray_tpu does (float64, atol 1e-9)."""
    from rray_tpu_torch.io import mesh_scenes
    from rray_tpu_torch.io.yaml_loader import load_scene_file
    from rray_tpu_torch.scene.data import compile_scene
    path = mesh_scenes.write_config5(
        str(tmp_path), name, **{name: 0.5 if name == "transparent_operand"
                                else True})
    _, lights, shapes = load_scene_file(path)
    scene = compile_scene(shapes, lights, device="cpu")
    assert "sorted torch node" in whitted.unsupported(scene)
    assert integrator.route(scene) == "sorted"
    # 10x8: at 8x6 and at odd heights a config 5 pixel lands on a
    # checker edge of the floor, where rounding picks the square (and
    # rray_tpu's compiled frame differs from its own scan).
    want = np.asarray(jax_api.render_scene_from_file(path, 10, 8, "",
                                                     dtype=jnp.float64))
    got = api.render_scene_from_file(path, 10, 8, "", dtype=torch.float64,
                                     device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_applicable_gating():
    for path in (tp.GLASS, tp.EXAMPLE1):
        assert whitted.applicable(tp.scenes(path, "float32")[1])
    from rray_tpu_torch.io.yaml_loader import load_scene_file
    from rray_tpu_torch.scene.data import Shape, compile_scene
    _, lights, shapes = load_scene_file(tp.GLASS)
    # Glass plus a torus: stage e with the compact wavefront.
    torus = compile_scene(shapes + [Shape("torus", material=shapes[0].material)],
                          lights, device="cpu")
    assert whitted.applicable(torus) and integrator.route(torus) == "kernel"
    assert whitted.needs_ext(torus)
    # More than 16 prims leave the kernel for the torch fast node, which
    # takes opaque scenes: glass with its transparency zeroed.
    for shape in shapes:
        shape.material.transparency = 0.0
    many = compile_scene(shapes * 5, lights, device="cpu")
    assert len(many.prim_kinds) == 20
    assert "more than 16" in whitted.unsupported(many)
    assert integrator.route(many) == "fast"


def test_int_table_layout():
    """The kernel's int tables (kernel_tables): prim kinds, each prim
    row's pattern program start, the programs as [op, row, target, aux]
    and the light levels."""
    _, tscene = tp.scenes(tp.EXAMPLE1, "float32")
    kt = whitted.kernel_tables(
        **whitted.kernel_inputs(tscene, RenderSettings()), R=8)
    words, at = kt.tables.tolist(), dict(zip(whitted.DESC_FIELDS, kt.desc))
    # plane (kind 1) with its checker program at 0, sphere (kind 0) with
    # its solid at 5; the checker (4, row 0) goes on to child a (solid
    # row 1) or to 3 (solid row 2); a ends with a jump (9) past b to 4.
    assert words[at["kinds"]:at["kinds"] + 2] == [1, 0]
    assert words[at["roots"]:at["roots"] + 2] == [0, 5]
    assert words[at["prog"]:at["prog"] + 28] == [
        4, 0, 3, 0, 0, 1, 0, 0, 9, 0, 4, 0, 0, 2, 0, 0, 13, 0, 0, 0,
        0, 3, 0, 0, 13, 0, 0, 0]
    assert words[at["levels"]] == 0
    assert (kt.frames, kt.ext, kt.KB) == (0, False, 0)


def test_cuda_only_wrapper_checks_run_before_launch():
    """The wrapper's argument checks need no card: a float64 or wrongly
    shaped input is refused before any library is loaded."""
    _, tscene = tp.scenes(tp.EXAMPLE1, "float32")
    pat, descrs = whitted.pack_patterns(tscene)
    rays = tuple(torch.zeros(8, dtype=torch.float64) for _ in range(3))
    args = (whitted.pack_prims(tscene), pat, whitted.pack_lights(tscene),
            tscene.prim_kinds, descrs, tscene.prim_pattern_static, 0, 1,
            False, False)
    lights = dict(light_levels=whitted.light_levels(tscene),
                  seeds=jitter.seed_table(0, 0, len(tscene.lights)))
    with pytest.raises(TypeError, match="float32"):
        whitted._launch(rays, rays, *args, **lights)
    rays32 = tuple(torch.zeros(8) for _ in range(3))
    with pytest.raises(ValueError, match="W=3"):
        whitted._launch(rays32, rays32, *args[:7], 3, False, False, **lights)
