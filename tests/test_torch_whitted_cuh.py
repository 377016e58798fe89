"""The CUDA kernels' device code against the plain versions, on the CPU.

kernels/csrc/whitted_device.cuh holds everything one thread of the
whitted kernel runs (trace_ray<W, kExt, KB> and the node, slot, shadow,
area sample, pattern program, CSG and mesh-fold functions, over the
tables kernels/whitted.py kernel_tables packs) and the area-shadow
kernel's per-origin body (area_count), mesh_device.cuh what one thread
of the triangle and BVH kernels runs (Möller–Trumbore, the chunk folds,
the warp-uniform group fold, the heap walk, the output writer),
jitter_device.cuh the area lights' jitter hash, quartic_device.cuh and
noise_device.cuh stage e's torus quartic and Perlin noise. They need
only two function-qualifier macros and the C math library, so they also
compile as host C++. Built here with g++ and -ffp-contract=off (the host
analogue of the kernels' --fmad=false), they are held against the plain
versions on camera rays and seeded rays. This checks the kernels'
arithmetic and control flow wherever there is no card; the CUDA build
itself is checked on the card by chip_smoke.py."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.kernels import analytic, bvh, triangles, whitted
from rray_tpu_torch.ops import jitter
from rray_tpu_torch.render.camera import Camera, all_rays_soa, compile_camera
from rray_tpu_torch.scene import data as sd
from rray_tpu_torch.scene.data import compile_scene

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(BASE, "rray_tpu_torch", "kernels", "csrc")

HARNESS = r"""
#include <math.h>
#include <string.h>
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#define RRAY_DEVICE inline
#define RRAY_NOINLINE
#include "whitted_device.cuh"
using namespace rray;
// The kernel's scene from kernels/whitted.py kernel_tables' words; the
// pattern stack a local array (a column of shared memory on the card).
static SceneDesc make_desc(const int* desc, const float* texels) {
  SceneDesc d;
  memcpy(d.w, desc, sizeof d.w);
  d.texels = texels;
  return d;
}
template <int W, bool E, int KB>
static void run(const Scene& s, const float* const* rays, float* const* out) {
  float frames[MAX_FRAMES * FRAME_WORDS];
  const Stack stk = {frames, 1};
  for (int i = 0; i < s.at(D_R); ++i) {
    float rgb[3];
    trace_ray<W, E, KB>(s, stk, v3(rays[0][i], rays[1][i], rays[2][i]),
                        v3(rays[3][i], rays[4][i], rays[5][i]), rgb);
    for (int c = 0; c < 3; ++c) out[c][i] = rgb[c];
  }
}
extern "C" void trace_all(const float* const* rays, float* const* out,
                          const float* tables, const int* desc,
                          const float* texels, int W, int ext, int KB) {
  const SceneDesc d = make_desc(desc, texels);
  const Scene s = {&d, tables};
  switch (W * 1000 + (ext != 0) * 100 + KB) {
    case 1000: run<1, false, 0>(s, rays, out); break;
    case 4000: run<4, false, 0>(s, rays, out); break;
    case 32000: run<32, false, 0>(s, rays, out); break;
    case 1108: run<1, true, 8>(s, rays, out); break;
    case 1180: run<1, true, 80>(s, rays, out); break;
    case 4100: run<4, true, 0>(s, rays, out); break;
  }
}
// One pattern program from instruction `pc` at points pts, on a prim of
// kind `kind` (row pw) for image leaves.
extern "C" void pattern_all(const float* tables, const int* desc,
                            const float* texels, int pc,
                            const float* const* pts, int kind,
                            const float* pw, float* const* out, int R) {
  const SceneDesc d = make_desc(desc, texels);
  const Scene s = {&d, tables};
  float frames[MAX_FRAMES * FRAME_WORDS];
  const Stack stk = {frames, 1};
  for (int i = 0; i < R; ++i) {
    const V3 c = eval_program<true>(s, stk, pc,
                                    v3(pts[0][i], pts[1][i], pts[2][i]),
                                    kind, pw);
    out[0][i] = c.x;
    out[1][i] = c.y;
    out[2][i] = c.z;
  }
}
// Stage e's building blocks, one value per input.
extern "C" void noise_all(const float* const* pts, int octaves,
                          float persistence, float* out, int R) {
  for (int i = 0; i < R; ++i)
    out[i] = octave_perlin(pts[0][i], pts[1][i], pts[2][i], octaves,
                           persistence);
}
extern "C" void quartic_all(const float* const* coeffs, float* roots,
                            int* valids, int R) {
  for (int i = 0; i < R; ++i) {
    const Roots4 q = solve_quartic(coeffs[0][i], coeffs[1][i], coeffs[2][i],
                                   coeffs[3][i], coeffs[4][i]);
    for (int k = 0; k < 4; ++k) {
      roots[k * R + i] = q.r[k];
      valids[k * R + i] = (q.valid >> k) & 1u;
    }
  }
}
// The area-shadow kernel's body (area.cu) and the jitter hash.
extern "C" void area_all(const float* const* over, const float* light,
                         const float* params, const float* bounds,
                         const int* kinds, int P, int level, int seed,
                         float* count, int R) {
  float seg[SEG_WORDS * AREA_CHUNK];
  for (int i = 0; i < R; ++i)
    count[i] = area_count(light, params, bounds, kinds, P, level, seed,
                          v3(over[0][i], over[1][i], over[2][i]), seg, 1);
}
extern "C" void jitter_all(const float* const* pts, int seed, int n,
                           unsigned* base, float* draws, int R) {
  for (int i = 0; i < R; ++i) {
    base[i] = point_base(seed, pts[0][i], pts[1][i], pts[2][i]);
    for (int k = 0; k < n; ++k) draws[k * R + i] = draw_unit(base[i], k);
  }
}
// The triangle kernels' bodies (triangles.cu, bvh.cu), one ray at a time.
extern "C" void closest_all(const float* const* rays, const float* bound,
                            const float* tris, int ncols, int T,
                            const float* boxes, int n_chunks, int chunk,
                            int normals, int n_aux, float* fout, int* iout,
                            int R) {
  for (int i = 0; i < R; ++i) {
    TriHit h = closest_chunks(tris, ncols, T, boxes, n_chunks, chunk,
                              v3(rays[0][i], rays[1][i], rays[2][i]),
                              v3(rays[3][i], rays[4][i], rays[5][i]),
                              bound ? bound[i] : INFINITY);
    write_hit(h, tris, ncols, normals, n_aux, fout, iout, R, i);
  }
}
extern "C" void any_all(const float* const* rays, const float* dist,
                        const float* tris, int ncols, int T,
                        const float* boxes, int n_chunks, int chunk, int* hit,
                        int R) {
  for (int i = 0; i < R; ++i)
    hit[i] = any_chunks(tris, ncols, T, boxes, n_chunks, chunk,
                        v3(rays[0][i], rays[1][i], rays[2][i]),
                        v3(rays[3][i], rays[4][i], rays[5][i]), dist[i]);
}
extern "C" void group_all(const float* const* rays, const float* bound,
                          const float* block, int T, int group, int chunk,
                          int any_hit, const float* tris, int ncols,
                          int normals, int n_aux, float* fout, int* iout,
                          int* hit, int R) {
  for (int i = 0; i < R; ++i) {
    TriHit h = group_fold(block, T, group, chunk,
                          v3(rays[0][i], rays[1][i], rays[2][i]),
                          v3(rays[3][i], rays[4][i], rays[5][i]),
                          bound ? bound[i] : INFINITY, any_hit != 0, true);
    if (any_hit)
      hit[i] = h.t < INFINITY;
    else
      write_hit(h, tris, ncols, normals, n_aux, fout, iout, R, i);
  }
}
extern "C" void bvh_all(const float* const* rays, const float* dist,
                        const float* block, int node_words, int T, int Lp,
                        int leaf, int any_hit, const float* tris, int ncols,
                        int normals, int n_aux, float* fout, int* iout,
                        int R) {
  for (int i = 0; i < R; ++i) {
    TriHit h = bvh_walk(block, block + node_words, T, Lp, leaf,
                        v3(rays[0][i], rays[1][i], rays[2][i]),
                        v3(rays[3][i], rays[4][i], rays[5][i]),
                        dist ? dist[i] : INFINITY, any_hit != 0, true);
    write_hit(h, tris, ncols, normals, n_aux, fout, iout, R, i);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the device code as host C++")
    d = tmp_path_factory.mktemp("cuh")
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(d / "libharness.so"),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=300)
    return ctypes.CDLL(str(d / "libharness.so"))


def _c(a):
    return ctypes.c_void_p(None if a is None else a.ctypes.data)


def _np(t):
    return None if t is None else np.ascontiguousarray(t.numpy())


def _ptrs(xs):
    return (ctypes.c_void_p * len(xs))(*(x.ctypes.data for x in xs))


def _host_trace(lib, rays, prim_tbl, pat_tbl, light_tbl, kinds, pat_descrs,
                prim_pat, depth, W, has_refl, has_refr, tri_tbl=None,
                tri_boxes=None, light_levels=None, seeds=None, csg=((), ()),
                tex_tbl=None, tex_meta=(), KB=None):
    """The host-compiled trace_ray over the kernel's staged tables, as
    the wrapper packs them; KB overrides the CSG slot bucket."""
    R = rays[0].shape[0]
    arrs = [_np(r) for r in rays]
    outs = [np.empty(R, np.float32) for _ in range(3)]
    kt = whitted.kernel_tables(
        prim_tbl, pat_tbl, light_tbl, kinds, pat_descrs, prim_pat, depth, W,
        has_refl, has_refr, tri_tbl, tri_boxes, light_levels=light_levels,
        seeds=seeds, csg=csg, tex_meta=tex_meta, R=R)
    assert kt.frames <= 7
    tables, desc = _np(kt.tables), np.asarray(kt.desc, np.int32)
    i = ctypes.c_int
    lib.trace_all(_ptrs(arrs), _ptrs(outs), _c(tables), _c(desc),
                  _c(_np(tex_tbl)), i(W), i(kt.ext),
                  i(kt.KB if KB is None else KB))
    return np.stack(outs)


# Mesh scenes of the in-kernel mesh (stage d): smooth, reflective (the
# width-1 chain replays the fold per level), flat with analytic spheres;
# and under config 3's area light (stage c): with a mesh (c + d), and
# analytic spheres over a reflective floor (per-level seeds).
MESH_SCENES = {"mesh": dict(lat_lon=(11, 11)),
               "mesh_reflective": dict(lat_lon=(11, 11), reflective=0.3),
               "mesh_flat_spheres": dict(lat_lon=(6, 6), smooth=False,
                                         spheres=3),
               "area_mesh": dict(lat_lon=(6, 5), area_level=3),
               "area_reflective": dict(lat_lon=None, spheres=4,
                                       reflective=0.3, area_level=2)}
# Stage e: config 5 (CSG, torus, noise, texture) and `csg5r` (config 5
# with a perturbed stripe on the torus, a reflective floor and config 3's
# area light: stages c and e along the width-1 chain).
CONFIG5_SCENES = {"csg5r": dict(floor_reflective=0.3, area_level=5,
                                perturbed_torus=True)}


def _scene_path(name, tmp):
    if name in MESH_SCENES:
        return ms.write_scene(tmp, name, **MESH_SCENES[name])
    if name in CONFIG5_SCENES:
        return ms.write_config5(str(tmp), name, **CONFIG5_SCENES[name])
    return os.path.join(BASE, "examples", name)


@pytest.mark.parametrize("name,cap", [("example1.yaml", 4), ("glass.yaml", 4),
                                      ("glass.yaml", 32), ("mesh", 4),
                                      ("mesh_reflective", 4),
                                      ("mesh_flat_spheres", 4),
                                      ("area_light.yaml", 4), ("area_mesh", 4),
                                      ("area_reflective", 4),
                                      ("csg_showcase.yaml", 4), ("csg5r", 4)])
def test_device_code_matches_plain_version(host_lib, name, cap, tmp_path):
    cam_spec, lights, shapes = load_scene_file(_scene_path(name, tmp_path))
    scene = compile_scene(shapes, lights, dtype=torch.float32, device="cpu")
    assert whitted.applicable(scene)
    cam = Camera(96, 72, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    ro, rd = all_rays_soa(compile_camera(cam, torch.float32, "cpu"))
    rays = (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)
    args = whitted.kernel_inputs(scene, RenderSettings(wavefront_capacity=cap),
                                 seed=11)
    # One intra-op thread for the plain version. ATen's float sqrt runs
    # MKL's vector sqrt (not correctly rounded) on chunks of 2048
    # elements spread over the threads, and a chunk computed on another
    # thread came out different in a few processes of many (example1:
    # rays 3456-5183, the sphere's rows, up to 1.4e-4 after the
    # shininess exponent; an op-by-op trace put the first difference at
    # aten.sqrt on identical input). On one thread every run agreed.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = np.stack([c.numpy() for c in
                          whitted.whitted_compact_reference(
                              rays[:3], rays[3:], **args)])
    finally:
        torch.set_num_threads(threads)
    # A CSG scene runs in both slot buckets (registers and the general
    # form); both must give the same image.
    buckets = whitted.SLOT_BUCKETS if args.get("csg", ((), ()))[1] else (None,)
    hosts = [_host_trace(host_lib, rays, **args, KB=kb) for kb in buckets]
    for other in hosts[1:]:
        np.testing.assert_array_equal(other, hosts[0])
    host = hosts[0]
    # Same operations in the same order; glibc's powf/sqrtf-based rsqrt
    # and PyTorch's vectorized pow/rsqrt may differ by an ulp, which the
    # shininess exponent can grow to ~1e-7 (measured max 1.3e-7). A
    # boundary decision flipped by such an ulp would exceed 1e-6: none
    # was measured, 0.1% of rays is allowed. Stage e adds the torus's
    # quartic, whose f32 roots move by up to 1e-3 with one ulp of a sqrt
    # (PyTorch's CPU sqrt is not correctly rounded; glibc's and CUDA's
    # are): measured 2 of 6912 rays over 1e-6 on config 5, max 8e-5.
    diff = np.abs(host - plain).max(axis=0)
    assert np.isfinite(host).all()
    assert float((diff <= 1e-6).mean()) >= 0.999, diff.max()
    assert diff.max() <= 1.0 / 255.0
    if any(args["light_levels"]) and not whitted.needs_ext(scene):
        # Stage c: the jitter hash, the sample loop and the fraction are
        # the plain version's bit for bit (measured on all three area
        # scenes, specular highlights included).
        np.testing.assert_array_equal(host, plain)


def _seeded_mesh(T, seed, normals):
    """Clustered random triangles in front of seeded rays (float32)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.0, 2.0, (3, T))
    cols = [*(centers + rng.uniform(-0.3, 0.3, (3, T))),
            *rng.uniform(-0.6, 0.6, (6, T))]
    if normals:
        cols += list(rng.normal(size=(9, T)))
    R = 512
    o = rng.uniform(-1, 1, (3, R)) + np.array([[0.0], [0.0], [-8.0]])
    d = rng.uniform(-0.3, 0.3, (3, R)) + np.array([[0.0], [0.0], [1.0]])
    d /= np.linalg.norm(d, axis=0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    bound = t(rng.uniform(4.0, 12.0, R))
    return tuple(t(c) for c in (*o, *d)), tuple(t(c) for c in cols), bound


@pytest.mark.parametrize("kind", ["closest", "closest_bounded", "any", "bvh",
                                  "bvh_bounded", "bvh_any", "bvh_large"])
def test_triangle_device_code_matches_plain_versions(host_lib, kind):
    """mesh_device.cuh's chunk folds and BVH walk over the card's tables
    (with the kernels' output writer) against kernels/triangles.py and
    kernels/bvh.py; bvh_large has 20,000 triangles, past the 2048 leaves
    of 8 at which rray_tpu's TPU budget would raise the leaf."""
    use_bvh = kind.startswith("bvh")
    T = {"bvh_large": 20000}.get(kind, 1536 if use_bvh else 200)
    rays, cols, bound = _seeded_mesh(T, 3 if use_bvh else 2,
                                     normals=not kind.endswith("any"))
    R = rays[0].shape[0]
    aux = () if kind.endswith("any") else (torch.arange(T, dtype=torch.float32),)
    bound = bound if kind != "closest" and kind != "bvh" else None
    tbl = _np(triangles.pack_table(cols, aux))
    ray_arrs = [_np(r) for r in rays]
    i = ctypes.c_int
    if kind == "any":
        chunk = triangles.chunk_size(T)
        boxes = _np(triangles.chunk_boxes(cols, chunk))
        hit = np.empty(R, np.int32)
        host_lib.any_all(_ptrs(ray_arrs), _c(_np(bound)), _c(tbl),
                         i(tbl.shape[1]), i(T), _c(boxes),
                         i(boxes.shape[1] - 1), i(chunk), _c(hit), i(R))
        plain = triangles.any_triangle(rays[:3], rays[3:], cols, bound)
        # Same arithmetic; only the box cull is extra on the device side.
        assert (hit == plain.numpy()).mean() >= 0.999
        return
    n_float = 3 + (3 if len(cols) == 18 else 0) + len(aux)
    fout = np.empty((n_float, R), np.float32)
    iout = np.empty(R, np.int32)
    if use_bvh:
        tables = bvh.card_tables(cols, aux)
        assert tables.leaf == bvh.LEAF  # no leaf cap, 20,000 triangles too
        host_lib.bvh_all(_ptrs(ray_arrs), _c(_np(bound)),
                         _c(_np(tables.block)), i(tables.Lp * bvh.NODE),
                         i(T), i(tables.Lp), i(tables.leaf),
                         i(kind == "bvh_any"), _c(tbl), i(tbl.shape[1]),
                         i(len(cols) == 18), i(len(aux)), _c(fout), _c(iout),
                         i(R))
        plain = bvh.bvh_closest_triangle(rays[:3], rays[3:], cols, dist=bound,
                                         aux=aux, any_hit=kind == "bvh_any")
    else:
        chunk = triangles.chunk_size(T)
        boxes = _np(triangles.chunk_boxes(cols, chunk))
        host_lib.closest_all(_ptrs(ray_arrs), _c(_np(bound)), _c(tbl),
                             i(tbl.shape[1]), i(T), _c(boxes),
                             i(boxes.shape[1] - 1), i(chunk),
                             i(len(cols) == 18), i(len(aux)), _c(fout),
                             _c(iout), i(R))
        plain = triangles.closest_triangle(rays[:3], rays[3:], cols,
                                           t_init=bound, aux=aux)
    want = np.stack([p.numpy() for k, p in enumerate(plain) if k != 3])
    # The same expressions in the same order with no transcendental:
    # equal bit for bit wherever the device-side box culls keep the
    # winner; a cull flipped by a rounding at a box face may change a
    # ray's result (none measured; 0.1% of rays allowed).
    same = (iout == plain[3].numpy()) & (
        (fout == want) | (np.isinf(fout) & np.isinf(want))).all(0)
    assert np.isfinite(fout[0]).any()
    assert same.mean() >= 0.999, same.mean()


@pytest.mark.parametrize("T,group", [(200, 4), (333, 4), (333, 16),
                                     (333, 56)])
@pytest.mark.parametrize("kind", ["closest", "closest_bounded", "any"])
def test_group_fold_matches_plain_versions(host_lib, kind, T, group):
    """mesh_device.cuh's group_fold, the B2/B3 kernels' warp-uniform
    fold (one lane on the host), over chunk_tables' block, with the
    kernels' output writer, against kernels/triangles.py's plain
    versions. 333 triangles are a multiple of neither the group nor the
    chunk (56 rows: groups of 4 and 56, or 64 rows: groups of 16); with
    groups of 56 the chunk is one group."""
    rays, cols, bound = _seeded_mesh(T, 2, normals=kind != "any")
    R = rays[0].shape[0]
    aux = () if kind == "any" else (torch.arange(T, dtype=torch.float32),)
    bound = None if kind == "closest" else bound
    tables = triangles.chunk_tables(cols, aux, group)
    if T == 333:
        assert T % group and T % tables.chunk
    i = ctypes.c_int
    n_float = 3 + (3 if len(cols) == 18 else 0) + len(aux)
    fout = np.zeros((n_float, R), np.float32)
    iout = np.zeros(R, np.int32)
    hit = np.zeros(R, np.int32)
    tbl = _np(tables.payload)
    host_lib.group_all(_ptrs([_np(r) for r in rays]), _c(_np(bound)),
                       _c(_np(tables.block)), i(T), i(group),
                       i(tables.chunk), i(kind == "any"), _c(tbl),
                       i(tbl.shape[1]), i(len(cols) == 18), i(len(aux)),
                       _c(fout), _c(iout), _c(hit), i(R))
    if kind == "any":
        plain = triangles.any_triangle(rays[:3], rays[3:], cols, bound)
        assert 0 < plain.numpy().mean() < 1
        assert (hit == plain.numpy()).mean() >= 0.999
        return
    plain = triangles.closest_triangle(rays[:3], rays[3:], cols,
                                       t_init=bound, aux=aux)
    want = np.stack([p.numpy() for k, p in enumerate(plain) if k != 3])
    # As the chunk folds above: the plain version's expressions in its
    # order, equal bit for bit wherever the box culls keep the winner.
    same = (iout == plain[3].numpy()) & (
        (fout == want) | (np.isinf(fout) & np.isinf(want))).all(0)
    assert np.isfinite(fout[0]).any() and np.isinf(fout[0]).any()
    assert same.mean() >= 0.999, same.mean()


def _seeded_points(n=2000, seed=5):
    """Float32 shadow origins around the area scenes' floor and sphere,
    with zeros, a negative zero and denormals among them."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4.0, 4.0, (3, n)).astype(np.float32)
    pts[1] = np.abs(pts[1]) * 0.5
    pts[:, :5] = np.array([[0.0, -0.0, 1e-40, -1e-42, 1e-45]] * 3,
                          np.float32)
    return [np.ascontiguousarray(c) for c in pts]


def test_jitter_device_code_matches_plain_version(host_lib):
    """jitter_device.cuh's hash base and draws against ops/jitter.py, bit
    for bit (integer arithmetic; the float conversion is exact)."""
    pts = _seeded_points()
    R, n = pts[0].shape[0], 50
    for seed in (0, -123456789, 2 ** 31 - 1):
        base = np.empty(R, np.uint32)
        draws = np.empty((n, R), np.float32)
        host_lib.jitter_all(_ptrs(pts), ctypes.c_int(seed), ctypes.c_int(n),
                            _c(base), _c(draws), ctypes.c_int(R))
        tpts = [torch.from_numpy(c) for c in pts]
        hb = jitter.point_base(seed, *tpts)
        np.testing.assert_array_equal(base, hb.numpy().astype(np.uint32))
        want = torch.stack([jitter.draw_unit(hb, k) for k in range(n)])
        np.testing.assert_array_equal(draws, want.numpy())


@pytest.mark.parametrize("level", [1, 3, 5, 7])
def test_area_count_device_code_matches_plain_version(host_lib, level):
    """The area-shadow kernel's prim-major body (area_count) against
    area_shadow_fraction_reference on the shadow fixture's analytic
    occluders (all five kinds): the same counts on every origin, bit for
    bit; levels 5 and 7 take 2 and 4 chunks of 16 samples. With the
    occluders' boxes the body skips prims (the cull), without them (all
    marked unbounded) it tests every one: both counts equal."""
    path = _scene_path("area_light.yaml", None)
    _, lights, shapes = load_scene_file(path)
    from rray_tpu_torch.scene.data import Shape
    shapes = shapes + [
        Shape("cube", transform=np.array(
            [[1, 0, 0, 2.5], [0, 1, 0, 1], [0, 0, 1, 1], [0, 0, 0, 1.0]])),
        Shape("cylinder", minimum=0.0, maximum=2.0, closed=True,
              transform=np.array([[1, 0, 0, -2.5], [0, 1, 0, 0],
                                  [0, 0, 1, 0], [0, 0, 0, 1.0]])),
        Shape("cone", minimum=-1.0, maximum=0.0, closed=True,
              transform=np.array([[1, 0, 0, 0], [0, 1, 0, 2],
                                  [0, 0, 1, 3], [0, 0, 0, 1.0]]))]
    scene = compile_scene(shapes, lights, dtype=torch.float32, device="cpu")
    light = scene.lights[0]
    lp = torch.cat([light.corner, light.uvec, light.vvec])
    pids = range(len(scene.prim_kinds))
    params = analytic.occlusion_params(scene, pids)
    pts = _seeded_points()
    R = pts[0].shape[0]
    count = np.empty(R, np.float32)
    kinds = np.asarray(scene.prim_kinds, np.int32)
    bounds = analytic.occluder_bounds(params, scene.prim_kinds)
    assert bounds[:, 6].tolist() == [float(k != sd.PLANE)
                                     for k in scene.prim_kinds]
    frac = analytic.area_shadow_fraction_reference(
        tuple(torch.from_numpy(c) for c in pts), -77, lp, params,
        scene.prim_kinds, level)
    for b in (bounds, torch.zeros_like(bounds)):
        host_lib.area_all(_ptrs(pts), _c(_np(lp)), _c(_np(params)),
                          _c(_np(b)), _c(kinds), ctypes.c_int(len(kinds)),
                          ctypes.c_int(level), ctypes.c_int(-77), _c(count),
                          ctypes.c_int(R))
        np.testing.assert_array_equal(count / (level * level), frac.numpy())
    assert 0.05 < frac.mean() < 0.95


def _torus_rays(R=4096, seed=7):
    """Seeded object-space rays aimed at config 5's torus (minor radius
    0.35), from outside and inside its box."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0.0, 2.0, (3, R))
    aim = rng.uniform(-1.2, 1.2, (3, R)) * np.array([[1.0], [1.0], [0.3]])
    d = aim - o
    d /= np.linalg.norm(d, axis=0)
    return o, d


def _torus_coeffs(o, d, r=0.35):
    """The torus quartic's coefficients (soa._torus_slots' expressions)."""
    ss = (d * d).sum(0)
    e = (o * o).sum(0) - r * r + 1.0
    f = (o * d).sum(0)
    return (ss * ss, 4.0 * ss * f,
            2.0 * ss * e + 4.0 * f * f - 4.0 * (d[0] ** 2 + d[1] ** 2),
            4.0 * e * f - 8.0 * (o[0] * d[0] + o[1] * d[1]),
            e * e - 4.0 * (o[0] ** 2 + o[1] ** 2))


def test_quartic_device_code_matches_plain_version(host_lib):
    """quartic_device.cuh's solve_quartic against ops/quartic.py in f32 on
    torus coefficients: the same valid slots, and roots equal but where
    one ulp of a sqrt (PyTorch's CPU sqrt is not correctly rounded) moves
    an ill-conditioned root (measured 5 of ~1100 valid roots of config 5's
    camera rays, by up to 5e-4)."""
    from rray_tpu_torch.ops import quartic
    cs = [np.ascontiguousarray(c, np.float32) for c in _torus_coeffs(
        *_torus_rays())]
    R = cs[0].shape[0]
    roots = np.empty((4, R), np.float32)
    valids = np.empty((4, R), np.int32)
    host_lib.quartic_all(_ptrs(cs), _c(roots), _c(valids), ctypes.c_int(R))
    tr, tv = quartic.solve_quartic_parts(*(torch.from_numpy(c) for c in cs))
    tr = np.stack([x.numpy() for x in tr])
    tv = np.stack([x.numpy() for x in tv])
    np.testing.assert_array_equal(valids.astype(bool), tv)
    assert tv.sum() > R  # many rays have real roots
    err = np.abs(roots - tr)[tv] / np.maximum(1.0, np.abs(tr[tv]))
    assert (err == 0.0).mean() >= 0.99 and err.max() <= 1e-3, err.max()


def test_noise_device_code_matches_plain_version(host_lib):
    """noise_device.cuh's octave_perlin against ops/noise.py, bit for bit
    (integer hash, floor, IEEE products and sums in the same order), on
    seeded points including negative ones and points past the int32
    range of the lattice (saturating conversion)."""
    from rray_tpu_torch.ops import noise
    rng = np.random.default_rng(3)
    pts = rng.uniform(-400.0, 400.0, (3, 5000)).astype(np.float32)
    pts[:, :8] *= np.float32(1e9)
    pts = [np.ascontiguousarray(c) for c in pts]
    for octaves, persistence in ((1, 0.5), (4, 0.5), (3, 0.7)):
        out = np.empty(pts[0].shape[0], np.float32)
        host_lib.noise_all(_ptrs(pts), ctypes.c_int(octaves),
                           ctypes.c_float(persistence), _c(out),
                           ctypes.c_int(out.shape[0]))
        want = noise.octave_perlin(*(torch.from_numpy(c) for c in pts),
                                   octaves, torch.tensor(persistence,
                                                         dtype=torch.float32))
        np.testing.assert_array_equal(out, want.numpy())


def _host_patterns(lib, scene, rows, pts, tmp_path=None):
    """Every prim row's pattern program (kernels/whitted.py
    pattern_program), evaluated by the host-compiled eval_program at
    pattern-space points `pts`, and the plain version's tree evaluation
    -> [(host [3, R], plain [3, R])] per prim row in `rows`."""
    inputs = whitted.kernel_inputs(scene, RenderSettings())
    args = {k: v for k, v in inputs.items() if k != "tex_tbl"}
    kt = whitted.kernel_tables(**args, R=1)
    roots = whitted.pattern_program(inputs["pat_descrs"],
                                    inputs["prim_pat"])[1]
    tables, desc = _np(kt.tables), np.asarray(kt.desc, np.int32)
    texels = _np(inputs.get("tex_tbl"))
    tex = (inputs["tex_tbl"], inputs["tex_meta"]) if texels is not None \
        else None
    prims, pat = inputs["prim_tbl"].tolist(), inputs["pat_tbl"].tolist()
    P = len(inputs["kinds"])
    arrs = [np.ascontiguousarray(c, np.float32) for c in pts]
    tpts = whitted.V3(*(torch.from_numpy(c) for c in arrs))
    out = []
    for r in rows:
        kind = inputs["kinds"][r] if r < P else -1
        prim = np.asarray(prims[r], np.float32)
        host = [np.empty(arrs[0].shape[0], np.float32) for _ in range(3)]
        lib.pattern_all(_c(tables), _c(desc), _c(texels),
                        ctypes.c_int(roots[r]), _ptrs(arrs), ctypes.c_int(kind),
                        _c(prim), _ptrs(host), ctypes.c_int(arrs[0].shape[0]))
        uv = (lambda q, r=r: whitted._uv_kind(inputs["kinds"][r], prims[r],
                                              q)) if r < P else None
        plain = whitted._eval_pattern(
            inputs["pat_descrs"][inputs["prim_pat"][r]], pat, tpts, uv, tex)
        out.append((np.stack(host), np.stack([c.numpy() for c in
                                              (plain.x, plain.y, plain.z)])))
    return out


def _pattern_points(n=3000, seed=9):
    return np.random.default_rng(seed).uniform(-2.5, 2.5, (3, n))


def _assert_patterns_match(pairs):
    # The same operations in the same order; atan2/acos in double, noise
    # bit for bit. Only an ulp of a sqrt (PyTorch's CPU sqrt is not
    # correctly rounded) can move a ring or uv boundary.
    for host, plain in pairs:
        assert np.isfinite(host).all()
        same = (host == plain).all(0)
        assert same.mean() >= 0.999, (same.mean(), np.abs(host - plain).max())


@pytest.mark.parametrize("name", ["example1.yaml", "glass.yaml",
                                  "area_light.yaml", "csg_showcase.yaml",
                                  "csg5r", "tex5r"])
def test_pattern_programs_match_plain_trees(host_lib, name, tmp_path):
    """Every pattern tree of the example scenes and of config 5's csg5r
    and tex5r variants, flattened into the kernel's program and run by
    the host-compiled device code, equals the plain version's tree."""
    if name == "tex5r":
        path = ms.write_config5(str(tmp_path), name, floor_reflective=0.3,
                                split_csg=True)
    else:
        path = _scene_path(name, tmp_path)
    _, lights, shapes = load_scene_file(path)
    scene = compile_scene(shapes, lights, dtype=torch.float32, device="cpu")
    rows = range(len(whitted.kernel_inputs(scene, RenderSettings())
                     ["prim_pat"]))
    _assert_patterns_match(_host_patterns(host_lib, scene, rows,
                                          _pattern_points()))


def _texture(seed, eight_bit):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (5, 7, 3)) / 255.0
    return img if eight_bit else img * 0.5 + 0.123456


def _synthetic_trees():
    """Pattern trees the example scenes lack: the depth-8 limit with every
    node type on the way down (and 7 pending gradient/blend frames), and
    select nodes over image and noise leaves."""
    from rray_tpu_torch import mathutils as mu
    from rray_tpu_torch.scene.data import Pattern

    def solid(*c):
        return Pattern.solid(list(c))

    def node(kind, a=None, b=None, s=1.0, **kw):
        return Pattern(kind, mu.scale(s, 1.3 * s, 0.8 * s), a=a, b=b, **kw)

    def noise(a, b, s=1.0):
        return node("noise", a, b, s, scale=1.5, octaves=2, persistence=0.6)

    image = Pattern("image", mu.scale(0.7, 0.7, 0.7),
                    texture=_texture(1, True))
    leaf = image
    for kind in ("ring", "stripe", "perturbed", "blend", "checker", "noise",
                 "gradient"):
        if kind == "perturbed":
            leaf = node(kind, leaf, scale=0.3, octaves=2, persistence=0.5)
        elif kind == "noise":
            leaf = noise(leaf, solid(0.2, 0.9, 0.4), 0.9)
        elif kind == "blend":
            leaf = node(kind, leaf, solid(0.1, 0.2, 0.3), 1.1, scale=0.3)
        else:
            leaf = node(kind, leaf, solid(0.9, 0.5, 0.1), 0.7)
    deep_mixed = leaf
    leaf = solid(0.3, 0.6, 0.9)
    for k in range(7):  # seven nested binary nodes: seven frames
        leaf = node("gradient" if k % 2 else "blend", leaf,
                    solid(0.1 * k, 0.5, 0.2), 0.9 + 0.1 * k, scale=0.25)
    deep_binary = leaf
    float_image = Pattern("image", mu.identity(), texture=_texture(2, False))
    selects = [
        node("stripe", image, noise(solid(1, 0, 0), solid(0, 0, 1)), 0.6),
        node("checker", noise(float_image, solid(0, 1, 0)), image, 0.8),
        node("ring", noise(solid(1, 1, 0), image, 1.2), float_image, 0.5),
    ]
    return [deep_mixed, deep_binary] + selects


@pytest.mark.parametrize("kind", ["sphere", "cube", "cylinder", "torus"])
def test_pattern_programs_depth_limit_and_select_leaves(host_lib, kind):
    """The depth-8 limit (every node type, and seven pending frames) and
    stripe, checker and ring nodes over image and noise leaves, on four
    prim kinds' uv mappings: the program equals the plain tree."""
    from rray_tpu_torch.scene.data import Material, PointLight, Shape

    trees = _synthetic_trees()
    shapes = [Shape(kind, material=Material(pattern=t), minimum=-1.0,
                    maximum=1.0, closed=True, minor_radius=0.4)
              for t in trees]
    scene = compile_scene(shapes, [PointLight(np.array([-5.0, 5.0, -5.0]),
                                              np.ones(3))],
                          dtype=torch.float32, device="cpu")
    inputs = whitted.kernel_inputs(scene, RenderSettings())
    depths = [whitted._descr_depth(d) for d in inputs["pat_descrs"]]
    assert max(depths) == whitted.MAX_PATTERN_DEPTH
    assert whitted.pattern_program(inputs["pat_descrs"],
                                   inputs["prim_pat"])[2] == 7
    _assert_patterns_match(_host_patterns(host_lib, scene, range(len(trees)),
                                          _pattern_points(seed=4)))
