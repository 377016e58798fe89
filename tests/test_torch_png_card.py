"""The PNG of a card image (kernels/deflate.py's match tables, then
io/deflate.py's host emitter) against compress2(..., 6)'s PNG, which
io/native.py::encode_png_native writes: the same bytes on every input.

On the CPU the tables come from the plain PyTorch version, which is held
here against a direct walk of each position's hash chain as
deflate.c's longest_match walks it. The tests marked `cuda` hold the
kernels against the plain version and the main path's PNG against
canvas.write_png's on the card (run them with
`python -m pytest --noconftest -q -m cuda tests/test_torch_png_card.py`).
"""
import bisect
import ctypes
import os
import sys

import numpy as np
import pytest
import torch

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BASE not in sys.path:
    sys.path.insert(0, BASE)

from rray_tpu_torch import api  # noqa: E402
from rray_tpu_torch.io import deflate as emitter  # noqa: E402
from rray_tpu_torch.io import native  # noqa: E402
from rray_tpu_torch.kernels import deflate  # noqa: E402
from rray_tpu_torch.render import canvas  # noqa: E402
from rray_tpu_torch.utils import profiling  # noqa: E402

GLASS = os.path.join(BASE, "examples", "glass.yaml")
CSG = os.path.join(BASE, "examples", "csg_showcase.yaml")
SLIDE = 32768 + deflate.MAX_DIST  # a raw stream past this slides once


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain version makes many small ops: on one thread they do not
    wait on the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _raw_of(rgba):
    h = rgba.shape[0]
    return np.concatenate([np.zeros((h, 1), np.uint8),
                           rgba.reshape(h, -1)], axis=1).ravel()


def _want(image):
    """canvas._write_png's bytes: the native quantizer and compress2."""
    rgba = native.quantize_native(np.nan_to_num(np.asarray(image,
                                                           np.float32)))
    return native.encode_png_native(rgba)


def _tables_png(rgba):
    """The emitter's PNG of an RGBA8 array through the plain tables."""
    raw = _raw_of(rgba)
    tables = deflate.match_tables_reference(torch.from_numpy(raw))
    h, w = rgba.shape[:2]
    return emitter.encode(raw, *(t.numpy() for t in tables), w, h)


def _image(kind, seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 56))
    if kind == "noise":
        return rng.uniform(-0.2, 1.3, (h, w, 3)).astype(np.float32)
    if kind == "constant":
        return np.full((h, w, 3), rng.uniform(0, 1, 3), np.float32)
    if kind == "gradient":
        y, x = np.mgrid[0:h, 0:w]
        a = rng.uniform(-0.02, 0.02, 3)
        b = rng.uniform(-0.02, 0.02, 3)
        return (rng.uniform(0, 1, 3) + y[..., None] * a
                + x[..., None] * b).astype(np.float32)
    if kind == "blocks":
        s = int(rng.integers(1, 9))
        colours = rng.uniform(0, 1, (int(rng.integers(2, 5)), 3))
        pick = rng.integers(0, len(colours), (h // s + 1, w // s + 1))
        return colours[pick].repeat(s, 0).repeat(s, 1)[:h, :w].astype(
            np.float32)
    # "special": NaN, +-inf and values past [0, 1] among a few colours
    values = np.array([np.nan, np.inf, -np.inf, -0.0, 0.25, 1.0, 7.0],
                      np.float32)
    return values[rng.integers(0, len(values), (h, w, 3))]


KINDS = ("noise", "constant", "gradient", "blocks", "special")


@pytest.mark.parametrize("seed", range(40))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_tables_give_compress2_bytes(kind, seed):
    image = _image(kind, 1000 * KINDS.index(kind) + seed)
    assert emitter.png_bytes(torch.from_numpy(image)) == _want(image)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 2), (2, 1), (3, 1), (1, 7)])
def test_tiny_images(h, w):
    image = np.random.default_rng(h * 10 + w).uniform(0, 1, (h, w, 3))
    assert emitter.png_bytes(torch.from_numpy(image)) == _want(image)


@pytest.mark.parametrize("kind,h,w", [
    ("gradient", 103, 160),   # one slide: 66,023 bytes
    ("blocks", 160, 160),     # two: 102,560 bytes
    ("noise", 200, 240),      # stored blocks over five: 48,000 pixels
    ("text", 224, 120),       # few colours in rows, long chains: 107,744
])
def test_streams_across_window_slides(kind, h, w):
    rng = np.random.default_rng(h * w)
    if kind == "text":
        glyphs = rng.integers(0, 2, (8, 6, 6))
        line = np.concatenate(list(glyphs[rng.integers(0, 8, w // 6)]), 1)
        rows = [np.roll(line, int(rng.integers(0, 6)), 1)
                for _ in range(h // 6)]
        image = np.repeat(np.concatenate(rows, 0)[..., None], 3, 2) \
            * rng.uniform(0.2, 0.9, 3)
    else:
        image = _image(kind, 7)
        image = np.resize(image, (h, w, 3)) if kind != "noise" else \
            rng.uniform(0, 1, (h, w, 3))
    image = image.astype(np.float32)
    assert deflate.raw_size(h, w) > SLIDE
    assert emitter.png_bytes(torch.from_numpy(image)) == _want(image)


@pytest.mark.parametrize("repeat", [258, 300, 1000])
def test_a_long_match_in_the_last_bytes(repeat):
    """The stream's tail repeats earlier bytes, so the last matches are
    cut by the bytes left and nice_match falls below 128."""
    rng = np.random.default_rng(repeat)
    rgba = rng.integers(0, 256, (30, 50, 4), np.uint8)
    flat = rgba.reshape(-1)
    flat[-repeat:] = flat[1000:1000 + repeat]
    raw = _raw_of(rgba)
    assert _tables_png(rgba) == native.encode_png_native(rgba)
    assert len(raw) > repeat


def test_a_head_at_max_dist_is_nil_after_a_late_slide():
    """Input ending within MIN_LOOKAHEAD bytes of 65,274: zlib slides its
    window before searching there, and a head 32,506 back, the window's
    base, is NIL. Everywhere else the same head is searched."""
    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (1005, 16, 4), np.uint8)  # 65,325 bytes
    raw = _raw_of(rgba)
    p, q = SLIDE, 32768
    # The raw offsets of p's and q's bytes in rgba's flat order.
    flat = rgba.reshape(-1)
    to_flat = lambda i: i - (i // 65 + 1)  # noqa: E731
    # Six bytes: a 3-byte match this far back would fall to TOO_FAR.
    flat[to_flat(q):to_flat(q) + 6] = raw[p:p + 6]
    raw = _raw_of(rgba)
    keep = set(range(p, p + 6)) | set(range(q, q + 6))
    while True:  # leave q the head of p
        h = deflate.hashes(torch.from_numpy(raw)).numpy()
        between = np.nonzero(h[q + 1:p] == h[p])[0] + q + 1
        if not len(between):
            break
        for i in between:
            j = next(j for j in (i, i + 1, i + 2)
                     if j % 65 and j not in keep)
            flat[to_flat(j)] ^= 0x01  # the hash keeps 5 bits of b[i]
        raw = _raw_of(rgba)
    table = deflate.match_tables_reference(torch.from_numpy(raw))[0]
    word = int(table[p])
    assert word & deflate.HEAD_AT_MAX_DIST and word & 511 >= 6
    assert _tables_png(rgba) == native.encode_png_native(rgba)


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("seed", range(10))
def test_rgba_streams(seed, alpha):
    """Any RGBA8 stream, alpha included, through the emitter."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 60)), int(rng.integers(1, 60))
    levels = rng.integers(0, 256, int(rng.integers(1, 6))).astype(np.uint8)
    rgba = levels[rng.integers(0, len(levels), (h, w, 4))]
    if not alpha:
        rgba[..., 3] = 255
    assert _tables_png(rgba) == native.encode_png_native(rgba)


def test_the_exception_paths_are_taken():
    """The listed and short 32-link results both occur on these inputs
    (and the streams above give compress2's bytes through them)."""
    flags = 0
    for seed in range(4):
        for kind in ("gradient", "blocks", "special"):
            raw = deflate.quantize_reference(torch.from_numpy(
                _image(kind, 1000 * KINDS.index(kind) + seed)))
            table = deflate.match_tables_reference(raw)[0]
            flags |= int(np.bitwise_or.reduce(table.numpy()))
    assert flags & deflate.LISTED and flags & deflate.SHORT32


def test_a_cpu_render_of_glass():
    image = api.render_scene_from_file(GLASS, 160, 120, "", device="cpu")
    assert emitter.png_bytes(torch.from_numpy(image)) == _want(image)


def _direct_tables(raw):
    """Each position's word by a direct walk of its hash chain, as
    longest_match walks it: the head and then every earlier position of
    the same hash, newest first; and the walk's work as the match kernel
    does it, 4 bytes at a time over zeros past the stream (candidates,
    candidates compared whole after the scan_end check, words compared)."""
    n = len(raw)
    b = [int(x) for x in raw] + [0] * 262
    work = {"candidates": 0, "compared": 0, "words": 0}
    by_hash = {}
    hs = [((b[p] << 10) ^ (b[p + 1] << 5) ^ b[p + 2]) & 0x7fff
          for p in range(n - 2)]
    for p, h in enumerate(hs):
        by_hash.setdefault(h, []).append(p)
    table, exceptions = [0] * n, []
    for p in range(n - 2):
        chain = by_hash[hs[p]]
        earlier = chain[:bisect.bisect_left(chain, p)][::-1]
        if not earlier or earlier[0] == 0 or \
                p - earlier[0] > deflate.MAX_DIST:
            continue
        cap, nice = min(258, n - p), min(128, n - p)
        best, best_d, state32 = 2, 0, None
        for k, q in enumerate(earlier[:deflate.MAX_CHAIN], 1):
            if q == 0 or (k > 1 and p - q >= deflate.MAX_DIST):
                break
            work["candidates"] += 1
            work["words"] += best >= 3
            end = best - 3
            if best >= 3 and b[q + end:q + end + 4] != b[p + end:p + end + 4]:
                length = 0  # it cannot win: no whole comparison
            else:
                work["compared"] += 1
                length = 0
                while True:
                    work["words"] += 1
                    differ = [b[q + length + i] != b[p + length + i]
                              for i in range(4)]
                    if any(differ):
                        length += differ.index(True)
                        break
                    length += 4
                    if length >= cap:
                        break
                length = min(length, cap)
            if length > best:
                best, best_d = length, p - q
                if length >= nice:
                    break
            if k == 32:
                state32 = (best, best_d)
        best32, best_d32 = state32 or (best, best_d)
        word = (best | best_d << 9) if best >= 3 else 0
        if p - earlier[0] == deflate.MAX_DIST:
            word |= deflate.HEAD_AT_MAX_DIST
        if best32 != best:
            if best32 > deflate.GOOD_MATCH:
                word |= deflate.LISTED
                exceptions.append((p, best32 | best_d32 << 9))
            else:
                word |= deflate.SHORT32
        table[p] = word
    return table, exceptions, work


@pytest.mark.parametrize("kind", KINDS)
def test_plain_tables_equal_a_direct_chain_walk(kind):
    for seed in range(3):
        raw = deflate.quantize_reference(torch.from_numpy(
            _image(kind, 77 + seed)))
        table, rows, directory = deflate.match_tables_reference(raw)
        want_table, want_rows, want_work = _direct_tables(raw.numpy())
        assert deflate.last_work == want_work
        assert table.tolist() == want_table
        assert [tuple(e) for e in rows.tolist()] == want_rows
        assert torch.equal(directory, deflate.directory_of(rows[:, 0],
                                                           raw.numel()))


def test_direct_walk_sees_the_far_window():
    """A stream wider than MAX_DIST: heads past it are no heads, and
    chains stop below it."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, 40000).astype(np.uint8) * 60
    raw = torch.from_numpy(base)
    table, rows, _ = deflate.match_tables_reference(raw)
    want_table, want_rows, want_work = _direct_tables(base)
    assert deflate.last_work == want_work
    assert table.tolist() == want_table
    assert [tuple(e) for e in rows.tolist()] == want_rows


def test_quantize_matches_the_native_cast():
    values = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-9, 0.5,
                       0.999999, 1.0, 1.0000001, 3e38, -3e38],
                      np.float32)
    image = np.stack([values, values[::-1], np.roll(values, 3)], 1)[None]
    raw = deflate.quantize_reference(torch.from_numpy(image)).numpy()
    rgba = native.quantize_native(np.nan_to_num(image))
    np.testing.assert_array_equal(raw, _raw_of(rgba))


def test_float64_images_round_to_float32_first():
    image = np.array([[[0.99999999999, 1 / 255, 0.5]]], np.float64)
    assert emitter.png_bytes(torch.from_numpy(image)) == _want(image)


def test_the_emitter_links_the_zlib_that_compress2_uses():
    """The emitter and io/native.py's compress2 resolve zlib alike."""
    version = native.get_lib().zlibVersion
    version.restype = ctypes.c_char_p
    assert emitter.zlib_version() == version().decode()


def test_a_cpu_frame_keeps_compress2(tmp_path, monkeypatch):
    """Host images (device="cpu") keep canvas.write_png: the card path's
    tables are never made."""
    monkeypatch.setattr(deflate, "match_tables", None)
    out = tmp_path / "a.png"
    image = api.render_scene_from_file(GLASS, 8, 6, str(out), device="cpu")
    assert out.read_bytes() == _want(image)


def test_png_spans_nest_on_the_cpu():
    image = torch.from_numpy(_image("gradient", 3)[:8, :8])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("png"):
            emitter.png_bytes(image)
    names = [e.name for e in prof.events()
             if e.name.startswith(profiling.PREFIX)]
    assert sorted(names) == ["rray.deflate", "rray.png", "rray.png_tables"]


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_tables(image):
    """The kernels' raw stream and table, and their listed rows put in
    position order by the directory."""
    raw, table, rows, directory, count = deflate.match_tables(image)
    rows, directory = rows[:int(count[0])].cpu(), directory.cpu()
    ordered = [rows[a:a + c] for a, c in directory.tolist()]
    for part in ordered:  # in order within each slab
        assert torch.equal(part[:, 0], part[:, 0].sort().values)
    return raw.cpu(), table.cpu(), torch.cat(ordered)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_tables_equal_the_plain_version(cuda, kind):
    for seed in range(8):
        image = torch.from_numpy(_image(kind, 5000 + seed))
        raw, table, rows = _card_tables(image.to(cuda))
        want_raw = deflate.quantize_reference(image)
        want_table, want_rows, _ = deflate.match_tables_reference(want_raw)
        assert torch.equal(raw, want_raw)
        assert torch.equal(table, want_table)
        assert torch.equal(rows, want_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,h,w", [("blocks", 160, 160),
                                      ("gradient", 600, 800),
                                      ("text", 224, 120)])
def test_kernel_tables_across_slides(cuda, kind, h, w):
    rng = np.random.default_rng(h + w)
    if kind == "text":
        image = np.repeat(rng.integers(0, 2, (h // 4, w // 4, 1)), 4, 0)
        image = np.repeat(image, 4, 1).repeat(3, 2) * 0.5
    else:
        image = np.resize(_image(kind, 11), (h, w, 3))
    image = torch.from_numpy(image.astype(np.float32))
    raw, table, rows = _card_tables(image.to(cuda))
    want_table, want_rows, _ = deflate.match_tables_reference(
        deflate.quantize_reference(image))
    assert torch.equal(table, want_table) and torch.equal(rows, want_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("path,w,h,aa", [(CSG, 1920, 1080, 5),
                                         (GLASS, 800, 600, 1)])
def test_full_size_png_equals_write_png(cuda, path, w, h, aa, tmp_path):
    before = deflate.launches
    image = api.render_scene_from_file(path, w, h, str(tmp_path / "a.png"),
                                       aa=aa, device="cuda")
    assert deflate.launches == before + 1
    canvas.write_png(str(tmp_path / "b.png"), image)
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()


@pytest.mark.cuda
def test_host_canvases_launch_no_match_search(cuda, tmp_path):
    before = deflate.launches
    api.render_scene_progressive(GLASS, 64, 48, str(tmp_path / "a.png"),
                                 band_rows=16, device="cuda")
    api.render_scene_from_file(GLASS, 64, 48, str(tmp_path / "b.png"),
                               device="cpu")
    api.render_scene_from_file(GLASS, 64, 48, "", device="cuda")
    assert deflate.launches == before
