"""The port's spans (rray_tpu_torch.utils.profiling.span): with no
profiler recording they cost one flag check and never enter
record_function; under a profiler they are "rray.*" host ranges that
nest by layer, never synchronize the card, sit inside any range that a
caller opens around the layer's function, and land in the Chrome trace
of `profiling.trace`.
The test marked `cuda` needs a card (run it with
`python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py`)."""
import glob
import json
import logging
import os
import sys

import pytest
import torch

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BASE not in sys.path:
    sys.path.insert(0, BASE)

from rray_tpu_torch import api  # noqa: E402
from rray_tpu_torch.kernels import whitted  # noqa: E402
from rray_tpu_torch.utils import profiling  # noqa: E402

FRAME = "rray.frame"
GLASS = os.path.join(BASE, "examples", "glass.yaml")
LAYERS = ("rray.load", "rray.compile", "rray.render", "rray.tables",
          "rray.copy", "rray.png")


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof):
    """(host ranges, device rows) of a finished profile, each
    (start_ns, end_ns, name); the host's are its named ranges."""
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for ev in prof.profiler.kineto_results.events():
        row = (ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
        if ev.is_user_annotation():
            if ev.device_type() != cuda:
                host.append(row)
        elif ev.device_type() == cuda:
            device.append(row)
    return host, device


def _refuse(*args, **kwargs):
    raise AssertionError("called")


def _inside(outer, inner):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_with_no_profiler_a_span_is_a_shared_no_op(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    assert profiling.span("frame") is profiling.span("png")
    with profiling.span("frame"):
        pass
    image = api.render_scene_from_file(GLASS, 8, 6, str(tmp_path / "a.png"),
                                       aa=2, device="cpu")
    assert image.shape == (6, 8, 3)


def test_spans_nest_under_a_profiler_and_never_synchronize(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
    host, _ = _ranges(prof)
    got = {n: (s, e) for s, e, n in host}
    assert set(got) == {"rray.outer", "rray.inner"}
    assert _inside(got["rray.outer"], got["rray.inner"])


@pytest.mark.parametrize("aa", [1, 2])
def test_a_cpu_frame_holds_each_layer_in_its_frame(aa, tmp_path):
    with _cpu_profile() as prof:
        api.render_scene_from_file(GLASS, 8, 6, str(tmp_path / "a.png"),
                                   aa=aa, device="cpu")
    host, _ = _ranges(prof)
    frames = [r for r in host if r[2] == FRAME]
    assert len(frames) == 1
    names = [n for _, _, n in host if n != FRAME]
    # aa = 1 opens no downsample span.
    want = LAYERS + (("rray.downsample",) if aa > 1 else ())
    assert sorted(names) == sorted(want)
    assert all(_inside(frames[0], r) for r in host)
    spans = {n: (s, e) for s, e, n in host}
    assert _inside(spans["rray.render"], spans["rray.tables"])


def test_the_string_entry_and_the_bands_mark_their_frames(tmp_path):
    with open(GLASS) as f:
        text = f.read()
    with _cpu_profile() as prof:
        api.render_scene_from_str(text, 8, 6, "", device="cpu")
        api.render_scene_progressive(GLASS, 8, 6, str(tmp_path / "b.png"),
                                     band_rows=2, device="cpu")
    host, _ = _ranges(prof)
    frames = sorted((s, e) for s, e, n in host if n == FRAME)
    assert len(frames) == 2
    count = lambda i, name: sum(
        1 for s, e, n in host if n == name and _inside(frames[i], (s, e)))
    assert [count(0, "rray.load"), count(0, "rray.png")] == [1, 0]
    # Three bands of two rows: a render and a copy each, one table build.
    assert [count(1, n) for n in ("rray.render", "rray.copy",
                                  "rray.tables", "rray.png")] == [3, 3, 1, 1]


def test_a_table_build_keeps_its_counter(tmp_path):
    before = whitted.table_builds
    with _cpu_profile() as prof:
        api.render_scene_from_file(GLASS, 8, 6, "", device="cpu")
    assert whitted.table_builds == before + 1
    host, _ = _ranges(prof)
    assert [n for _, _, n in host].count("rray.tables") == 1


def test_trace_writes_the_spans_into_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        api.render_scene_from_file(GLASS, 8, 6, "", device="cpu")
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {FRAME, "rray.load", "rray.compile", "rray.render",
            "rray.tables", "rray.copy"} <= names


def test_the_verbose_line_says_what_it_times(caplog):
    with caplog.at_level(logging.INFO, logger="rray_tpu_torch"):
        api.render_scene_from_file(GLASS, 8, 6, "", aa=2, device="cpu")
    line = caplog.records[-1].getMessage()
    assert "render and copy to the host" in line
    assert "8x6 (aa=2, 192 raster rays)" in line
    assert "rays/s" not in line


@pytest.mark.parametrize("attr,inner", [
    ("load_scene_file", "rray.load"),
    ("compile_scene", "rray.compile"),
    ("render", "rray.render"),
])
def test_a_range_around_a_layer_holds_its_span(attr, inner, monkeypatch):
    """A caller that wraps one of api's names in a range of its own (as
    an outside timer does) holds the program's span of that layer: the
    span opens inside the callee, and nothing synchronizes."""
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    fn = getattr(api, attr)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function("outer." + attr):
            return fn(*args, **kwargs)

    monkeypatch.setattr(api, attr, wrapped)
    with _cpu_profile() as prof:
        api.render_scene_from_file(GLASS, 8, 6, "", device="cpu")
    host, _ = _ranges(prof)
    got = {n: (s, e) for s, e, n in host}
    assert _inside(got["outer." + attr], got[inner])
    assert _inside(got[FRAME], got["outer." + attr])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_a_traced_card_frame_holds_the_copy_and_the_tables(cuda, tmp_path):
    api.render_scene_from_file(GLASS, 160, 120, "", aa=2, device=cuda)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        api.render_scene_from_file(GLASS, 160, 120,
                                   str(tmp_path / "a.png"), aa=2,
                                   device=cuda)
    host, device = _ranges(prof)
    frames = [(s, e) for s, e, n in host if n == FRAME]
    assert len(frames) == 1
    names = [n for s, e, n in host if _inside(frames[0], (s, e))]
    assert names.count("rray.tables") == 1
    assert {"rray.copy", "rray.downsample", "rray.png"} <= set(names)
    assert any(_inside(frames[0], (s, e)) for s, e, _ in device)


@pytest.mark.cuda
@pytest.mark.parametrize("aa", [1, 2])
def test_a_traced_card_frame_downsamples_before_the_copy(cuda, aa,
                                                         tmp_path):
    """At aa = 2 the frame's rray.downsample span (the kernel's enqueue)
    closes before its rray.copy opens, and the card runs
    downsample_kernel inside the frame; aa = 1 has neither."""
    api.render_scene_from_file(GLASS, 160, 120, "", aa=aa, device=cuda)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        api.render_scene_from_file(GLASS, 160, 120, "", aa=aa, device=cuda)
    host, device = _ranges(prof)
    spans = {n: (s, e) for s, e, n in host}
    kernels = [n for s, e, n in device
               if "downsample_kernel" in n and _inside(spans[FRAME], (s, e))]
    if aa == 1:
        assert "rray.downsample" not in spans and not kernels
        return
    assert spans["rray.downsample"][1] <= spans["rray.copy"][0]
    assert len(kernels) == 1


@pytest.mark.cuda
def test_a_traced_card_frame_splits_its_png(cuda, tmp_path):
    """On the card the frame's rray.png holds rray.png_tables (the match
    search, the copy of its tables and the wait) and, after it,
    rray.deflate (the host's parse and blocks); the card runs
    deflate_match_kernel once inside the frame."""
    api.render_scene_from_file(GLASS, 160, 120, str(tmp_path / "w.png"),
                               device=cuda)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        api.render_scene_from_file(GLASS, 160, 120,
                                   str(tmp_path / "a.png"), device=cuda)
    host, device = _ranges(prof)
    spans = {n: (s, e) for s, e, n in host}
    assert _inside(spans[FRAME], spans["rray.png"])
    assert _inside(spans["rray.png"], spans["rray.png_tables"])
    assert _inside(spans["rray.png"], spans["rray.deflate"])
    assert spans["rray.png_tables"][1] <= spans["rray.deflate"][0]
    kernels = [n for s, e, n in device if "deflate_match_kernel" in n
               and _inside(spans[FRAME], (s, e))]
    assert len(kernels) == 1
