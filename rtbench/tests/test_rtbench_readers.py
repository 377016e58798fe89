"""The readers of the program's own ranges (rray.*) and counters: on a
traced glass.turntable run at its small size, and on hand-made traces."""
import types

import pytest

from conftest import SMALL
from rtbench.harness import core, readers
from rtbench.harness.trace import Trace


def test_the_programs_ranges_and_counter_reach_the_readers(monkeypatch,
                                                           registry):
    """png_ms.cli and load_ms.cli read the frames' rray.png and rray.load
    ranges; tables_per_frame.cli is what whitted.table_builds counted
    from the window's first frame to its last, over the frames."""
    from rray_tpu_torch.kernels import whitted

    runner = registry.runner("turntable")
    step, counted = runner.step, []

    def counting(st, i):
        if i == 0:
            counted.append(whitted.table_builds)
        step(st, i)
        counted.append(whitted.table_builds)
    monkeypatch.setattr(runner, "step", counting)
    cell = "glass.turntable"
    result, _ = core.run_cell(cell, 2 ** 31 + 11, 0.3, True, device="cpu",
                              registry=registry, overrides=SMALL[cell])
    assert result["correct"] is True, result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["png_ms.cli"] > 0 and m["load_ms.cli"] > 0
    frames = result["attempted"]
    assert frames == len(counted) - 1 >= 1
    assert m["tables_per_frame.cli"] == (counted[-1] - counted[0]) / frames
    # The program's ranges lie inside its frames, and those inside rtbench's.
    assert m["load_ms.cli"] < m["scene_ms.cli"]
    assert m["png_ms.cli"] < m["output_ms.cli"]
    # An untraced run reads the counter too.
    runs = []
    close = runner.close
    monkeypatch.setattr(runner, "close",
                        lambda st: (runs.append(st.run), close(st)))
    result, _ = core.run_cell(cell, 2 ** 31 + 12, 0.2, False, device="cpu",
                              registry=registry, overrides=SMALL[cell])
    assert runs[0].counts == {
        "rray_tpu_torch.kernels.whitted:table_builds": result["attempted"]}


def run_with(program, unit="frame", frames=2, lo=0.0, hi=10.0):
    tl = Trace(device=[], notes=[], lo=lo, hi=hi, program=program)
    return types.SimpleNamespace(unit=unit, ends=[1.0] * frames,
                                 timeline=tl, counts={})


def test_program_ms_counts_the_ranges_that_start_in_the_window():
    program = [(-1.0, 0.5, "frame"), (-0.8, 0.1, "png"),   # before the window
               (1.0, 4.0, "frame"), (3.0, 3.5, "png"),
               (5.0, 9.0, "frame"), (8.0, 8.25, "png"), (8.5, 8.75, "png"),
               (9.5, 11.0, "png")]                          # starts inside
    run = run_with(program)
    assert readers.program_ms(run, "frame", "png") == pytest.approx(
        1e3 * (0.5 + 0.25 + 0.25 + 1.5) / 2)
    assert readers.program_ms(run, "frame", "png", "frame") == pytest.approx(
        1e3 * (0.5 + 0.25 + 0.25 + 1.5 + 3.0 + 4.0) / 2)
    assert readers.program_ms(run, "frame", "tables") == 0.0
    assert readers.program_ms(run, "step", "png") is None


def test_program_ms_is_none_without_a_frame_range_or_a_trace():
    assert readers.program_ms(run_with([(1.0, 2.0, "png")]), "frame",
                              "png") is None
    assert readers.program_ms(run_with([(-2.0, -1.0, "frame")]), "frame",
                              "png") is None
    untraced = types.SimpleNamespace(unit="frame", ends=[1.0], timeline=None)
    assert readers.program_ms(untraced, "frame", "png") is None


def test_count_per_item_reads_only_counters_that_were_read():
    run = run_with([], frames=4)
    run.counts = {"m:n": 6}
    assert readers.count_per_item(run, "frame", "m:n") == 1.5
    assert readers.count_per_item(run, "frame", "m:other") is None
    assert readers.count_per_item(run, "step", "m:n") is None
