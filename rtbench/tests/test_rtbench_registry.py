"""Every piece BENCHMARK.json names is found by its name, and a new
configuration, mix, metric and cell are taken by adding files alone."""
import json
import os
import shutil

from conftest import SMALL
from rtbench.harness import core
from rtbench.harness.registry import BENCH_DIR, ROOT, Registry


def test_every_named_piece_is_found(registry):
    reg = registry
    bench = reg.benchmark()
    for cfg in bench["configs"]:
        assert reg.config(cfg["name"])["name"] == cfg["name"]
        assert os.path.isfile(os.path.join(ROOT, cfg["file"]))
    for cell in bench["workloads"]:
        mix = reg.mix(cell["traffic"])
        assert hasattr(reg.runner(mix["runner"]), "step")
        assert reg.config(cell["config"])
        limits = reg.limits(cell["name"])
        assert limits and all(v > 0 for v in limits.values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reg.metric(m["name"]).read)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(
        registry):
    reg = registry
    for cell in reg.benchmark()["workloads"]:
        e2e = {m["name"] for m in reg.metrics_for(cell["name"], False)}
        layers = reg.metrics_for(cell["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        for m in layers:  # each moves an end-to-end metric of the cell
            assert m["moves"] in e2e


def test_a_new_config_mix_metric_and_cell_need_no_edit(tmp_path):
    """In a copy of rtbench/, a cell comes by new files alone: a
    configuration, a mix, limits, the cell's small size, an end-to-end
    metric, a reader of the program's rray.png ranges and one of its
    counters. Then every cell of the copy runs as
    test_a_run_loads_no_jax_module runs them: untraced and traced,
    correct, the control not correct."""
    from conftest import run_every_cell

    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "rray_tpu_torch").symlink_to(os.path.join(ROOT, "rray_tpu_torch"))
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    new = root / "rtbench"
    glass = json.loads((new / "configs" / "glass.json").read_text())
    glass["name"] = "glass_far"
    glass["scene"]["camera"]["from"] = [0, 1.5, -7.0]
    (new / "configs" / "glass_far.json").write_text(json.dumps(glass))
    mix = json.loads((new / "traffic" / "turntable.json").read_text())
    mix["range_deg"] = 10.0
    (new / "traffic" / "turntable_narrow.json").write_text(json.dumps(mix))
    cell = "glass_far.turntable_narrow"
    (new / "tests" / "small" / f"{cell}.json").write_text(
        (new / "tests" / "small" / "glass.turntable.json").read_text())
    (new / "limits" / f"{cell}.json").write_text(
        json.dumps({"pix_share": 0.005, "png_share": 0.005}))
    (new / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return len(run.ends)\n")
    (new / "metrics" / "png_probe.py").write_text(
        "from rtbench.harness import readers\n\n\n"
        "def read(run):\n"
        "    return readers.program_ms(run, 'frame', 'png')\n")
    (new / "metrics" / "launch_probe.py").write_text(
        "from rtbench.harness import readers\n\n"
        "COUNTERS = ('rray_tpu_torch.kernels.whitted:table_builds',)\n\n\n"
        "def read(run):\n"
        "    return readers.count_per_item(run, 'frame', COUNTERS[0])\n")
    bench["workloads"].append({"name": cell, "config": "glass_far",
                               "traffic": "turntable_narrow", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": [cell]})
    for name, unit, source in (("png_probe", "ms", "program_span"),
                               ("launch_probe", "tables/frame",
                                "program_counter")):
        bench["per_layer"].append({"name": name, "unit": unit,
                                   "better": "lower", "source": source,
                                   "layer": "test", "moves": "frames_done",
                                   "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = run_every_cell(str(root))
    untraced, traced = out["runs"][cell]
    assert untraced["correct"] and traced["correct"]
    assert untraced["metrics"]["frames_done"]["value"] == untraced[
        "attempted"]
    # frame_ms lists its cells; setup_s, without the key, is in every cell.
    assert set(untraced["metrics"]) == {"setup_s", "frames_done"}
    assert set(traced["metrics"]) == {"png_probe", "launch_probe"}
    assert traced["metrics"]["png_probe"]["value"] > 0
    assert traced["metrics"]["launch_probe"]["value"] == 1.0
    assert set(out["runs"]) == {w["name"] for w in bench["workloads"]}
    assert not set(out["modules"]) & set(core.FORBIDDEN)


def test_every_cell_has_its_small_size_and_every_size_a_cell(registry):
    cells = {w["name"] for w in registry.benchmark()["workloads"]}
    assert cells == set(SMALL)
    for sizes in SMALL.values():
        assert set(sizes) <= {"config", "mix"}


def test_benchmark_json_keeps_the_contracts_form():
    import re

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["rtbench"]
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("rtbench/")
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        used.add(w["config"])
    assert used == configs
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_a_held_out_cell_is_not_run(registry):
    import pytest

    held = registry.names("held_out", ".json")
    assert held
    bench = Registry().benchmark()
    for name in held:
        with pytest.raises(KeyError):
            Registry().cell(name)
        assert registry.cell(name)["name"] == name
        for m in bench["end_to_end"] + bench["per_layer"]:
            assert name not in m.get("workloads", [])
