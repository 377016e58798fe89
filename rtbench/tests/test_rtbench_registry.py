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
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    new = root / "rtbench"
    glass = json.loads((new / "configs" / "glass.json").read_text())
    glass["name"] = "glass_far"
    glass["scene"]["camera"]["from"] = [0, 1.5, -7.0]
    (new / "configs" / "glass_far.json").write_text(json.dumps(glass))
    mix = json.loads((new / "traffic" / "turntable.json").read_text())
    mix["range_deg"] = 10.0
    (new / "traffic" / "turntable_narrow.json").write_text(json.dumps(mix))
    (new / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return len(run.ends)\n")
    (new / "limits" / "glass_far.turntable_narrow.json").write_text(
        json.dumps({"pix_share": 0.005, "png_share": 0.005}))
    bench["workloads"].append({"name": "glass_far.turntable_narrow",
                               "config": "glass_far",
                               "traffic": "turntable_narrow", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["glass_far.turntable_narrow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = Registry(root=str(root), bench_dir=str(new))
    assert "glass_far" in reg.names("configs", ".json")
    assert "turntable_narrow" in reg.names("traffic", ".json")
    assert "frames_done" in reg.names("metrics", ".py")
    result, _ = core.run_cell("glass_far.turntable_narrow", 11, 0.3, False,
                              device="cpu", registry=reg,
                              overrides=SMALL["glass.turntable"])
    assert result["correct"] is True
    assert result["metrics"]["frames_done"]["value"] == result["attempted"]
    # frame_ms lists its cells; setup_s, without the key, is in every cell.
    assert set(result["metrics"]) == {"setup_s", "frames_done"}


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
