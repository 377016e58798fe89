"""What decides `correct`: a sound run passes; the control (the
reference in bfloat16 in the program's place) fails; and a run with the
timed path broken underneath fails, for each fault a cell can have.
All on the CPU at tiny sizes, through the whole run but the look for a
chip."""
import json

import pytest
import torch

from conftest import SMALL, cells, control_readings
from rtbench.harness import core

# Every cell of BENCHMARK.json and held_out/, and those of them whose mix
# the turntable runner runs: a new cell gets these tests without an edit.
CELLS = cells()
TURNTABLES = cells("turntable")


def run(cell, registry, seed=2 ** 31 + 3, seconds=0.3):
    return core.run_cell(cell, seed, seconds, False, device="cpu",
                         registry=registry, overrides=SMALL[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_its_last_line_has_the_keys(
        cell, registry):
    result, checks = run(cell, registry)
    assert result["correct"] is True, result["checks"]
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "set_up", "checks"]
    assert result["set_up"]["reference_s"] >= 0
    if cell == "glass.adam":  # the target's render is left out of setup_s
        assert result["set_up"]["reference_s"] > 0
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    assert set(result["checks"]) == set(registry.limits(cell))
    json.loads(json.dumps(result))


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell, registry):
    sound, low, limits = control_readings(registry, cell)
    assert all(v <= limits[k] for k, v in sound.items()), sound
    assert any(not v <= limits[k] for k, v in low.items()), low


def altered(orig):
    def render(*args, **kwargs):
        return orig(*args, **kwargs) + 0.05
    return render


def half_left_out(orig):
    def render(*args, **kwargs):
        image = orig(*args, **kwargs)
        return torch.cat([image[: image.shape[0] // 2],
                          torch.zeros_like(image[image.shape[0] // 2:])])
    return render


@pytest.mark.parametrize("cell", TURNTABLES)
@pytest.mark.parametrize("fault", [altered, half_left_out])
def test_a_broken_frame_is_not_correct(cell, fault, monkeypatch,
                                      registry):
    from rray_tpu_torch import api

    monkeypatch.setattr(api, "render", fault(api.render))
    result, _ = run(cell, registry)
    assert result["correct"] is False


# Faults confined to one feature of config 5 (stage e): the torus's image
# texture, the noise on the CSG cube, the cone's gradient.
FEATURES = {
    "torus_uv": "/scene/2/material/pattern/transforms/0/amount=[0.77,0.77,0.77]",
    "noise_octaves": "/scene/1/left/material/pattern/octaves=3",
    "cone_colour": "/scene/3/children/1/material/pattern/color_b=[0.2,0.2,0.8]",
}


def calibrate_module():
    import importlib.util
    import os

    from conftest import ROOT

    spec = importlib.util.spec_from_file_location(
        "rtbench_calibrate", os.path.join(ROOT, "rtbench", "calibrate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_a_fault_in_one_feature_is_not_correct(feature, registry):
    cal = calibrate_module()
    _, keys, value = cal.alteration(f"{feature}:{FEATURES[feature]}")
    cell = "csg_showcase.turntable_aa5"
    small = {"config": {"width": 64, "height": 36},
             "mix": {"aa": 1, "check_pixels": 512}}
    with cal.altered_loader(keys, value):
        result, checks = core.run_cell(cell, 7, 0.3, False, device="cpu",
                                       registry=registry, overrides=small)
    assert result["correct"] is False, checks
    sound, _ = core.run_cell(cell, 7, 0.3, False, device="cpu",
                             registry=registry, overrides=small)
    assert sound["correct"] is True, sound["checks"]


def unchanged_state(orig_make):
    def make(*args, **kwargs):
        step = orig_make(*args, **kwargs)

        def broken(state, target, seed=0):
            _, loss = step(state._replace(params={
                k: t.detach().clone().requires_grad_()
                for k, t in state.params.items()}), target, seed)
            return state, loss
        return broken
    return make


def half_the_rows(orig_loss):
    def loss(params, rest, cam, target, settings, seed=0, mesh=None):
        from rray_tpu_torch.parallel import train

        image = train.render(train.merge_scene(params, rest), cam, settings,
                             seed)
        h = image.shape[0] // 2
        return torch.mean((image[:h] - target[:h]) ** 2)
    return loss


@pytest.mark.parametrize("fault,attr", [(unchanged_state, "make_train_step"),
                                        (half_the_rows, "render_loss")])
def test_a_broken_step_is_not_correct(fault, attr, monkeypatch,
                                     registry):
    from rray_tpu_torch.parallel import train

    monkeypatch.setattr(train, attr, fault(getattr(train, attr)))
    result, checks = run("glass.adam", registry)
    assert result["correct"] is False, checks


def test_a_failed_item_is_not_correct(monkeypatch, registry):
    from rray_tpu_torch import api

    orig = api.render_scene_from_file
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("planted")
        return orig(*args, **kwargs)
    monkeypatch.setattr(api, "render_scene_from_file", flaky)
    result, _ = run("glass.turntable", registry)
    assert result["failed"] == 1 and result["correct"] is False


def test_the_entry_refuses_to_run_without_the_cards(capsys):
    import importlib.util
    import os

    from conftest import ROOT

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = importlib.util.spec_from_file_location(
        "rtbench_run", os.path.join(ROOT, "rtbench", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main(["--workload", "glass.turntable", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_on_the_card_is_correct(cell, cuda_device,
                                            registry):
    result, checks = core.run_cell(cell, 2 ** 31 + 9, 0.5, False,
                                   device=cuda_device, registry=registry,
                                   overrides=SMALL[cell])
    assert result["correct"] is True, checks
