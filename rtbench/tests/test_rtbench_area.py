"""The reference's area lights (reference/area.py) against the port's
frames of examples/area_light.yaml: on the CPU at small sizes through
the port's plain versions, and on the card at config 3's published size
(800x600, aa=3) through the kernels."""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from conftest import ROOT
from rtbench.reference import area
from rtbench.reference import whitted as rw
from rtbench.reference.rconfig import RenderSettings

SCENE = os.path.join(ROOT, "examples", "area_light.yaml")
TOL = 1e-3  # the turntable runner's pix_share tolerance


def scene_text(reflective_floor=None):
    with open(SCENE) as f:
        doc = yaml.safe_load(f)
    if reflective_floor is not None:
        doc["scene"][0]["material"]["reflective"] = reflective_floor
    return yaml.safe_dump(doc)


def port_frame(text, w, h, aa, folder):
    from rray_tpu_torch import api

    path = os.path.join(folder, "scene.yaml")
    with open(path, "w") as f:
        f.write(text)
    return np.asarray(api.render_scene_from_file(path, w, h, None, aa=aa,
                                                 device="cpu"))


def reference_frame(text, w, h, aa):
    spec, scene = rw.load(text, os.path.dirname(SCENE))
    cam = rw.camera(spec, w * aa, h * aa)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    return rw.pixels(scene, cam, xs.reshape(-1), ys.reshape(-1), aa,
                     RenderSettings()).reshape(h, w, 3).numpy()


def gap(text, tmp_path, w=24, h=18, aa=2):
    """The largest channel difference [h, w] of each pixel between the
    reference and the port's frame."""
    return np.abs(reference_frame(text, w, h, aa)
                  - port_frame(text, w, h, aa, str(tmp_path))).max(axis=-1)


@pytest.mark.parametrize("reflective_floor", [None, 0.3])
def test_the_reference_agrees_with_the_port_on_the_cpu(reflective_floor,
                                                       tmp_path,
                                                       monkeypatch):
    """Every pixel within 1e-3; with a reflective floor at depth 5 the
    reflected rays shade from level 1, under that level's seed."""
    levels = set()
    shadow = area.shadow

    def seen(scene, li, light, over, settings, level):
        frac = shadow(scene, li, light, over, settings, level)
        if bool(((frac > 0) & (frac < 1)).any()):
            levels.add(level)
        return frac
    monkeypatch.setattr(area, "shadow", seen)
    d = gap(scene_text(reflective_floor), tmp_path)
    print(json.dumps({"reflective_floor": reflective_floor,
                      "max_gap": float(d.max()),
                      "penumbra_levels": sorted(levels)}))
    assert d.max() < TOL
    assert levels == ({0} if reflective_floor is None else {0, 1})


@pytest.mark.parametrize("key", ["next_level", "seed_1"])
def test_a_wrong_key_fails_on_the_penumbra(key, tmp_path, monkeypatch):
    """Keyed by the next level's seed, or by seed 1 instead of the port's
    0, the reference draws other samples: some penumbra pixels leave the
    bound, so the comparison sees the key chain."""
    if key == "seed_1":
        monkeypatch.setattr(area, "SEED", 1)
    else:
        shadow = area.shadow
        monkeypatch.setattr(area, "shadow", lambda scene, li, light, over,
                            settings, level: shadow(scene, li, light, over,
                                                    settings, level + 1))
    d = gap(scene_text(), tmp_path)
    assert np.count_nonzero(d > TOL) >= 3


def test_the_frozen_key_chain_draws_as_the_port():
    from rray_tpu_torch.ops import jitter as port
    from rtbench.reference import jitter

    assert torch.equal(jitter.seed_table(0, 5, 1), port.seed_table(0, 5, 1))
    g = torch.Generator().manual_seed(3)
    x, y, z = (torch.randn(64, generator=g) * 4 for _ in range(3))
    seed = int(jitter.seed_table(0, 5, 1)[2, 0])
    assert torch.equal(jitter.point_jitter(seed, x, y, z, 16),
                       port.point_jitter(seed, x, y, z, 16))


def card_readings(tmp_path, device):
    """pix_share and png_share of config 3's one-shot frame at 800x600,
    aa=3, seed 0, against the reference at 4096 output pixels drawn from
    numpy's seed 0: the turntable runner's own comparison."""
    import time

    from PIL import Image

    from rray_tpu_torch import api
    from rtbench.harness import reference_mode
    from rtbench.harness.registry import Registry

    w, h, aa = 800, 600, 3
    png = str(tmp_path / "frame.png")
    t0 = time.perf_counter()
    image = api.render_scene_from_file(SCENE, w, h, png, aa=aa,
                                       device=device)
    frame_s = time.perf_counter() - t0
    flat = np.random.default_rng(0).choice(w * h, size=4096, replace=False)
    px, py = flat % w, flat // w
    program = np.asarray(image, np.float64)[py, px]
    decoded = np.asarray(Image.open(png).convert("RGB"))[py, px]
    del image
    t0 = time.perf_counter()
    with reference_mode(torch, device), torch.no_grad():
        with open(SCENE) as f:
            spec, scene = rw.load(f.read(), os.path.dirname(SCENE),
                                  torch.float32, device)
        cam = rw.camera(spec, w * aa, h * aa, torch.float32, device)
        ref = rw.pixels(scene, cam, torch.as_tensor(px, device=device),
                        torch.as_tensor(py, device=device), aa,
                        RenderSettings()).double().cpu().numpy()
    reference_s = time.perf_counter() - t0
    compare = Registry().runner("turntable").compare
    numbers = compare(None, {"pixels": {0: program}, "png": decoded},
                      {"pixels": {0: ref}, "last": ref})
    gaps = np.abs(program - ref).max(axis=1)
    return {**numbers, "max_gap": float(gaps.max()),
            "median_gap": float(np.median(gaps)),
            "pixels_differing": int(np.count_nonzero(gaps)),
            "frame_s": frame_s, "reference_s": reference_s,
            "card": torch.cuda.get_device_name(0)}


@pytest.mark.cuda
def test_config_3_agrees_on_the_card(cuda_device, tmp_path):
    got = card_readings(tmp_path, cuda_device)
    print(json.dumps(got))
    assert got["pix_share"] <= 0.005 and got["png_share"] <= 0.005, got
