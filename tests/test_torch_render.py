"""The port's main path end to end: rray_tpu_torch's
render_scene_from_file against rray_tpu's on the CPU in float64 (both
packages' CPU paths: the plain whitted version and rray_tpu's XLA
node), and the CLI surface."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rray_tpu.api as jax_api
from rray_tpu_torch import api
from rray_tpu_torch.render import canvas

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,w,h,aa", [("glass.yaml", 48, 36, 2),
                                         ("example1.yaml", 64, 48, 1)])
def test_render_scene_from_file_matches_rray_tpu_f64(name, w, h, aa,
                                                     tmp_path):
    path = os.path.join(BASE, "examples", name)
    want = jax_api.render_scene_from_file(path, w, h, str(tmp_path / "a.png"),
                                          aa=aa, dtype=jnp.float64)
    got = api.render_scene_from_file(path, w, h, str(tmp_path / "b.png"),
                                     aa=aa, dtype=torch.float64,
                                     device="cpu")
    assert got.shape == (h, w, 3)
    # Same formulas on the same f64 tables; only per-pixel path sums are
    # reassociated, so the linear images agree to rounding and the 8-bit
    # images are identical.
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(canvas.to_u8(got), canvas.to_u8(want))
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=BASE)
    return subprocess.run([sys.executable, "-m", "rray_tpu_torch.cli", *args],
                          cwd=BASE, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_writes_png(tmp_path):
    out = tmp_path / "tmp.png"
    proc = _cli("-W", "32", "-H", "24", "-s", "examples/example1.yaml",
                "-o", str(out), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert np.asarray(Image.open(out)).shape == (24, 32, 4)


def test_cli_rejects_aa_6(tmp_path):
    proc = _cli("-W", "32", "-H", "24", "-s", "examples/example1.yaml",
                "-o", str(tmp_path / "x.png"), "-a", "6", "--device", "cpu")
    assert proc.returncode == 2
    assert "anti-aliasing must be between 1 and 5" in proc.stderr
    assert not (tmp_path / "x.png").exists()
