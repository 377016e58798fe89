"""Progressive band rendering with checkpoint/resume and progress logs
(rray_tpu render/progressive.py).

A frame renders as bands of raster rows: each finished band lands in a
host canvas and (optionally) in a checkpoint that records which bands
are done, so an interrupted render, or a re-run on another host, picks
up where it left off. The checkpoint is rray_tpu's `.npz` (`canvas`
float32 [vsize, hsize, 3], `done` bool [bands], `band_rows`), so either
package resumes the other's. Throughput (rays/s) and ETA are logged per
band.

A band of rows [r0, r0 + n) renders under the root key
fold_in(PRNGKey(seed), r0), as rray_tpu's render_rows keys it: an
area-light frame assembled from bands is rray_tpu's banded frame, not
its one-shot frame (point-light frames draw no jitter and equal both).
Every band goes through the scene's route (integrator.render_block),
and the bands share the scene's cached tables
(`SceneData.cached`: whitted tables, triangle tables, BVH trees).
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..config import RenderSettings
from ..ops import prng
from ..scene import data as sd
from ..utils import profiling
from . import integrator
from .camera import CameraData

log = logging.getLogger("rray_tpu_torch.progressive")


def band_key(seed: int, row_start: int) -> np.ndarray:
    """The root key of the band starting at raster row `row_start`:
    fold_in(PRNGKey(seed), row_start)."""
    return prng.fold_in(prng.prng_key(seed), row_start)


def render_rows(scene: sd.SceneData, cam: CameraData, row_start: int,
                n_rows: int, settings: RenderSettings = RenderSettings(),
                seed: int = 0):
    """Render raster rows [row_start, row_start + n_rows) -> [n_rows,
    hsize, 3] on the scene's device, under the band's root key."""
    return integrator.render_block(scene, cam, row_start,
                                   row_start + n_rows, settings,
                                   band_key(seed, row_start))


class ProgressiveRender:
    """Accumulates a frame band by band with optional checkpointing."""

    def __init__(self, scene, cam, settings: RenderSettings = RenderSettings(),
                 seed: int = 0, band_rows: int = 64,
                 checkpoint_path: str = None):
        if band_rows < 1:
            raise ValueError(f"band_rows={band_rows}")
        self.scene = scene
        self.cam = cam
        self.settings = settings
        self.seed = seed
        self.band_rows = band_rows
        self.checkpoint_path = checkpoint_path
        self.canvas = np.zeros((cam.vsize, cam.hsize, 3), np.float32)
        self.done = np.zeros(self._n_bands(), bool)

    def _n_bands(self) -> int:
        return -(-self.cam.vsize // self.band_rows)

    @classmethod
    def resume(cls, path: str, scene, cam, settings=RenderSettings(),
               seed: int = 0, band_rows: int = 64):
        """Load a checkpoint; bands already rendered are skipped. The
        checkpoint's band_rows wins over the argument, as in rray_tpu."""
        with np.load(path) as state:
            r = cls(scene, cam, settings, seed, int(state["band_rows"]), path)
            canvas, done = state["canvas"], state["done"]
        if canvas.shape != r.canvas.shape or done.shape != r.done.shape:
            raise ValueError(f"checkpoint {path}: canvas {canvas.shape}, "
                             f"done {done.shape} for a {cam.vsize}x"
                             f"{cam.hsize} frame of {r._n_bands()} bands")
        r.canvas = canvas.astype(np.float32)
        r.done = done.astype(bool)
        return r

    def checkpoint(self):
        if self.checkpoint_path:
            # Write-then-rename: a crash mid-write (the very failure this
            # checkpoint exists for) must not leave a truncated npz that
            # poisons the next resume. np.savez appends .npz to names
            # that lack it, so the temporary name keeps the suffix.
            tmp = self.checkpoint_path + ".tmp.npz"
            np.savez(tmp, canvas=self.canvas, done=self.done,
                     band_rows=self.band_rows)
            os.replace(tmp, self.checkpoint_path)

    def run(self, bands=None) -> np.ndarray:
        """Render the given band indices (default: all unfinished)."""
        todo = [b for b in (bands if bands is not None
                            else range(self._n_bands())) if not self.done[b]]
        total_rays = len(todo) * self.band_rows * self.cam.hsize
        done_rays = 0
        t_start = time.perf_counter()
        # Failure-injection hook of the resilient-render tests: abort the
        # process after N bands, as a device loss mid-frame would.
        fail_after = int(os.environ.get("RRAY_FAIL_AFTER_BANDS", "0") or 0)
        for i, b in enumerate(todo):
            if fail_after and i >= fail_after:
                raise RuntimeError(
                    "injected device loss (RRAY_FAIL_AFTER_BANDS)")
            row0 = b * self.band_rows
            rows = min(self.band_rows, self.cam.vsize - row0)
            t0 = time.perf_counter()
            with torch.no_grad():
                band = render_rows(self.scene, self.cam, row0, rows,
                                   self.settings, self.seed)
            with profiling.span("copy"):
                band = band.cpu().numpy()
            dt = time.perf_counter() - t0
            self.canvas[row0:row0 + rows] = band
            self.done[b] = True
            self.checkpoint()
            done_rays += rows * self.cam.hsize
            elapsed = time.perf_counter() - t_start
            rate = done_rays / max(elapsed, 1e-9)
            eta = (total_rays - done_rays) / max(rate, 1e-9)
            log.info("band %d/%d: %.3fs, %.3g rays/s, ETA %.1fs",
                     b + 1, self._n_bands(), dt, rate, eta)
        return self.canvas
