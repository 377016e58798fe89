"""Profiling hooks of the port (rray_tpu_torch.utils.profiling) on the
CPU: `trace` writes a Chrome trace of the render inside it, and
`live_arrays_bytes` counts CUDA memory or raises, never reporting 0 for
a device that keeps no count. (On the card, tests/test_torch_cuda.py
checks that the trace names the whitted kernel.)"""
import glob
import json
import os

import pytest
import torch

from rray_tpu_torch import api
from rray_tpu_torch.utils import profiling

GLASS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "glass.yaml")


def test_trace_writes_a_chrome_trace_of_a_render(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        api.render_scene_from_file(GLASS, 8, 6, "", device="cpu")
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert any(a.key.startswith("aten::") for a in prof.key_averages())


def test_live_arrays_bytes_refuses_devices_without_a_count():
    with pytest.raises(ValueError, match="allocator"):
        profiling.live_arrays_bytes("cpu")
    if torch.cuda.is_available():
        assert profiling.live_arrays_bytes() == torch.cuda.memory_allocated()
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            profiling.live_arrays_bytes()
