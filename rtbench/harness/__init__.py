"""The harness of rtbench: registry, window and trace arithmetic, spans,
and one run of a cell (core.py)."""
from __future__ import annotations

import contextlib


def seed_words(seed: int):
    """A seed of any size and sign as two 32-bit words, for numpy's
    seeding, which takes no negative number."""
    s = seed % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


@contextlib.contextmanager
def reference_mode(torch, device: str):
    """How the plain reference runs: after the program's cached blocks
    are released, TF32 off, no autograd unless asked for inside."""
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
