# Frozen copy of rray_tpu_torch/ops/vec.py at commit 6dfcb62 (imports made local).
"""Structure-of-arrays 3-vectors over torch tensors.

Every hot-path vector is a V3 of three [R]-shaped component tensors, so
all math stays elementwise over the ray axis and each component op is
one IEEE operation in a fixed order. The CUDA kernel writes the same
expressions per thread; keeping the order lets the two agree bit for bit
where no transcendental function is involved.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class V3:
    x: Any
    y: Any
    z: Any

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __mul__(self, s):
        """Scalar (or [R]-tensor) scale."""
        return V3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def dot(self, o: "V3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def norm(self):
        return torch.sqrt(self.dot(self))

    def normalize(self) -> "V3":
        d = self.dot(self)
        # Same floor as rray_tpu's V3.normalize: 1e-30 in f64, 1e-18 in
        # f32 (keeps the f32 rsqrt partial finite for zero vectors).
        floor = 1e-30 if d.dtype == torch.float64 else 1e-18
        return self * torch.rsqrt(torch.clamp_min(d, floor))

    def reflect(self, n: "V3") -> "V3":
        """v - 2 (v.n) n (tuple.rs:114-117)."""
        return self - n * (2.0 * self.dot(n))


def div(a, k):
    """a / k for a number (or CPU 0-d tensor) k, rounded once on every
    device, as the kernel's `a / k` is: on CUDA tensors PyTorch turns a
    division by a CPU scalar into a product with its reciprocal, which
    rounds twice (exact only for powers of two)."""
    return a / torch.as_tensor(k, dtype=a.dtype).to(a.device)


def affine_point(m, p: V3) -> V3:
    """Apply a [3,4] affine (tensor, rows indexed statically) to points."""
    return V3(m[0, 0] * p.x + m[0, 1] * p.y + m[0, 2] * p.z + m[0, 3],
              m[1, 0] * p.x + m[1, 1] * p.y + m[1, 2] * p.z + m[1, 3],
              m[2, 0] * p.x + m[2, 1] * p.y + m[2, 2] * p.z + m[2, 3])


def affine_vector(m, v: V3) -> V3:
    return V3(m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z,
              m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z,
              m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z)
