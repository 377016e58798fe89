# Frozen copy of rray_tpu_torch/ops/quartic.py at commit 6dfcb62 (imports made local).
"""Branch-free quartic root solver for the torus (a copy of rray_tpu
ops/quartic.py, the port's own).

Replaces the reference's `roots::find_roots_quartic` (torus.rs:59) with a
Ferrari / resolvent-cubic solve in masked elementwise math, polished by
Newton steps on the original quartic. This is the form rray_tpu's XLA
path runs (acos, cos, cbrt, sqrt), not the Mosaic-safe substitutes of its
Pallas kernel, and the kernel's copy (kernels/csrc/quartic_device.cuh)
writes the same expressions in the same order. Returns all real roots
with a validity mask; the caller applies the torus's t > 0 filter
(torus.rs:62-90).

In float32 the transcendentals (acos, cos, cbrt) are evaluated in
float64 and rounded: the f32 quartic is ill-conditioned (any two f32
implementations disagree by up to 1e-3 in a root), so the kernel and
this plain version must call the same function to agree at all, and a
rounded double is the same value from CUDA's libm, the host's and
PyTorch's (`f64_round`). For the same reason every division by a
constant that is no power of two goes through `vec.div`.

sqrt, cbrt and acos are autograd Functions with CLAMPED derivatives: the
solver evaluates them at exact zeros (or at +-1 for acos) on branches
that a `where` then masks, and the unclamped derivative there (inf) times
a zero cotangent is NaN, which would poison every torus gradient
(rray_tpu's _gsqrt/_gcbrt/_gacos). Their values are exact.
"""
from __future__ import annotations

import torch

from .vec import div

_TINY = 1e-12


def _safe_div(a, b):
    tiny = torch.where(b < 0, torch.full_like(b, -_TINY),
                       torch.full_like(b, _TINY))
    return a / torch.where(torch.abs(b) < _TINY, tiny, b)


def f64_round(fn, *xs):
    """fn on float32 tensors evaluated in float64 and rounded back (the
    kernel's `(float)fn((double)x)`); float64 tensors directly."""
    if xs[0].dtype != torch.float32:
        return fn(*xs)
    return fn(*(x.double() for x in xs)).float()


def _cbrt(x):
    """Real cube root as sign(x) |x|^(1/3) (torch has no cbrt)."""
    return f64_round(lambda v: torch.sign(v) * torch.abs(v).pow(1.0 / 3.0), x)


class _GSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (0.5 / torch.clamp_min(y, 1e-12))


class _GCbrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _cbrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g / torch.clamp_min(3.0 * y * y, 1e-12)


class _GAcos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return f64_round(torch.acos, x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (-1.0 / torch.sqrt(torch.clamp_min(1.0 - x * x, 1e-12)))


gsqrt, gcbrt, gacos = _GSqrt.apply, _GCbrt.apply, _GAcos.apply


def _largest_real_cubic_root(b, c, d):
    """Largest real root of y^3 + b y^2 + c y + d = 0 (there is always at
    least one): the trigonometric form for three real roots, Cardano's
    for one."""
    shift = div(b, 3.0)
    p = c - div(b * b, 3.0)
    q = div(2.0 * b * b * b, 27.0) - div(b * c, 3.0) + d
    disc = 4.0 * p * p * p + 27.0 * q * q
    three_real = disc <= 0.0

    p_neg = torch.clamp_max(p, -_TINY)
    m = 2.0 * gsqrt(div(-p_neg, 3.0))
    arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    theta = div(gacos(arg), 3.0)
    w_tri = m * f64_round(torch.cos, theta)  # k = 0: the largest root

    disc_pos = torch.clamp_min(div(disc, 108.0), 0.0)  # (q/2)^2 + (p/3)^3
    sq = gsqrt(disc_pos)
    u3 = -q / 2.0 + sq
    v3 = -q / 2.0 - sq
    w_card = gcbrt(u3) + gcbrt(v3)
    return torch.where(three_real, w_tri, w_card) - shift


def _quadratic(b, c):
    """Roots of x^2 + b x + c with a validity mask (stable pairing)."""
    disc = b * b - 4.0 * c
    ok = disc >= 0.0
    s = gsqrt(torch.clamp_min(disc, 0.0))
    qq = -0.5 * (b + torch.sign(b) * s)
    small = torch.abs(b) < _TINY
    r1 = torch.where(small, -0.5 * s, qq)
    r2 = torch.where(small, 0.5 * s, _safe_div(c, qq))
    return r1, r2, ok


def solve_quartic_parts(c4, c3, c2, c1, c0, polish_iters: int = 3):
    """All real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0 = 0 ->
    (4 root tensors, 4 validity masks), shaped like the coefficients.
    Invalid lanes hold junk."""
    inv4 = _safe_div(torch.ones_like(c4), c4)
    b, c, d, e = c3 * inv4, c2 * inv4, c1 * inv4, c0 * inv4

    # Depressed quartic u^4 + p u^2 + q u + r, x = u - b/4.
    b2 = b * b
    p = c - 3.0 * b2 / 8.0
    q = d - b * c / 2.0 + b2 * b / 8.0
    r = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0

    # Resolvent cubic y^3 + 2p y^2 + (p^2 - 4r) y - q^2 = 0: its largest
    # real root is >= 0.
    y = _largest_real_cubic_root(2.0 * p, p * p - 4.0 * r, -q * q)
    y = torch.clamp_min(y, 0.0)
    s = gsqrt(y)

    biquad = s < 1e-6
    # Ferrari: (u^2 + s u + t1)(u^2 - s u + t2).
    half = (p + y) / 2.0
    qs = _safe_div(q, 2.0 * s)
    t1 = half - qs
    t2 = half + qs
    zero = torch.zeros_like(t1)
    r1a, r1b, ok1 = _quadratic(s, torch.where(biquad, zero, t1))
    r2a, r2b, ok2 = _quadratic(-s, torch.where(biquad, zero, t2))

    # Biquadratic fallback (q ~ 0): u^2 = z, z^2 + p z + r = 0.
    z1, z2, okz = _quadratic(p, r)
    bq1ok = okz & (z1 >= 0.0)
    bq2ok = okz & (z2 >= 0.0)
    sz1 = gsqrt(torch.clamp_min(z1, 0.0))
    sz2 = gsqrt(torch.clamp_min(z2, 0.0))

    shift = b / 4.0
    roots = [torch.where(biquad, sz1, r1a) - shift,
             torch.where(biquad, -sz1, r1b) - shift,
             torch.where(biquad, sz2, r2a) - shift,
             torch.where(biquad, -sz2, r2b) - shift]
    valid12 = (biquad & bq1ok) | (~biquad & ok1)
    valid34 = (biquad & bq2ok) | (~biquad & ok2)
    valids = (valid12, valid12, valid34, valid34)

    # Newton polish on the original quartic, per root.
    for i in range(4):
        x = roots[i]
        for _ in range(polish_iters):
            f = (((c4 * x + c3) * x + c2) * x + c1) * x + c0
            df = ((4.0 * c4 * x + 3.0 * c3) * x + 2.0 * c2) * x + c1
            step = torch.clamp(_safe_div(f, df), -1.0, 1.0)
            x = x - torch.where(valids[i], step, 0.0)
        roots[i] = x
    return tuple(roots), valids


def solve_quartic(c4, c3, c2, c1, c0, polish_iters: int = 3,
                  safe_transcendentals: bool = False):
    """All real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0 = 0 ->
    (roots [..., 4], valid [..., 4]), `solve_quartic_parts` stacked on
    a last axis (rray_tpu's solve_quartic). Invalid lanes hold junk.
    `safe_transcendentals` selects rray_tpu's Mosaic-safe atan2/acos on
    a TPU; it has no meaning here and is ignored."""
    roots, valids = solve_quartic_parts(c4, c3, c2, c1, c0, polish_iters)
    return torch.stack(roots, dim=-1), torch.stack(valids, dim=-1)
