"""How far apart two results stored in bfloat16 may be.

A kernel that computes in float32 and rounds once to bfloat16, and another
version of it that does the same in another summation order, can land on
neighbouring bf16 values: their float32 sums differ by a few float32 ulps,
which may straddle a rounding boundary. So each element is held to one
bf16 spacing at its magnitude. Where a sum cancels to near zero, the
float32 order noise itself is larger than a spacing there, so each
element also gets SUM_ORDER_REL of its channel's largest magnitude: the
tolerance of the float32 kernels against their plain versions, 1/780 of a
bf16 spacing at that magnitude.
"""
from __future__ import annotations

import torch

SUM_ORDER_REL = 1e-5
_MIN_NORMAL_EXP = -125   # torch.frexp exponent of bf16's smallest normal


def bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """The gap between |x| and the next larger bfloat16 value (8
    significant bits), as float64; the subnormal gap below bf16's
    smallest normal."""
    a = x.double().abs()
    _, e = torch.frexp(a)
    e = torch.where(a < 2.0 ** (_MIN_NORMAL_EXP - 1), _MIN_NORMAL_EXP, e)
    return torch.ldexp(torch.ones_like(a), e - 8)


def bf16_agreement(got: torch.Tensor, want: torch.Tensor):
    """(largest |got - want| in units of the allowed difference, share of
    bit-equal elements) of two (C, N) results, compared in float64. The
    allowed difference of an element is one bf16 spacing at the larger
    magnitude of the two, plus SUM_ORDER_REL of its channel's largest
    magnitude; a result agrees when the first number is at most 1. NaN
    and Inf must sit at the same places on both sides, else the first
    number is inf."""
    g = got.detach().to("cpu", torch.float64)
    w = want.detach().to("cpu", torch.float64)
    fin = torch.isfinite(w)
    if not torch.equal(torch.isfinite(g), fin) or \
            not torch.equal(g[~fin].nan_to_num(), w[~fin].nan_to_num()):
        return float("inf"), 0.0
    g, w = torch.where(fin, g, 0.0), torch.where(fin, w, 0.0)
    floor = SUM_ORDER_REL * w.abs().amax(dim=1, keepdim=True)
    allowed = bf16_spacing(torch.maximum(g.abs(), w.abs())) + floor
    ratio = float(((g - w).abs() / allowed).max())
    same = float((got.detach().cpu() == want.detach().cpu())[fin].double()
                 .mean()) if bool(fin.any()) else 1.0
    return ratio, same
