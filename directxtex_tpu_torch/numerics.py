"""Float helpers that give the same bits on the CPU and on CUDA, and the
JAX package's bits wherever XLA rounds each operation on its own.

torch computes `scalar / tensor` as `reciprocal(tensor) * scalar`, and on
CUDA `tensor / scalar` as a multiply by the scalar's reciprocal; its f32
`sqrt` on the CPU is not correctly rounded (it differs from numpy's by up
to 1 ulp). The helpers below take the IEEE route on both devices: a
tensor-by-tensor division, and `sqrt` / `power` evaluated in f64 and
rounded once to f32. A per-block sum runs in index order, as the kernels
and XLA's reduction loop add. `clip` is jnp.clip's value, which torch's
clamp is not on a zero of the wrong sign.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sum0", "sum_halves", "rdiv", "fdiv", "sqrt", "power",
           "clip"]


def sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in index order (the kernels' order)."""
    s = x[0]
    for i in range(1, x.shape[0]):
        s = s + x[i]
    return s


def sum_halves(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 (a power of two long) by folding halves: x[:n/2] +
    x[n/2:], until one row is left. This is the order of XLA's CPU code
    for a sum fused with the elementwise work that feeds it, as in the
    body of a compiled loop (an 8-lane vector accumulator, then its
    halves); a sum of a materialized array runs in index order (sum0)."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """IEEE `num / den` for a python scalar numerator."""
    return torch.div(torch.full_like(den, num), den)


def fdiv(a: torch.Tensor, b: float) -> torch.Tensor:
    """IEEE `a / b` for a python scalar denominator."""
    return torch.div(a, torch.full_like(a, b))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt: f64 sqrt rounded once to f32 (a double
    rounding that is exact for sqrt), as numpy's and XLA's."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def power(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """f32 `x ** exponent` with the exponent rounded to f32 first (as a
    python float exponent is in jnp.power), evaluated in f64 and rounded
    once to f32. XLA's pow is an approximation of its own: this differs
    from it by at most 1 ulp on a small share of values."""
    e = float(np.float32(exponent))
    return torch.pow(x.to(torch.float64), e).to(torch.float32)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip(x, lo, hi): min(max(x, lo), hi) with XLA's IEEE maximum,
    which takes +0 over -0, so a -0 clipped at a lower bound of 0 is +0
    (torch's clamp keeps -0). NaN stays NaN. `lo` and `hi` are python
    numbers or tensors that broadcast against x."""
    y = torch.clamp(x, lo, hi)
    if torch.is_tensor(lo):
        plus_zero = (lo == 0) & ~torch.signbit(lo)
    elif lo == 0 and np.copysign(1.0, lo) > 0:
        plus_zero = True
    else:
        return y
    return torch.where((y == 0) & plus_zero, torch.zeros_like(y), y)
