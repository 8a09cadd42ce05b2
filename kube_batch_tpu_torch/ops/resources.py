"""Resource comparisons in integer quanta (kube_batch_tpu/ops/resources.py).

Device tensors hold int32 fixed-point quanta: cpu in milli-CPU, memory in
MiB (2**20 bytes), scalars in milli-units.  Every add and subtract in the
solve is then exact integer math, and every epsilon is exactly
``EPS_QUANTA`` = 10 quanta.  The epsilon compares below are the
reference's, element for element; int32 differences wrap as they do in
XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

CPU_QUANTUM = 1.0                 # milli-CPU
MEMORY_QUANTUM = float(2 ** 20)   # bytes per quantum (1 MiB)
SCALAR_QUANTUM = 1.0              # milli-units
EPS_QUANTA = 10                   # 10 milli / 10 MiB / 10 milli-scalar

# Integer grid scoring (see the reference module for the exactness proof):
#   cs = cap >> shift; xs = min((used + res) >> shift, cs)
#   frac_grid = K if cs == 0 else (xs * K) // cs
# The device computes the floor as a correctly rounded float division,
# exact because xs * K <= 2**22.
SCORE_GRID_K = 1 << 12
_SCORE_CAP_LIMIT = 1 << 10


def score_shift_for(max_cap_quanta: int) -> int:
    """Per-dimension shift normalizing the largest capacity below 2**10."""
    s = 0
    while (int(max_cap_quanta) >> s) >= _SCORE_CAP_LIMIT:
        s += 1
    return s


def grid_fraction_int(x: int, cap: int, shift: int) -> int:
    """Host-side grid fraction (exact Python ints)."""
    cs = int(cap) >> shift
    if cs == 0:
        return SCORE_GRID_K
    xs = min(int(x) >> shift, cs)
    return (xs * SCORE_GRID_K) // cs


def quantum_for_dim(i: int) -> float:
    return (CPU_QUANTUM, MEMORY_QUANTUM)[i] if i < 2 else SCALAR_QUANTUM


def quantize_value(value: float, dim: int) -> int:
    """Host-side: one float64 quantity -> integer quanta."""
    return int(round(value / quantum_for_dim(dim)))


def scale_columns(arr: np.ndarray) -> np.ndarray:
    """Host-side: [..., R] float64 resources -> float quanta, scaled
    exactly (power-of-two division) but not rounded."""
    out = arr / MEMORY_QUANTUM
    out[..., 0] = arr[..., 0] / CPU_QUANTUM
    if arr.shape[-1] > 2:
        out[..., 2:] = arr[..., 2:] / SCALAR_QUANTUM
    return out


def quantize_columns(arr: np.ndarray) -> np.ndarray:
    """Host-side: [..., R] float64 resources -> int64 quanta (callers
    range-check before narrowing to int32)."""
    return np.rint(scale_columns(arr)).astype(np.int64)


def eps_vector(r: int, dtype=torch.int32, device=None) -> torch.Tensor:
    """Per-dimension epsilon in quanta: 10 everywhere by construction."""
    return torch.full((max(r, 2),), EPS_QUANTA, dtype=dtype,
                      device=resolve_device(device))


def scalar_dims_mask(r: int, device=None) -> torch.Tensor:
    """[R] bool marking scalar-resource dims (index >= 2)."""
    return torch.tensor([False, False] + [True] * (max(r, 2) - 2),
                        device=resolve_device(device))


def less_equal_vec(l: torch.Tensor, r: torch.Tensor, eps: torch.Tensor,
                   scalar_dims: torch.Tensor) -> torch.Tensor:
    """Epsilon-tolerant Resource.LessEqual reduced over the last axis:
    per dim l < r or |l-r| < eps; scalar dims with l <= eps are skipped."""
    ok = (l < r) | (torch.abs(l - r) < eps)
    skip = scalar_dims & (l <= eps)
    return torch.all(ok | skip, dim=-1)


def less_vec(l: torch.Tensor, r: torch.Tensor, eps: torch.Tensor,
             scalar_dims: torch.Tensor) -> torch.Tensor:
    """Strict Resource.Less over the last axis; a scalar dim with
    l <= eps counts as less only when r's dim exceeds eps."""
    strict = l < r
    trivial = scalar_dims & (l <= eps) & (r > eps)
    return torch.all(strict | trivial, dim=-1)


def is_empty_vec(v: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Resource.IsEmpty: every dim below its epsilon."""
    return torch.all(v < eps, dim=-1)
