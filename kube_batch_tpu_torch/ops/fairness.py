"""DRF shares and proportion water-filling (kube_batch_tpu/ops/fairness.py).

Dominant share = max over resources of allocated/total (drf.go:161-171);
the proportion ``deserved`` water-fill (proportion.go:101-154) is a loop
over [Q, R] tensors.
"""

from __future__ import annotations

import torch

from .resources import EPS_QUANTA, is_empty_vec, less_vec, scalar_dims_mask


def safe_share(alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """share() per element: x/0 -> 1 (0/0 -> 0), helpers.go:47-59.

    The division is always float32 of float32-cast operands, matching the
    host's share bit for bit in both float modes: a share near-tie must
    resolve identically everywhere, or job and queue order diverge."""
    f32 = torch.float32
    alloc = torch.as_tensor(alloc).to(f32)
    total = torch.as_tensor(total, device=alloc.device).to(f32)
    zero_total = total == 0
    return torch.where(zero_total,
                       (alloc != 0).to(f32),
                       alloc / torch.where(zero_total, torch.ones_like(total),
                                           total))


def drf_shares(job_alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """[J, R] allocated, [R] total -> [J] dominant shares."""
    return torch.amax(safe_share(job_alloc, total[None, :]), dim=-1)


def queue_shares(queue_alloc: torch.Tensor,
                 deserved: torch.Tensor) -> torch.Tensor:
    """[Q, R] allocated, [Q, R] deserved -> [Q] shares."""
    return torch.amax(safe_share(queue_alloc, deserved), dim=-1)


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 one row at a time, in order: the order XLA's CPU
    reduction takes, so the float sums round identically."""
    acc = x[0]
    for row in x[1:]:
        acc = acc + row
    return acc


def proportion_deserved(total: torch.Tensor, weight: torch.Tensor,
                        request: torch.Tensor, active: torch.Tensor,
                        max_iters: int = 64) -> torch.Tensor:
    """Weighted max-min water-filling of deserved resources.

    total: [R]; weight: [Q]; request: [Q, R]; active: [Q] bool.  Each
    round splits ``remaining`` by weight among unmet queues, caps a queue
    at its request (it is then met and its surplus returns to the pool),
    and stops when remaining is epsilon-empty or every queue is met.
    Returns float deserved [Q, R] (float32, or float64 for f64 totals)."""
    fdt = torch.promote_types(total.dtype, torch.float32)
    total = total.to(fdt)
    weight = weight.to(fdt)
    request = request.to(fdt)
    r = total.shape[-1]
    eps = torch.full((max(r, 2),), EPS_QUANTA, dtype=fdt, device=total.device)
    scalar_dims = scalar_dims_mask(r, device=total.device)
    zero = torch.zeros((), dtype=fdt, device=total.device)

    deserved = torch.zeros_like(request)
    remaining = total.clone()
    met = torch.zeros(weight.shape[0], dtype=torch.bool, device=total.device)
    for _ in range(max_iters):
        live = active & ~met
        total_weight = _sum_rows(torch.where(live, weight, zero))
        if not (bool(total_weight > 0)
                and not bool(is_empty_vec(remaining, eps))):
            break
        frac = torch.where(live, weight, zero) / torch.clamp(total_weight,
                                                             min=1e-30)
        # One fused multiply-add, as XLA contracts this expression.
        proposed = torch.addcmul(deserved, frac[:, None], remaining[None, :])
        newly_met = live & less_vec(request, proposed, eps, scalar_dims)
        capped = torch.where(newly_met[:, None],
                             torch.minimum(proposed, request), proposed)
        new_deserved = torch.where(live[:, None], capped, deserved)
        delta = _sum_rows(torch.where(live[:, None], new_deserved - deserved,
                                      zero))
        deserved, remaining, met = new_deserved, remaining - delta, \
            met | newly_met
    return deserved
