"""Device choice shared by the port's entry points.

Every entry point runs on the CUDA device unless the caller asks for the
CPU.  Without CUDA and without an explicit CPU device it raises: the port
never carries on on the CPU in silence.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch version on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def check_float_dtype(dtype) -> torch.dtype:
    """The float key dtype is an explicit torch.float32 or torch.float64."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"float key dtype must be torch.float32 or torch.float64, "
            f"got {dtype!r}")
    return dtype
