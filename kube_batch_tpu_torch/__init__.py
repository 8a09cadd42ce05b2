"""PyTorch and CUDA port of kube_batch_tpu's allocate session solve.

The package mirrors kube_batch_tpu's module layout (``ops/solver.py`` here
is the counterpart of ``kube_batch_tpu/ops/solver.py``) and imports torch
and numpy only: never jax, never kube_batch_tpu.  Its whole-session solve
is a hand-written CUDA kernel (``csrc/solve_session.cu``) built at first
use; every entry point runs on the CUDA device unless the caller passes a
CPU device, where the plain PyTorch version of each kernel runs instead.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
