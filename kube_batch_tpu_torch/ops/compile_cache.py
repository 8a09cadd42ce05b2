"""The padded-shape bucket ladder (kube_batch_tpu/ops/compile_cache.py).

Only ``bucket`` is ported: the ladder sets every shape the session solve
sees, so it must stay identical to the reference's.  Warmup and the
compile cache are later work.
"""

from __future__ import annotations


def bucket(n: int, minimum: int = 8) -> int:
    """Next padded-shape bucket.

    Powers of two up to 1024; quarter steps within each octave above
    (1.0/1.25/1.5/1.75 x 2^k).  Every bucket above 1024 is a multiple of
    256."""
    b = minimum
    while b < n:
        b *= 2
    if b <= 1024:
        return b
    half = b // 2
    for frac in (1.25, 1.5, 1.75):
        cand = int(half * frac)
        if n <= cand:
            return cand
    return b
