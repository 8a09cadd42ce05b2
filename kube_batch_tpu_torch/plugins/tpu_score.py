"""tpu-score plugin: node scoring served by the device kernels.

The north star (BASELINE.json) asks for a ``tpu-score`` plugin registered
through the normal plugin boundary.  For host actions it registers the same
weighted scoring functions as nodeorder (so any action works with it); for
the tpu-allocate action its weights flow into the batched scoring kernel
(ops/scoring.py) via tensorize_session.  This keeps one source of truth for
the scoring math across both execution paths.
"""

from __future__ import annotations

from ..framework import Arguments
from .nodeorder import NodeOrderPlugin


class TpuScorePlugin(NodeOrderPlugin):

    def name(self) -> str:
        return "tpu-score"


def new(arguments: Arguments) -> TpuScorePlugin:
    return TpuScorePlugin(arguments)
