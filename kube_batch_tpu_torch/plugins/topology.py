"""Topology plugin: fragmentation-aware node scoring
(kube_batch_tpu/plugins/topology.py, carried over line for line).

Registered as ``topology`` in the conf tiers (the same machinery every
other plugin rides), this plugin makes nodeorder prefer placements that
preserve large contiguous free blocks: a node whose torus neighbors are
already occupied (or absent) scores higher than one in the middle of a
free region, so flat (non-slice) pods pack tightly and leave room for
future slices (doc/TOPOLOGY.md "Fragmentation score").

Exactness contract: the bonus is computed ONCE per session at open —
``TopologyView.frag_bonus`` over the at-open occupancy — and stashed on
``ssn.prescan`` so models/tensor_snapshot.py folds the IDENTICAL
integers into the device solver's ``sig_bonus``.  Host prioritizer and
device score therefore cannot drift (same array, both sides); the bonus
is static for the session by design, like the preferred-node-affinity
static bonus it rides next to.

Weight: ``topology.frag.weight`` (default 1; integer — fractional
weights fall back to the host path like every other scoring weight).
With ``KUBE_BATCH_TPU_TOPOLOGY=0`` or no coordinate labels the plugin
registers nothing and both paths see zero — bit-parity with a conf that
never listed it.
"""

from __future__ import annotations

import numpy as np

from ..framework import Arguments, Plugin

FRAG_WEIGHT = "topology.frag.weight"


class TopologyPlugin(Plugin):

    def __init__(self, arguments: Arguments):
        self.arguments = arguments

    def name(self) -> str:
        return "topology"

    def frag_weight(self) -> float:
        return self.arguments.get_float(FRAG_WEIGHT, 1.0)

    def on_session_open(self, ssn) -> None:
        from ..models.topology import build_view, topology_enabled

        w = self.frag_weight()
        if not topology_enabled() or not w or w != int(w):
            return
        # Reuse the session's view when the topo action (which runs
        # after open) hasn't built one yet — open order means the plugin
        # builds it and the action reuses it via the same stash.
        view = ssn.prescan.get("topo_view")
        if view is None:
            # Cheap probe first (the topo action's discipline): an
            # unlabeled cluster must not pay an O(N) view build per
            # session just because the plugin is in the conf.
            from ..models.topology import POD_LABEL
            if not any(n.node is not None
                       and POD_LABEL in n.node.metadata.labels
                       for n in ssn.nodes.values()):
                return
            view = build_view(ssn.nodes)
            ssn.prescan["topo_view"] = view
        if not view.n_valid:
            return
        occupied = np.asarray(
            [len(ssn.nodes[name].tasks) > 0 for name in view.node_names],
            bool)
        bonus = view.frag_bonus(occupied, int(w))
        # The exact integers the device fold consumes (tensor_snapshot).
        ssn.prescan["topo_frag_bonus"] = bonus
        by_row = {name: int(bonus[i])
                  for i, name in enumerate(view.node_names)}

        def frag_score(_task, node) -> int:
            return by_row.get(node.name, 0)

        # Weight 1.0: the bonus array is already weight-multiplied, so
        # the combiner's weight * score equals the device's folded term
        # exactly.
        ssn.add_node_order_fns(self.name(), [(1.0, frag_score)])

    def on_session_close(self, ssn) -> None:
        pass


def new(arguments: Arguments) -> TopologyPlugin:
    return TopologyPlugin(arguments)
