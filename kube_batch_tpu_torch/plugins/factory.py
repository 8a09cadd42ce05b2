"""Plugin registration (reference plugins/factory.go:30-39)."""

from ..framework import register_plugin_builder
from . import (conformance, drf, gang, nodeorder, predicates, priority,
               proportion)


def register_default_plugins() -> None:
    register_plugin_builder("gang", gang.new)
    register_plugin_builder("priority", priority.new)
    register_plugin_builder("drf", drf.new)
    register_plugin_builder("proportion", proportion.new)
    register_plugin_builder("predicates", predicates.new)
    register_plugin_builder("nodeorder", nodeorder.new)
    register_plugin_builder("conformance", conformance.new)
    # TPU-side scoring plugin registers lazily to keep jax imports off the
    # critical path for host-only deployments.
    from . import tpu_score
    register_plugin_builder("tpu-score", tpu_score.new)
    # The topology plugin comes with the topology slice (ROADMAP queue 1
    # item 3).
