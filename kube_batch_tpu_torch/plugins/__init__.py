"""Scheduler plugins (L3): gang, drf, proportion, priority, predicates,
nodeorder, conformance, tpu-score.

TPU-native counterpart of kube-batch pkg/scheduler/plugins/.
"""
