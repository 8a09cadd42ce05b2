"""Scheduling actions (L4): allocate, preempt, reclaim, backfill,
tpu-allocate.

TPU-native counterpart of kube-batch pkg/scheduler/actions/.
"""
