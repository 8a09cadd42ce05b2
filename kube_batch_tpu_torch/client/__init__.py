"""Typed clients for the scheduling API groups (reference pkg/client/)."""

from .clientset import Clientset, new_for_cluster
from .informers import SharedInformerFactory

__all__ = ["Clientset", "new_for_cluster", "SharedInformerFactory"]
