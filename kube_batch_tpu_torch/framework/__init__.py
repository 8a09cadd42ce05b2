"""Scheduling framework (L3): session lifecycle, plugin/action registries,
tiered decision combinators, and the Statement transaction.

TPU-native counterpart of kube-batch pkg/scheduler/framework/.
"""

from .arguments import Arguments
from .events import Event, EventHandler
from .interface import Action, Plugin
from .registry import (register_action, get_action, list_actions,
                       register_plugin_builder, get_plugin_builder,
                       cleanup_plugin_builders)
from .session import Session, open_session, close_session, job_status
from .statement import Statement

__all__ = [
    "Arguments", "Event", "EventHandler", "Action", "Plugin",
    "register_action", "get_action", "list_actions",
    "register_plugin_builder", "get_plugin_builder",
    "cleanup_plugin_builders",
    "Session", "open_session", "close_session", "job_status", "Statement",
]
