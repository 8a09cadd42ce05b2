"""Typed access over per-plugin string arguments.

Mirrors kube-batch pkg/scheduler/framework/arguments.go:28-76.
"""

from __future__ import annotations

from typing import Dict, Optional


class Arguments(dict):
    """``map[string]string`` plugin arguments with typed getters."""

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        value = self.get(key)
        if value is None or value == "":
            return default
        try:
            return int(value)
        except (TypeError, ValueError):
            return default

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        value = self.get(key)
        if value is None or value == "":
            return default
        try:
            return float(value)
        except (TypeError, ValueError):
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        value = self.get(key)
        if value is None or value == "":
            return default
        return str(value).strip().lower() in ("1", "t", "true", "y", "yes")
