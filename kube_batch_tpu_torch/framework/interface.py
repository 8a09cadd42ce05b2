"""Action and Plugin interfaces (reference framework/interface.go:19-42)."""

from __future__ import annotations

import abc


class Action(abc.ABC):
    """A scheduling policy step executed once per session."""

    @abc.abstractmethod
    def name(self) -> str: ...

    def initialize(self) -> None: ...

    @abc.abstractmethod
    def execute(self, ssn) -> None: ...

    def uninitialize(self) -> None: ...


class Plugin(abc.ABC):
    """An extension hooked into Session callback registries."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def on_session_open(self, ssn) -> None: ...

    def on_session_close(self, ssn) -> None: ...
