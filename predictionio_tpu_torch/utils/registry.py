"""Component registries — the Python replacement for JVM reflection.

The reference instantiates DASE components, storage clients and engine
factories reflectively from class names (core/AbstractDoer.scala:45,
data/.../Storage.scala:310, workflow/WorkflowUtils.scala:47).  Here, components
register under a name (or are resolved by ``module:attr`` import path), and
``doer`` instantiates them with an optional params object — the AbstractDoer
contract: try ``Cls(params)``, fall back to ``Cls()``.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Callable, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A named registry with decorator-style registration and import-path fallback."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, T] = {}

    def register(self, name: str, obj: T | None = None) -> Any:
        if obj is not None:
            self._entries[name] = obj
            return obj

        def deco(o: T) -> T:
            self._entries[name] = o
            return o

        return deco

    def get(self, name: str) -> T:
        """Resolve a registered name, or import ``pkg.module:attr`` / ``pkg.module.Attr``."""
        if name in self._entries:
            return self._entries[name]
        obj = resolve_import_path(name)
        if obj is None:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {sorted(self._entries)}"
            )
        return obj  # type: ignore[return-value]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def names(self) -> list[str]:
        return sorted(self._entries)


def resolve_import_path(path: str) -> Any | None:
    """Import ``pkg.mod:attr`` or dotted ``pkg.mod.Attr``; None if unresolvable."""
    if ":" in path:
        mod_name, _, attr = path.partition(":")
        try:
            return getattr(importlib.import_module(mod_name), attr)
        except (ImportError, AttributeError):
            return None
    if "." in path:
        mod_name, _, attr = path.rpartition(".")
        try:
            return getattr(importlib.import_module(mod_name), attr)
        except (ImportError, AttributeError):
            return None
    return None


def _takes_argument(cls: Callable[..., Any]) -> bool:
    """True when cls's constructor accepts one positional argument."""
    try:
        sig = inspect.signature(cls)
    except (TypeError, ValueError):
        return True  # builtins without introspectable signatures: just try
    for p in sig.parameters.values():
        if p.kind in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
            inspect.Parameter.VAR_POSITIONAL,
        ):
            return True
    return False


def doer(cls: Callable[..., T], params: Any = None) -> T:
    """Instantiate a component with params if its constructor takes them.

    Mirrors AbstractDoer (core/AbstractDoer.scala:45-67): prefer the
    one-argument ``(params)`` constructor, fall back to zero-argument.  The
    choice is made by signature inspection so a TypeError raised *inside* a
    matching constructor propagates instead of silently dropping the params.
    """
    if params is not None and _takes_argument(cls):
        return cls(params)  # type: ignore[call-arg]
    return cls()
