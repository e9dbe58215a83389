"""Lazy package exports (PEP 562).

A package's ``__init__`` lists what it exports in ``__all__`` and which
submodule holds each name; importing the package imports none of those
submodules, and a name's submodule is imported on its first access.  That
keeps ``import predictionio_tpu_torch.core.metric`` (the event server's,
the router's and the dashboard's path into ``core``) free of torch, while
``from predictionio_tpu_torch.core import Engine`` works as in the JAX
package.
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, Callable, Mapping, Sequence


def lazy_exports(
    package: str, exports: Mapping[str, Sequence[str]]
) -> tuple[Callable[[str], Any], Callable[[], list[str]]]:
    """``(__getattr__, __dir__)`` for ``package``, whose ``exports`` map a
    submodule's full name to the names it provides."""
    where = {name: mod for mod, names in exports.items() for name in names}

    def __getattr__(name: str) -> Any:
        mod = where.get(name)
        if mod is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(mod), name)
        # later lookups find it in the package's namespace
        setattr(sys.modules[package], name, value)
        return value

    def __dir__() -> list[str]:
        return list(getattr(sys.modules[package], "__all__", sorted(where)))

    return __getattr__, __dir__
