"""PEP 562 lazy names for the port's package ``__init__`` modules.

A package that routes its names through :func:`lazy_names` imports a
submodule only when a name from it is first used, so importing the package
(and ``python -m`` of a stdlib-only entry point under it: the fleet's
router and supervisor, the obs CLI's fleet commands) loads no torch.
"""

from __future__ import annotations

import importlib


def lazy_names(package: str, namespace: dict, names: dict[str, str],
               submodules: tuple[str, ...]):
    """``(__getattr__, __dir__)`` for ``package``: a name in ``names``
    comes from the submodule it maps to (and is cached in ``namespace``),
    a name in ``submodules`` is that submodule."""

    def __getattr__(name: str):
        if name in submodules:
            return importlib.import_module(f".{name}", package)
        mod = names.get(name)
        if mod is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(f".{mod}", package), name)
        namespace[name] = value
        return value

    def __dir__():
        return sorted(set(namespace) | set(names) | set(submodules))

    return __getattr__, __dir__
