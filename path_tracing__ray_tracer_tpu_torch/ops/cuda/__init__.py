"""Hand-written CUDA kernels (sources under ``csrc/``), each beside its plain
torch version.  Each kernel's wrapper counts its launches on ``.launches``
(the plain version does not count); :func:`launch_counts` reads them all and
:func:`add_launches` adds counts made elsewhere (a mesh worker's) onto them."""
from __future__ import annotations

import importlib
import pkgutil
from typing import Callable, Dict


def wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper of this package by ``module.name`` (the first
    name a module binds it to)."""
    found: Dict[int, tuple] = {}
    for info in pkgutil.iter_modules(__path__):
        m = importlib.import_module(f"{__name__}.{info.name}")
        for name, fn in vars(m).items():
            if isinstance(getattr(fn, "launches", None), int) and fn.__module__ == m.__name__:
                found.setdefault(id(fn), (f"{info.name}.{name}", fn))
    return dict(found.values())


def launch_counts() -> Dict[str, int]:
    """Each wrapper's launch count, by ``module.name``."""
    return {key: fn.launches for key, fn in wrappers().items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by ``module.name``, as :func:`launch_counts` gives
    them) onto the wrappers' launch counts."""
    found = wrappers()
    for key, n in counts.items():
        found[key].launches += n

