"""Process-wide flag registry.

The port's copy of the JAX package's ``utils/flags.py`` (after the
reference's gflags layer, core/common/Flags.h:21-55): compile-time
defaults, overridable from the environment (``LOONG_<NAME>``, the same
variables the JAX package reads).  The flags themselves are defined by
the modules that read them, with the JAX package's names and defaults:
today the file server's (``input/file/file_server.py``).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class _Flag:
    name: str
    value: Any
    default: Any
    typ: type
    help: str


_registry: Dict[str, _Flag] = {}
_lock = threading.Lock()


def _define(name: str, default: Any, typ: type, help_: str) -> None:
    with _lock:
        if name in _registry:
            return
        value = default
        env = os.environ.get("LOONG_" + name.upper())
        if env is not None:
            if typ is bool:
                value = env.lower() in ("1", "true", "yes", "on")
            else:
                value = typ(env)
        _registry[name] = _Flag(name, value, default, typ, help_)


def DEFINE_FLAG_INT32(name: str, help_: str, default: int) -> None:
    _define(name, int(default), int, help_)


def DEFINE_FLAG_INT64(name: str, help_: str, default: int) -> None:
    _define(name, int(default), int, help_)


def get_flag(name: str) -> Any:
    return _registry[name].value
