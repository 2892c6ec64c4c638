"""Process-wide flag registry.

The port's copy of the JAX package's ``utils/flags.py`` (after the
reference's gflags layer, core/common/Flags.h:21-55): compile-time
defaults, overridable from the environment (``LOONG_<NAME>``, the same
variables the JAX package reads).  The flags themselves are defined by
the modules that read them, with the JAX package's names and defaults:
the file server's (``input/file/file_server.py``), the flusher runner's
``enable_full_drain_mode`` and the application's ``exit_flush_timeout``
(``LOONG_EXIT_FLUSH_TIMEOUT``).
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


def DEFINE_FLAG_BOOL(name: str, help_: str, default: bool) -> None:
    _define(name, bool(default), bool, help_)


def DEFINE_FLAG_DOUBLE(name: str, help_: str, default: float) -> None:
    _define(name, float(default), float, help_)


def get_flag(name: str) -> Any:
    return _registry[name].value


def set_flag(name: str, value: Any) -> None:
    with _lock:
        flag = _registry[name]
        if flag.typ is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes", "on")
        flag.value = flag.typ(value)
