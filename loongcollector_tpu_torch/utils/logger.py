"""Agent logger (reference: core/logger/Logger.cpp — spdlog, config driven)."""

from __future__ import annotations

import logging
import os
import sys

_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    level = os.environ.get("LOONG_LOG_LEVEL", "INFO").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )
    )
    root = logging.getLogger("loong")
    root.setLevel(getattr(logging, level, logging.INFO))
    root.addHandler(handler)
    root.propagate = False
    _configured = True


def get_logger(name: str = "loong") -> logging.Logger:
    _configure()
    if not name.startswith("loong"):
        name = "loong." + name
    return logging.getLogger(name)
