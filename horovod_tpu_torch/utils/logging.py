"""Leveled logging: ``HOROVOD_LOG_LEVEL`` = trace, debug, info, warning,
error or fatal (Horovod's ``horovod/common/logging.cc``), with
``HOROVOD_LOG_HIDE_TIME``.

Counterpart of ``horovod_tpu/utils/logging.py`` over the package logger
``horovod_tpu_torch``: every module's ``logging.getLogger(__name__)``
sits under it.  Its handler writes to stderr only while the root logger
has none; once the application (or pytest) configures the root, records
reach it by propagation instead, so nothing prints twice.
"""

from __future__ import annotations

import logging
import os
import sys

ROOT = "horovod_tpu_torch"

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(_LEVELS["trace"], "TRACE")

_configured = False


def _root_unconfigured(record: logging.LogRecord) -> bool:
    del record
    return not logging.getLogger().handlers


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    level_name = (os.environ.get("HOROVOD_LOG_LEVEL")
                  or os.environ.get("HVD_TPU_LOG_LEVEL") or "warning")
    hide_time = (os.environ.get("HOROVOD_LOG_HIDE_TIME", "0").lower()
                 in ("1", "true", "yes", "on"))
    fmt = ("[%(levelname)s] %(name)s: %(message)s" if hide_time else
           "%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    root = logging.getLogger(ROOT)
    root.setLevel(_LEVELS.get(level_name.lower(), logging.WARNING))
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(fmt))
        handler.addFilter(_root_unconfigured)
        root.addHandler(handler)
    _configured = True


def get_logger(name: str) -> logging.Logger:
    """The logger ``name`` under ``horovod_tpu_torch``."""
    _configure_root()
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


def set_level(level_name: str) -> None:
    """Apply a level by its reference name (``basics.init`` calls it with
    ``Config.log_level``); an unknown name means warning, as the
    reference's parser has it."""
    _configure_root()
    logging.getLogger(ROOT).setLevel(
        _LEVELS.get(level_name.lower(), logging.WARNING))
