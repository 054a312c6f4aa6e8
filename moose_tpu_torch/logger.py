"""Logging shim (reference ``pymoose/pymoose/logger.py``): one shared
logger for the package, configured by the CLIs or the embedding app.

The port's own copy of ``moose_tpu/logger.py``, under the logger name
``moose_tpu_torch``."""

from __future__ import annotations

import logging

_LOGGER_NAME = "moose_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def set_verbose(verbose: bool = True):
    level = logging.DEBUG if verbose else logging.INFO
    logger = get_logger()
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"
            )
        )
        logger.addHandler(handler)
    return logger
