"""Leveled timestamped logger (reference: include/graphtyper/utilities/
logging.hpp — stderr or file sink, levels debug..error; log lines are the
de-facto metrics interface).
"""

from __future__ import annotations

import logging
import sys

_LOGGER = logging.getLogger("graphtyper_tpu")


def setup_logging(log_path: str = "", verbose: bool = False, vverbose: bool = False) -> logging.Logger:
    level = logging.DEBUG if vverbose else (logging.INFO if verbose else logging.WARNING)
    _LOGGER.setLevel(level)
    _LOGGER.handlers.clear()
    handler = logging.StreamHandler(sys.stderr) if log_path in ("", "-") else logging.FileHandler(log_path)
    handler.setFormatter(logging.Formatter("[%(asctime)s] <%(levelname)s> %(message)s", "%Y-%m-%d %H:%M:%S"))
    _LOGGER.addHandler(handler)
    return _LOGGER


def get_logger() -> logging.Logger:
    return _LOGGER
