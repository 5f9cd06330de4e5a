"""Logging: a namespaced stdlib logger and the checkpoint load report (a
copy of the JAX package's ``utils/logging.py``).

- ``get_logger()``: the ``codetr_torch`` logger, its level set once from
  ``CODETR_LOG_LEVEL`` (default INFO) or by ``set_level``.
- ``warn_once``: a warning logged once per message.
- ``log_load_report``: a checkpoint load's matched, missing and unexpected
  keys.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Set

_LOGGER_NAME = "codetr_torch"
_seen_warnings: Set[str] = set()


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s", datefmt="%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(os.environ.get("CODETR_LOG_LEVEL", "INFO").upper())
    return logger


def set_level(level: str) -> None:
    get_logger().setLevel(level.upper())


def warn_once(msg: str) -> None:
    """Log ``msg`` as a warning the first time only."""
    if msg not in _seen_warnings:
        _seen_warnings.add(msg)
        get_logger().warning(msg)


def log_load_report(matched: int, missing: Iterable[str], unexpected: Iterable[str], source: str) -> None:
    """Checkpoint load summary: matched count, then up to five missing and
    five unexpected keys."""
    logger = get_logger()
    missing, unexpected = list(missing), list(unexpected)
    logger.info("loaded %d params from %s", matched, source)
    if missing:
        logger.warning("missing %d keys: %s%s", len(missing),
                       ", ".join(missing[:5]), " ..." if len(missing) > 5 else "")
    if unexpected:
        logger.warning("unexpected %d checkpoint keys (ignored): %s%s", len(unexpected),
                       ", ".join(unexpected[:5]), " ..." if len(unexpected) > 5 else "")
