"""The port's logger (the JAX package's `utils/log.py`, one process)."""

from __future__ import annotations

import logging
import sys

LOGGER = logging.getLogger("tamtr_torch")
if not LOGGER.handlers:
    _h = logging.StreamHandler(sys.stdout)
    _h.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO)
    LOGGER.propagate = False
