"""Custom exceptions (a port of `tamtr_tpu/utils/errors.py`, the reference's
`utils/errors.py`)."""

from __future__ import annotations


class HUBModelError(Exception):
    """Raised when a model asset cannot be fetched (reference `errors.py:6-21`)."""

    def __init__(self, message: str = "Model not found. Please check model URL and try again."):
        super().__init__(message)
