"""Callback event registry (the JAX package's `utils/callbacks.py:Callbacks`):
named hooks fired at train and val lifecycle points. The logger
integrations (TensorBoard, CSV, hub) are not ported."""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List

EVENTS = [
    "on_pretrain_routine_start",
    "on_pretrain_routine_end",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_start",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
    "on_val_start",
    "on_val_batch_start",
    "on_val_batch_end",
    "on_val_end",
    "on_predict_start",
    "on_predict_batch_start",
    "on_predict_batch_end",
    "on_predict_end",
    "teardown",
]


class Callbacks:
    def __init__(self) -> None:
        self._hooks: Dict[str, List[Callable]] = defaultdict(list)

    def add(self, event: str, fn: Callable) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown event {event!r}; valid: {EVENTS}")
        self._hooks[event].append(fn)

    def fire(self, event: str, *args: Any, **kwargs: Any) -> None:
        for fn in self._hooks.get(event, []):
            fn(*args, **kwargs)
