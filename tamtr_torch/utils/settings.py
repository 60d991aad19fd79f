"""Persistent user settings (a port of `tamtr_tpu/utils/settings.py`; the
reference's `SettingsManager`, `utils/__init__.py:827-931`).

A version-keyed settings file of machine-level defaults: the datasets,
weights and runs directories, the crash-report switch `sync`, and one
switch per logger integration (`utils/callbacks.py:attach_integrations`
reads them). The file is `settings.yaml` in `$TAMTR_CONFIG_DIR/tamtr_torch`,
else `$XDG_CONFIG_HOME/tamtr_torch`, else `~/.config/tamtr_torch`, read when
a `SettingsManager` is made. It is the flat `key: value` YAML that
`yaml.safe_dump` writes for these scalars, written and read without yaml
(`config.dump_flat_yaml`, `config.parse_config_text`), so a file either
package writes reads back equal in the other. `python -m tamtr_torch
settings` prints, updates or resets it (`cli.py`).
"""

from __future__ import annotations

import os
import uuid
from pathlib import Path
from typing import Any, Dict

from tamtr_torch.config import dump_flat_yaml, parse_config_text

SETTINGS_VERSION = "0.1.0"


def config_dir() -> Path:
    """The package's configuration directory (module docstring)."""
    base = os.environ.get("TAMTR_CONFIG_DIR") or os.environ.get("XDG_CONFIG_HOME", str(Path.home() / ".config"))
    return Path(base) / "tamtr_torch"


def read_settings_text(text: str) -> Dict[str, Any]:
    """A flat YAML mapping, with the continuation lines that `yaml.safe_dump`
    folds a long string into joined back (each line break a space)."""
    lines = []
    for line in text.splitlines():
        if line[:1] in (" ", "\t") and lines:
            lines[-1] += " " + line.strip()
        else:
            lines.append(line)
    return parse_config_text("\n".join(lines), "settings.yaml")


class SettingsManager(dict):
    """The settings as a dict, with the keys and defaults of the JAX
    package's. A file of another version, or with other keys, is ignored
    (the defaults stand, as the reference resets); an unreadable one too.
    `update` refuses unknown keys; `save` writes the file, with a fresh
    `uuid` the first time; `reset` writes the defaults."""

    def __init__(self, file: Path | str | None = None) -> None:
        self.file = Path(file) if file else config_dir() / "settings.yaml"
        root = Path.cwd()
        self.defaults: Dict[str, Any] = {
            "settings_version": SETTINGS_VERSION,
            "datasets_dir": str(root / "datasets"),
            "weights_dir": str(root / "weights"),
            "runs_dir": str(root / "runs"),
            "uuid": "",  # filled on the first save
            "sync": False,  # crash reports (`utils/crash.py`) are written only when True
            "hub": False,
            "tensorboard": True,
            "wandb": True,
            "mlflow": True,
            "comet": True,
            "clearml": True,
            "neptune": True,
            "dvc": True,
            "raytune": True,
        }
        super().__init__(self.defaults)
        try:
            loaded = read_settings_text(self.file.read_text(encoding="utf-8")) if self.file.exists() else {}
        except (OSError, UnicodeDecodeError, SyntaxError, ValueError):
            loaded = {}  # an unreadable file never stops a run
        if isinstance(loaded, dict) and loaded.get("settings_version") == SETTINGS_VERSION \
                and set(loaded) == set(self.defaults):
            self.update(loaded)

    def save(self) -> None:
        if not self["uuid"]:
            self["uuid"] = uuid.uuid4().hex
        self.file.parent.mkdir(parents=True, exist_ok=True)
        self.file.write_text(dump_flat_yaml(dict(self)), encoding="utf-8")

    def update(self, *args, **kwargs) -> None:  # type: ignore[override]
        new = dict(*args, **kwargs)
        unknown = set(new) - set(self.defaults)
        if unknown:
            raise KeyError(f"unknown settings key(s) {sorted(unknown)}; valid: {sorted(self.defaults)}")
        super().update(new)

    def reset(self) -> None:
        self.clear()
        super().update(self.defaults)
        self.save()
