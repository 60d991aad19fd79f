"""Local crash reports (a port of `tamtr_tpu/utils/crash.py`; the offline
counterpart of the reference's Sentry hook, `utils/__init__.py:753-826`).

`set_crash_reporting()` installs a `sys.excepthook` that writes an
unhandled exception's report (`crash_<time>_<pid>.txt`: the traceback, the
Python, torch and CUDA device it ran on) under
`utils/settings.config_dir() / "crash_reports"`, then calls the previous
hook. As in the JAX package:

  - it is installed only when the settings' `sync` is True,
  - and not under pytest;
  - KeyboardInterrupt, FileNotFoundError and out-of-memory errors are not
    reported.

Nothing leaves the machine: the report is a file for the user to attach to
a bug report.
"""

from __future__ import annotations

import os
import platform
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

_INSTALLED = False
_PREV_HOOK = None


def _crash_dir() -> Path:
    from tamtr_torch.utils.settings import config_dir

    return config_dir() / "crash_reports"


def _device_line() -> str:
    import torch

    dev = f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}" if torch.cuda.is_available() else "cpu"
    return f"torch: {torch.__version__}  device: {dev}"


def write_crash_report(exc_type, exc_value, tb, extra: str = "") -> Optional[Path]:
    """Write one report; its path, or None when it could not be written."""
    try:
        d = _crash_dir()
        d.mkdir(parents=True, exist_ok=True)
        stamp = f"{time.strftime('%Y%m%d_%H%M%S')}_{int(time.time() * 1e6) % 1000000:06d}"
        path = d / f"crash_{stamp}_{os.getpid()}.txt"
        lines = [
            f"tamtr_torch crash report  {time.strftime('%Y-%m-%d %H:%M:%S')}",
            f"python: {sys.version.split()[0]}  platform: {platform.platform()}",
            f"argv: {sys.argv}",
            f"cwd: {os.getcwd()}",
            _device_line(),
        ]
        if extra:
            lines.append(extra)
        lines.append("")
        lines.extend(traceback.format_exception(exc_type, exc_value, tb))
        path.write_text("\n".join(lines))
        return path
    except Exception:  # the hook runs while the process dies: report nothing rather than raise
        return None


def _hook(exc_type, exc_value, tb):
    msg = str(exc_value).lower()
    if not (exc_type in (KeyboardInterrupt, FileNotFoundError) or "out of memory" in msg
            or "resource_exhausted" in msg):
        p = write_crash_report(exc_type, exc_value, tb)
        if p is not None:
            print(f"crash report written to {p}", file=sys.stderr)
    if _PREV_HOOK is not None:
        _PREV_HOOK(exc_type, exc_value, tb)


def set_crash_reporting() -> bool:
    """Install the hook if the settings allow (module docstring); whether it
    is installed. Calling it again changes nothing."""
    global _INSTALLED, _PREV_HOOK
    if _INSTALLED:
        return True
    if "PYTEST_CURRENT_TEST" in os.environ or "pytest" in sys.modules:
        return False
    from tamtr_torch.utils.settings import SettingsManager

    if not SettingsManager().get("sync", False):
        return False
    _PREV_HOOK = sys.excepthook
    sys.excepthook = _hook
    _INSTALLED = True
    return True
