"""`increment_path` (the JAX package's `utils/files.py:increment_path`)."""

from __future__ import annotations

from pathlib import Path


def increment_path(path: str | Path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """runs/train -> runs/train2, train3, ... when the path exists."""
    path = Path(path)
    if path.exists() and not exist_ok:
        base, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = Path(f"{base}{sep}{n}{suffix}")
            if not p.exists():
                path = p
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path
