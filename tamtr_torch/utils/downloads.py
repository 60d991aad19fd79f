"""Downloads and archives (a port of `tamtr_tpu/utils/downloads.py`, the
reference's `utils/downloads.py`), on `urllib` and `zipfile`.

    is_url                  a string that parses as a URL (check=True opens it)
    zip_directory           a directory's files into `<directory>.zip`
    unzip_file              an archive into a directory; refuses member
                            paths that leave it
    check_disk_space        whether a download fits on the filesystem
    safe_download           one URL (http(s):// or file://) to a file, with
                            retries, a size check and an optional unzip
    attempt_download_asset  a bare release asset name to a local file
    download                several URLs, optionally on threads

A failed fetch raises ConnectionError naming the URL after its retries.
The defaults that JAX's module reads once at import (the working directory,
the asset URL) are read here at each call.
"""

from __future__ import annotations

import shutil
import zipfile
from pathlib import Path
from typing import Iterable, Optional, Sequence, Union
from urllib import parse, request

from tamtr_torch.utils.log import LOGGER

# the project's release assets: attempt_download_asset fetches `{base}/{name}`
ASSETS_BASE_URL = "https://github.com/Xjh-UCAS/TAM-TR/releases/download/v0.0.0"
ASSETS_NAMES = ["TAM_TR.pt"]
EXCLUDE_MEMBERS = (".DS_Store", "__MACOSX")


def is_url(url, check: bool = False) -> bool:
    """True if the string parses as a URL; check=True also opens it."""
    try:
        result = parse.urlparse(str(url))
        ok = all([result.scheme, result.netloc or result.scheme == "file"])
        if ok and check:
            with request.urlopen(str(url)) as r:  # noqa: S310 (the caller's URL)
                return r.getcode() == 200 if hasattr(r, "getcode") else True
        return ok
    except (ValueError, OSError):
        return False


def zip_directory(directory, compress: bool = True, exclude: Sequence[str] = EXCLUDE_MEMBERS) -> Path:
    """Zip a directory's files, under its own name, into `<directory>.zip`
    beside it."""
    directory = Path(directory)
    if not directory.is_dir():
        raise NotADirectoryError(f"not a directory: {directory}")
    files = [f for f in directory.rglob("*") if f.is_file() and not any(x in f.parts for x in exclude)]
    zip_path = directory.with_suffix(".zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED) as zf:
        for f in files:
            zf.write(f, f.relative_to(directory.parent))
    return zip_path


def unzip_file(file, path=None, exclude: Sequence[str] = EXCLUDE_MEMBERS, exist_ok: bool = False) -> Path:
    """Unzip into `path` (default: beside the archive). An archive whose
    members all sit in one directory extracts as it is; a flat one into a
    directory named after the archive. A member path that is absolute or
    climbs out with `..` raises ValueError. With exist_ok=False a target
    that holds files is left as it is."""
    file = Path(file)
    path = Path(path or file.parent)
    with zipfile.ZipFile(file) as zf:
        names = [n for n in zf.namelist() if not any(x in n for x in exclude)]
        for n in names:
            if n.startswith("/") or ".." in Path(n).parts:
                raise ValueError(f"unsafe zip member path: {n}")
        tops = {Path(n).parts[0] for n in names if Path(n).parts}
        if len(tops) == 1 and all("/" in n or n.endswith("/") for n in names):
            extract_to, target = path, path / next(iter(tops))
        else:
            extract_to = target = path / file.stem
        if target.exists() and any(target.iterdir()) and not exist_ok:
            LOGGER.info(f"skipping unzip: {target} already exists (exist_ok=False)")
            return target
        for n in names:
            zf.extract(n, extract_to)
    return target


def check_disk_space(required_bytes: int, path=None, sf: float = 1.5, hard: bool = True) -> bool:
    """True if `sf * required_bytes` fits on the filesystem of `path` (the
    working directory by default); else MemoryError, or False with
    hard=False."""
    path = Path.cwd() if path is None else path
    free = shutil.disk_usage(path).free
    if required_bytes * sf < free:
        return True
    msg = (f"insufficient disk space: need {required_bytes * sf / 2**30:.1f} GiB (x{sf} safety), "
           f"have {free / 2**30:.1f} GiB free on {path}")
    if hard:
        raise MemoryError(msg)
    LOGGER.warning(msg)
    return False


def safe_download(url: str, file=None, dir=None, unzip: bool = True, delete: bool = False, retry: int = 3,
                  min_bytes: float = 1.0, exist_ok: bool = False) -> Path:
    """Fetch `url` to `dir/file` (file: the URL's basename by default; a
    `file` without `dir` is the path itself) unless that file exists,
    trying `retry` times; a download of `min_bytes` or less counts as a
    failure. A `.zip` is unzipped beside it (and deleted with delete=True),
    and the unzipped directory returned. ConnectionError after the last
    failed attempt."""
    name = Path(parse.unquote(str(url))).name.split("?")[0]
    f = Path(file) if file is not None and dir is None else Path(dir or ".") / (file or name)
    f.parent.mkdir(parents=True, exist_ok=True)
    if not f.exists():
        last_err: Optional[Exception] = None
        for attempt in range(retry):
            try:
                request.urlretrieve(str(url), str(f))  # noqa: S310 (the caller's URL)
                if f.stat().st_size > min_bytes:
                    break
                f.unlink(missing_ok=True)
                last_err = ValueError(f"downloaded file too small (<{min_bytes}B)")
            except (OSError, ValueError) as e:  # URLError is an OSError
                last_err = e
            LOGGER.warning(f"download attempt {attempt + 1}/{retry} failed for {url}: {last_err}")
        else:
            raise ConnectionError(f"failed to download {url} after {retry} attempts: {last_err}") from last_err
    if unzip and f.suffix == ".zip":
        out = unzip_file(f, path=f.parent, exist_ok=exist_ok)
        if delete:
            f.unlink(missing_ok=True)
        return out
    return f


def attempt_download_asset(file, base_url: Optional[str] = None) -> str:
    """A known asset name that is not a file here is fetched from
    `base_url` (`ASSETS_BASE_URL` by default) to that path; any other path
    is returned as it is."""
    file = str(file)
    p = Path(file)
    if not p.exists() and p.name in ASSETS_NAMES:
        safe_download(f"{base_url or ASSETS_BASE_URL}/{p.name}", file=p, unzip=False)
    return file


def download(urls: Union[str, Iterable[str]], dir=None, unzip: bool = True, delete: bool = False,
             threads: int = 1, retry: int = 3) -> None:
    """`safe_download` of each URL into `dir` (the working directory by
    default), on `threads` threads."""
    dir = Path.cwd() if dir is None else Path(dir)
    dir.mkdir(parents=True, exist_ok=True)
    url_list = [urls] if isinstance(urls, str) else list(urls)

    def one(u):
        return safe_download(u, dir=dir, unzip=unzip, delete=delete, retry=retry)

    if threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(one, url_list))
    else:
        for u in url_list:
            one(u)
