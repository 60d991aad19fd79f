"""The port's downloads (`tamtr_torch/utils/downloads.py`), every case of
`tests/test_downloads.py` on the port's functions, offline through
`file://` URLs and local zips; `Engine.load` of a bare asset name that
cannot be reached raises HUBModelError, one fetched that is no torch
archive raises the reference reader's error naming the file, and a
reference checkpoint fetched from the release URL loads."""

import sys
import zipfile
from pathlib import Path

import pytest
import torch

from tamtr_torch.utils.downloads import (
    attempt_download_asset,
    check_disk_space,
    download,
    is_url,
    safe_download,
    unzip_file,
    zip_directory,
)


def test_is_url():
    assert is_url("https://example.com/x.zip")
    assert is_url("file:///tmp/x.zip")
    assert not is_url("not a url")
    assert not is_url("/plain/path.zip")


def test_zip_roundtrip_one_dir(tmp_path):
    src = tmp_path / "pack"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("alpha")
    (src / "sub" / "b.txt").write_text("beta")
    z = zip_directory(src)
    assert z == tmp_path / "pack.zip" and z.exists()
    out_root = tmp_path / "out"
    out_root.mkdir()
    target = unzip_file(z, path=out_root)
    assert target == out_root / "pack"
    assert (target / "a.txt").read_text() == "alpha"
    assert (target / "sub" / "b.txt").read_text() == "beta"


def test_unzip_flat_archive_gets_folder(tmp_path):
    z = tmp_path / "flat.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("x.txt", "x")
        zf.writestr("y.txt", "y")
    target = unzip_file(z)
    assert target == tmp_path / "flat"
    assert (target / "x.txt").exists() and (target / "y.txt").exists()


def test_unzip_rejects_traversal(tmp_path):
    z = tmp_path / "evil.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("../escape.txt", "boom")
    with pytest.raises(ValueError, match="unsafe"):
        unzip_file(z)


def test_unzip_exist_ok_skips(tmp_path):
    z = tmp_path / "p.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("p/data.txt", "v1")
    t1 = unzip_file(z)
    (t1 / "data.txt").write_text("edited")
    t2 = unzip_file(z)  # exist_ok=False: must not clobber
    assert (t2 / "data.txt").read_text() == "edited"
    unzip_file(z, exist_ok=True)
    assert (t2 / "data.txt").read_text() == "v1"


def test_safe_download_file_url(tmp_path):
    src = tmp_path / "weights.bin"
    src.write_bytes(b"\x01" * 1024)
    out = safe_download(src.as_uri(), dir=tmp_path / "dl")
    assert out == tmp_path / "dl" / "weights.bin"
    assert out.read_bytes() == src.read_bytes()
    # idempotent: second call keeps the existing file
    out2 = safe_download(src.as_uri(), dir=tmp_path / "dl")
    assert out2 == out


def test_safe_download_unzips(tmp_path):
    d = tmp_path / "ds"
    (d / "images").mkdir(parents=True)
    (d / "images" / "a.jpg").write_bytes(b"JPG")
    z = zip_directory(d)
    out = safe_download(z.as_uri(), dir=tmp_path / "dl", unzip=True, delete=False)
    assert out == tmp_path / "dl" / "ds"
    assert (out / "images" / "a.jpg").exists()


def test_safe_download_retries_and_raises(tmp_path):
    with pytest.raises(ConnectionError, match="after 2 attempts"):
        safe_download((tmp_path / "missing.bin").as_uri(), dir=tmp_path, retry=2)


def test_download_multi_threaded(tmp_path):
    srcs = []
    for i in range(3):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i]) * 64)
        srcs.append(p.as_uri())
    download(srcs, dir=tmp_path / "out", threads=3, unzip=False)
    for i in range(3):
        assert (tmp_path / "out" / f"f{i}.bin").read_bytes() == bytes([i]) * 64


def test_check_disk_space(tmp_path):
    assert check_disk_space(1024, path=tmp_path)
    with pytest.raises(MemoryError):
        check_disk_space(1 << 60, path=tmp_path, hard=True)
    assert check_disk_space(1 << 60, path=tmp_path, hard=False) is False


def test_attempt_download_asset(tmp_path, monkeypatch):
    """A known asset name is fetched from the asset URL (read at the call);
    a path that exists, or an unknown name, is returned as it is."""
    import tamtr_torch.utils.downloads as dl

    release = tmp_path / "release"
    release.mkdir()
    (release / "TAM_TR.pt").write_bytes(b"\x02" * 64)
    monkeypatch.setattr(dl, "ASSETS_BASE_URL", release.as_uri())
    monkeypatch.chdir(tmp_path)
    assert attempt_download_asset("TAM_TR.pt") == "TAM_TR.pt"
    assert (tmp_path / "TAM_TR.pt").read_bytes() == b"\x02" * 64
    assert attempt_download_asset("other.pt") == "other.pt" and not (tmp_path / "other.pt").exists()


def test_engine_load_bare_asset(tmp_path, monkeypatch):
    import tamtr_torch.utils.downloads as dl
    from tamtr_torch.engine.model import Engine
    from tamtr_torch.utils.errors import HUBModelError

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dl, "ASSETS_BASE_URL", (tmp_path / "nowhere").as_uri())
    with pytest.raises(HUBModelError, match="TAM_TR.pt"):
        Engine("tamtr-nano.yaml", device="cpu").load("TAM_TR.pt")
    with pytest.raises(HUBModelError, match="check model URL"):
        raise HUBModelError()
    (tmp_path / "release").mkdir()
    (tmp_path / "release" / "TAM_TR.pt").write_bytes(b"\x02" * 64)
    monkeypatch.setattr(dl, "ASSETS_BASE_URL", (tmp_path / "release").as_uri())
    with pytest.raises(ValueError, match=r"TAM_TR\.pt: not a torch zip archive"):
        Engine("tamtr-nano.yaml", device="cpu").load("TAM_TR.pt")


def test_engine_load_fetched_reference_asset(tmp_path, monkeypatch):
    """A reference checkpoint at the release URL is fetched into the
    working directory and loaded, its classes with it."""
    import tamtr_torch.utils.downloads as dl
    from tamtr_torch.engine.model import Engine
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from make_reference_ckpt_torch import write_reference_checkpoint

    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=3)
    init_parameters(model, 0)
    write_reference_checkpoint(tmp_path / "release" / "TAM_TR.pt", model, ["car", "van", "bus"],
                               cfg_path="tamtr-nano.yaml", layout="stripped")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dl, "ASSETS_BASE_URL", (tmp_path / "release").as_uri())
    eng = Engine("tamtr-nano.yaml", device="cpu").load("TAM_TR.pt")
    assert (tmp_path / "TAM_TR.pt").read_bytes() == (tmp_path / "release" / "TAM_TR.pt").read_bytes()
    assert eng.model.nc == 3 and eng.names == ["car", "van", "bus"]
    want = model.state_dict()
    assert all(torch.equal(v, want[k].half().float()) for k, v in eng.model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
