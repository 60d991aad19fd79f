"""The port's settings, crash reports and CLI `settings` command
(`tamtr_torch/utils/settings.py`, `utils/crash.py`, `cli.py`) against the
JAX package's (`tests/test_settings.py`): files either package writes read
back equal in the other, the version reset, unknown keys, and the CLI."""

import importlib
import sys

import pytest
import yaml

from tamtr_torch.utils.settings import SettingsManager


def test_roundtrip_and_unknown_keys(tmp_path):
    f = tmp_path / "settings.yaml"
    s = SettingsManager(f)
    assert s["tensorboard"] is True and s["sync"] is False and s["uuid"] == ""
    s.update({"wandb": False, "runs_dir": str(tmp_path / "my runs: 'x' #1 é")})
    s.save()
    assert f.exists() and len(s["uuid"]) == 32
    again = SettingsManager(f)
    assert dict(again) == dict(s)
    with pytest.raises(KeyError):
        again.update({"not_a_key": 1})
    again.reset()
    assert again["wandb"] is True and yaml.safe_load(f.read_text())["wandb"] is True


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_read_back_equal_in_the_other_package(tmp_path, writer):
    """A file written by either `SettingsManager` reads back equal in the
    other, long folded strings included."""
    from tamtr_tpu.utils.settings import SettingsManager as JaxSettings

    f = tmp_path / "settings.yaml"
    make = JaxSettings if writer == "jax" else SettingsManager
    s = make(f)
    s.update({"mlflow": False, "sync": True, "datasets_dir": "/data sets/" + "long part " * 12,
              "weights_dir": "yes", "runs_dir": "0x1f: é"})
    s.save()
    other = (SettingsManager if writer == "jax" else JaxSettings)(f)
    assert dict(other) == dict(s)


def test_version_mismatch_and_other_keys_reset(tmp_path):
    f = tmp_path / "settings.yaml"
    f.write_text(yaml.safe_dump({"settings_version": "0.0.0", "wandb": False}))
    assert SettingsManager(f)["wandb"] is True
    good = dict(SettingsManager(f), wandb=False, extra=1)
    f.write_text(yaml.safe_dump(good))
    assert SettingsManager(f)["wandb"] is True


def _cli_dicts(main, capsys, argv):
    main(argv)
    out = capsys.readouterr().out
    return yaml.safe_load(out.split("settings reset to defaults\n")[-1])


def test_cli_settings_equals_jax(tmp_path, monkeypatch, capsys):
    """`settings`, `settings k=v` and `settings reset` print the dict JAX's
    CLI prints, each in its own config directory under TAMTR_CONFIG_DIR."""
    import tamtr_tpu.utils.settings as jax_settings
    from tamtr_torch.cli import main

    monkeypatch.setenv("TAMTR_CONFIG_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    importlib.reload(jax_settings)  # the JAX CLI reads its module-level SETTINGS
    from tamtr_tpu.cli import main as jax_main

    try:
        for argv in (["settings"], ["settings", "mlflow=False", "hub=true"], ["settings"], ["settings", "reset"]):
            got, want = _cli_dicts(main, capsys, argv), _cli_dicts(jax_main, capsys, argv)
            assert {k: v for k, v in got.items() if k != "uuid"} == {k: v for k, v in want.items() if k != "uuid"}
            assert bool(got["uuid"]) == bool(want["uuid"])
        assert (tmp_path / "tamtr_torch" / "settings.yaml").exists()
        with pytest.raises(KeyError):
            main(["settings", "bogus=1"])
    finally:
        monkeypatch.undo()
        importlib.reload(jax_settings)


def test_crash_report_file(tmp_path, monkeypatch):
    """The hook writes a report with the traceback and the torch device;
    KeyboardInterrupt, FileNotFoundError and out-of-memory errors write
    none and still reach the previous hook; under pytest nothing installs."""
    from tamtr_torch.utils import crash

    monkeypatch.setattr(crash, "_crash_dir", lambda: tmp_path / "reports")
    try:
        raise RuntimeError("boom for test")
    except RuntimeError:
        p = crash.write_crash_report(*sys.exc_info())
    text = p.read_text()
    assert "boom for test" in text and "Traceback" in text and "torch: " in text and "device: " in text
    calls = []
    monkeypatch.setattr(crash, "_PREV_HOOK", lambda *a: calls.append(a))
    crash._hook(KeyboardInterrupt, KeyboardInterrupt(), None)
    crash._hook(FileNotFoundError, FileNotFoundError("x"), None)
    crash._hook(RuntimeError, RuntimeError("CUDA out of memory. Tried to allocate"), None)
    assert len(list((tmp_path / "reports").glob("*.txt"))) == 1 and len(calls) == 3
    try:
        raise ValueError("real crash")
    except ValueError:
        crash._hook(*sys.exc_info())
    assert len(list((tmp_path / "reports").glob("*.txt"))) == 2
    assert crash.set_crash_reporting() is False
