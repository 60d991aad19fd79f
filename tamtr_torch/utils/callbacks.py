"""Callback event registry and the logger integrations (a port of
`tamtr_tpu/utils/callbacks.py`; the reference's `utils/callbacks/`).

`Callbacks` holds named hooks fired at train and val lifecycle points. Each
`add_*` attaches one logging service, with the JAX package's events,
payloads and step keys, and returns False when its package is not
installed (it imports the package itself, when called). `attach_integrations`
attaches every service the settings enable (`utils/settings.py`);
`Engine.train` attaches TensorBoard under `plots` and the rest by the
settings.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, List

from tamtr_torch.utils.log import LOGGER

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


def add_tensorboard(callbacks: "Callbacks", log_dir: str) -> bool:
    """TensorBoard integration (reference `callbacks/tensorboard.py`).

    Event-complete like the reference logger set: per-epoch scalars, val
    scalars (`on_val_end`), and the final results curves image on
    `on_train_end` (reference loggers attach plots/artifacts beyond epoch
    metrics, `utils/callbacks/{tensorboard,wb}.py`)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return False
    writer = SummaryWriter(log_dir)

    def on_fit_epoch_end(engine, epoch, metrics):
        for k, v in metrics.items():
            try:
                writer.add_scalar(k, float(v), epoch)
            except (TypeError, ValueError):
                pass

    def on_val_end(engine, metrics):
        # key by the training epoch (set by the train loop) so val scalars
        # align with on_fit_epoch_end's; standalone val falls back to a
        # private counter
        step = getattr(engine, "_cur_epoch", None)
        if step is None:
            step = getattr(engine, "_tb_val_step", 0)
            engine._tb_val_step = step + 1
        for k, v in metrics.items():
            try:
                writer.add_scalar(f"val/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def on_train_end(engine, metrics=None, run_dir=None):
        if run_dir is not None:
            png = Path(run_dir) / "results.png"
            if png.exists():
                from tamtr_torch.data.image_io import imread

                img = imread(png)
                if img is not None:
                    writer.add_image("results", img[..., ::-1].copy(), dataformats="HWC")

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_val_end", on_val_end)
    callbacks.add("on_train_end", on_train_end)
    callbacks.add("teardown", lambda *a, **k: writer.close())
    return True


def add_wandb(callbacks: "Callbacks", project: str = "tamtr_torch", run_name: str = "train") -> bool:
    """Weights & Biases integration (reference `callbacks/wb.py`); gated on
    the package being installed and configured."""
    try:
        import wandb
    except ImportError:
        return False
    run = wandb.init(project=project, name=run_name, reinit=True)

    def on_fit_epoch_end(engine, epoch, metrics):
        run.log({k: v for k, v in metrics.items() if isinstance(v, (int, float))}, step=epoch)

    def on_model_save(engine, epoch, path, is_best):
        # checkpoint artifact upload (reference `callbacks/wb.py` on_model_save)
        try:
            run.save(str(path), policy="now")
        except Exception as e:  # a logging service never stops training
            LOGGER.warning(f"logger integration: {e!r}")

    def on_val_end(engine, metrics):
        # explicit step=epoch: auto-incremented steps interleaved with the
        # step=epoch logs of on_fit_epoch_end violate wandb's monotonic-step
        # requirement and drop the epoch logs
        payload = {f"val/{k}": v for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        epoch = getattr(engine, "_cur_epoch", None)
        run.log(payload, step=epoch) if epoch is not None else run.log(payload)

    def on_train_end(engine, metrics=None, run_dir=None):
        # final metrics summary + results curves image (reference wb.py)
        if metrics:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    run.summary[k] = v
        if run_dir is not None:
            png = Path(run_dir) / "results.png"
            if png.exists():
                try:
                    run.log({"results": wandb.Image(str(png))})
                except Exception as e:  # a logging service never stops training
                    LOGGER.warning(f"logger integration: {e!r}")
        run.finish()

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_model_save", on_model_save)
    callbacks.add("on_val_end", on_val_end)
    callbacks.add("on_train_end", on_train_end)
    return True


def add_mlflow(callbacks: "Callbacks", experiment: str = "tamtr_torch") -> bool:
    """MLflow integration (reference `callbacks/mlflow.py`); gated."""
    try:
        import mlflow
    except ImportError:
        return False
    mlflow.set_experiment(experiment)
    mlflow.start_run()

    def on_fit_epoch_end(engine, epoch, metrics):
        mlflow.log_metrics(
            {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))},
            step=epoch,
        )

    def on_model_save(engine, epoch, path, is_best):
        # checkpoint directory artifact (reference `callbacks/mlflow.py`
        # logs weights on train end; we mirror the richer wb.py cadence)
        try:
            mlflow.log_artifacts(str(path), artifact_path="weights")
        except Exception as e:  # a logging service never stops training
            LOGGER.warning(f"logger integration: {e!r}")

    def on_val_end(engine, metrics):
        try:
            mlflow.log_metrics(
                {f"val_{k}": float(v) for k, v in metrics.items()
                 if isinstance(v, (int, float))}
            )
        except Exception as e:  # a logging service never stops training
            LOGGER.warning(f"logger integration: {e!r}")

    def on_train_end(engine, metrics=None, run_dir=None):
        if run_dir is not None:
            png = Path(run_dir) / "results.png"
            if png.exists():
                try:
                    mlflow.log_artifact(str(png))
                except Exception as e:  # a logging service never stops training
                    LOGGER.warning(f"logger integration: {e!r}")
        mlflow.end_run()

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_model_save", on_model_save)
    callbacks.add("on_val_end", on_val_end)
    callbacks.add("on_train_end", on_train_end)
    return True


def add_csv_logger(callbacks: "Callbacks", path) -> bool:
    """Standalone CSV logger (the reference's results.csv is built into the
    trainer; this registers an extra sink via the event seam)."""
    import csv

    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)

    def on_fit_epoch_end(engine, epoch, metrics):
        exists = p.exists()
        with open(p, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["epoch"] + sorted(metrics))
            if not exists:
                w.writeheader()
            w.writerow({"epoch": epoch, **{k: metrics[k] for k in sorted(metrics)}})

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    return True


def add_comet(callbacks: "Callbacks", project: str = "tamtr_torch") -> bool:
    """Comet ML integration (reference `callbacks/comet.py`); gated."""
    try:
        import comet_ml
    except ImportError:
        return False
    exp = comet_ml.Experiment(project_name=project)

    def on_fit_epoch_end(engine, epoch, metrics):
        exp.log_metrics(
            {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))},
            epoch=epoch,
        )

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_train_end", lambda *a, **k: exp.end())
    return True


def add_clearml(callbacks: "Callbacks", project: str = "tamtr_torch", task_name: str = "train") -> bool:
    """ClearML integration (reference `callbacks/clearml.py`); gated."""
    try:
        from clearml import Task
    except ImportError:
        return False
    task = Task.init(project_name=project, task_name=task_name)
    logger = task.get_logger()

    def on_fit_epoch_end(engine, epoch, metrics):
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                logger.report_scalar("train", k, float(v), iteration=epoch)

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_train_end", lambda *a, **k: task.close())
    return True


def add_neptune(callbacks: "Callbacks", project: str = "tamtr_torch") -> bool:
    """Neptune integration (reference `callbacks/neptune.py`); gated."""
    try:
        import neptune
    except ImportError:
        return False
    run = neptune.init_run(project=project)

    def on_fit_epoch_end(engine, epoch, metrics):
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                run[f"train/{k}"].append(float(v), step=epoch)

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_train_end", lambda *a, **k: run.stop())
    return True


def add_dvc(callbacks: "Callbacks") -> bool:
    """DVCLive integration (reference `callbacks/dvc.py`); gated."""
    try:
        from dvclive import Live
    except ImportError:
        return False
    live = Live(save_dvc_exp=True)

    def on_fit_epoch_end(engine, epoch, metrics):
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                live.log_metric(k, float(v))
        live.next_step()

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_train_end", lambda *a, **k: live.end())
    return True


def add_raytune(callbacks: "Callbacks") -> bool:
    """Ray Tune session reporting (reference `callbacks/raytune.py`): pushes
    per-epoch metrics to an active tune session so schedulers (ASHA, PBT)
    can early-stop trials; gated on ray being installed AND a session being
    active."""
    try:
        from ray import train as ray_train
        from ray.tune import is_session_enabled  # ray<2.7 fallback handled below
    except ImportError:
        try:
            from ray import tune as ray_train  # legacy report API

            is_session_enabled = lambda: getattr(ray_train, "is_session_enabled", lambda: False)()
        except ImportError:
            return False

    def on_fit_epoch_end(engine, epoch, metrics):
        try:
            if is_session_enabled():
                ray_train.report(
                    {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))}
                )
        except Exception as e:  # a logging service never stops training
            LOGGER.warning(f"logger integration: {e!r}")

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    return True


DEFAULT_INTEGRATIONS = {
    "tensorboard": add_tensorboard,
    "wandb": add_wandb,
    "mlflow": add_mlflow,
    "csv": add_csv_logger,
    "comet": add_comet,
    "clearml": add_clearml,
    "neptune": add_neptune,
    "dvc": add_dvc,
    "raytune": add_raytune,
}


def attach_integrations(callbacks: "Callbacks", run_dir, settings=None) -> list:
    """Attach every integration that is (a) enabled in the persistent
    SETTINGS (reference gates callbacks on `settings.yaml` flags,
    `utils/callbacks/*.py`) and (b) actually installed. Returns the names
    that attached. TensorBoard logs under `<run_dir>/tb`; the rest use
    their service defaults."""
    if settings is None:
        from tamtr_torch.utils.settings import SettingsManager

        settings = SettingsManager()

    attached = []
    for name, add in DEFAULT_INTEGRATIONS.items():
        if name == "csv" or not settings.get(name, False):
            continue  # csv is built into the trainer's results.csv
        try:
            ok = (
                add(callbacks, str(run_dir / "tb"))
                if name == "tensorboard"
                else add(callbacks)
            )
        except Exception as e:  # a misconfigured service never blocks training
            LOGGER.warning(f"logger integration {name} not attached: {e!r}")
            ok = False
        if ok:
            attached.append(name)
    return attached
