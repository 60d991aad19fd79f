"""Mutation-based hyperparameter evolution (a port of the JAX package's
`tamtr_tpu/engine/tuner.py`, the reference's `engine/tuner.py`).

Same strategy as the reference Tuner: per iteration, mutate the best-so-far
hyperparameters with per-key gains/bounds, run a short training, keep the
fitness-ranked history in tune_results.csv. A raising trial records
fitness 0 and evolution continues (the reference's motivation for its
subprocess-per-iteration design, `engine/tuner.py:32-224`); for isolation
from HARD crashes (OOM-killed process, runtime wedge) pass
`Engine.tune(isolate=True)`, which runs each trial in its own python
subprocess like the reference. The mutations come from numpy's
`default_rng(seed)` as in the JAX package, so one seed gives both packages
the same hyperparameter sequence and the same `tune_results.csv` for the
same trial results.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

# key: (mutation gain, min, max) — mirrors the reference search space
SPACE: Dict[str, Tuple[float, float, float]] = {
    "lr0": (1.0, 1e-5, 1e-1),
    "lrf": (1.0, 0.01, 1.0),
    "momentum": (0.3, 0.7, 0.98),
    "weight_decay": (1.0, 0.0, 0.001),
    "warmup_epochs": (1.0, 0.0, 5000.0),
    "warmup_bias_lr": (1.0, 0.0, 0.2),
    "hsv_h": (1.0, 0.0, 0.1),
    "hsv_s": (1.0, 0.0, 0.9),
    "hsv_v": (1.0, 0.0, 0.9),
    "translate": (1.0, 0.0, 0.9),
    "scale": (1.0, 0.0, 0.95),
    "fliplr": (0.5, 0.0, 1.0),
    "mosaic": (1.0, 0.0, 1.0),
    "mixup": (1.0, 0.0, 1.0),
}


class Tuner:
    def __init__(self, save_dir: str | Path = "runs/tune", seed: int = 0):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.csv = self.save_dir / "tune_results.csv"
        self.rng = np.random.default_rng(seed)

    def _mutate(self, base: Dict[str, float], sigma: float = 0.2) -> Dict[str, float]:
        out = dict(base)
        # mutate a random subset with gaussian factors (reference: v = g * randn * sigma + 1)
        keys = list(SPACE)
        n_mut = max(1, int(len(keys) * 0.5))
        for k in self.rng.choice(keys, n_mut, replace=False):
            g, lo, hi = SPACE[k]
            factor = float(np.clip(self.rng.normal(1.0, g * sigma), 0.3, 3.0))
            out[k] = float(np.clip(base.get(k, (lo + hi) / 2) * factor, lo, hi))
        return out

    def __call__(
        self,
        train_fn: Callable[[Dict[str, float]], Dict[str, float]],
        base_hyp: Optional[Dict[str, float]] = None,
        iterations: int = 10,
    ) -> Dict[str, float]:
        """train_fn(hyp) -> metrics dict with 'fitness'. Returns best hyp."""
        base = dict(base_hyp or {k: (lo + hi) / 2 for k, (g, lo, hi) in SPACE.items()})
        best_hyp, best_fit = base, -1.0
        for it in range(iterations):
            hyp = self._mutate(best_hyp) if it > 0 else base
            try:
                metrics = train_fn(hyp)
            except Exception as e:  # a failed trial must not kill evolution
                from tamtr_torch.utils.log import LOGGER

                LOGGER.warning(f"tune iteration {it} crashed ({e}); fitness=0")
                metrics = {"fitness": 0.0}
            fit = float(metrics.get("fitness", 0.0))
            row = {"iteration": it, "fitness": fit, **hyp}
            new = not self.csv.exists()
            with open(self.csv, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(row))
                if new:
                    w.writeheader()
                w.writerow(row)
            if fit > best_fit:
                best_fit, best_hyp = fit, hyp
        return best_hyp


def run_ray_tune(
    train_fn: Callable[[Dict[str, float]], Dict[str, float]],
    space: Optional[Dict[str, Any]] = None,
    grace_period: int = 10,
    max_samples: int = 10,
    metric: str = "fitness",
    max_t: int = 100,
    storage_path: Optional[str] = None,
):
    """Ray Tune hyperparameter search (reference `utils/tuner.py:9-144`).

    Gated on `ray[tune]` being installed; raises ModuleNotFoundError with the
    install hint otherwise, exactly like the reference. `train_fn(config)`
    runs one trial and returns its metrics dict (must contain `metric`);
    results are pushed to the Ray session so the ASHA scheduler can
    early-stop trials. Returns the `tune.ResultGrid`.
    """
    try:
        from ray import train as ray_train
        from ray import tune
        from ray.tune.schedulers import ASHAScheduler
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise ModuleNotFoundError(
            'tune(use_ray=True) requires Ray Tune: pip install "ray[tune]"'
        ) from e

    if space is None:
        # the reference default space (`utils/tuner.py:63-85`), minus the
        # torch-optimizer choice row
        space = {k: tune.uniform(lo, hi) for k, (_, lo, hi) in SPACE.items()}
        space.update(
            {
                "warmup_momentum": tune.uniform(0.0, 0.95),
                "degrees": tune.uniform(0.0, 45.0),
                "shear": tune.uniform(0.0, 10.0),
                "perspective": tune.uniform(0.0, 0.001),
                "flipud": tune.uniform(0.0, 1.0),
                "copy_paste": tune.uniform(0.0, 1.0),
            }
        )

    def _trial(config: Dict[str, float]) -> None:
        metrics = train_fn(config)
        ray_train.report(
            {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))}
        )

    scheduler = ASHAScheduler(
        time_attr="epoch",
        metric=metric,
        mode="max",
        max_t=max_t,
        grace_period=grace_period,
        reduction_factor=3,
    )
    kwargs = {}
    if storage_path is not None:
        try:
            from ray.air import RunConfig

            kwargs["run_config"] = RunConfig(storage_path=str(storage_path))
        except ImportError:
            pass
    tuner = tune.Tuner(
        _trial,
        param_space=space,
        tune_config=tune.TuneConfig(scheduler=scheduler, num_samples=max_samples),
        **kwargs,
    )
    return tuner.fit()
