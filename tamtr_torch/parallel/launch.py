"""One rank of `Engine.train(n_devices=N)`: `Engine._spawn` starts N of
these under `torch.distributed.run`. Each builds the engine of the spec
file given as the argument and trains with its overrides; rank 0 writes
the metrics and the run directory to the spec's `out` file.

    python -m torch.distributed.run --nproc_per_node N -m tamtr_torch.parallel.launch spec.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch.distributed as dist


def main(spec_path: str) -> None:
    from tamtr_torch.engine.model import Engine

    spec = json.loads(Path(spec_path).read_text())
    engine = Engine(spec["model_cfg"], device=spec["device"])
    metrics = engine.train(**spec["overrides"])
    if dist.get_rank() == 0:
        result = {"metrics": metrics, "run_dir": str(engine._last_run_dir)}
        Path(spec["out"]).write_text(json.dumps(result, default=float))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
