#!/usr/bin/env python
"""Where a request to the port's HTTP server spends its time, on the card.

    python3 tools/profile_torch_serve.py [--iters 10]

The full-width `tamtr.yaml` model (nc 10, seeded weights) behind
`AutoBackend`, one 640 px float32 image and 10 text rows per request,
timed by the host clock (each call ends in a copy of pred to the host):

- `local`: the forward called in the main thread;
- `fresh_thread`: the forward called in a new thread each time, as
  `ThreadingHTTPServer` calls it (one thread per request);
- `one_thread`: the forward called in one long-lived thread;
- `http`: a `RemoteModel` request to a `ModelServer` over the model;
- `http_stub`: the same request to a server whose model returns zeros at
  once (the npz transport alone).

Prints the card's name and power limit, then one JSON line of per-call ms.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timed(fn, iters: int):
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    iters = ap.parse_args(argv).iters
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    from tamtr_torch.nn.autobackend import AutoBackend
    from tamtr_torch.serve import ModelServer, RemoteModel

    backend = AutoBackend("tamtr.yaml", nc=10, imgsz=640)
    rng = np.random.default_rng(0)
    img = rng.random((1, 640, 640, 3), dtype=np.float32)
    txt = rng.standard_normal((1, 10, 512)).astype(np.float32)
    call = lambda: backend(img, txt)  # noqa: E731
    for _ in range(3):
        call()

    def in_fresh_thread():
        t = threading.Thread(target=call)
        t.start()
        t.join()

    jobs: "queue.Queue" = queue.Queue()
    done: "queue.Queue" = queue.Queue()

    def worker():
        while jobs.get() is not None:
            done.put(call())

    w = threading.Thread(target=worker, daemon=True)
    w.start()

    def in_one_thread():
        jobs.put(1)
        done.get()

    res = {"local": timed(call, iters), "fresh_thread": timed(in_fresh_thread, iters),
           "one_thread": timed(in_one_thread, iters)}
    jobs.put(None)
    w.join(timeout=60)
    for name, model in (("http", backend), ("http_stub", lambda i, t: np.zeros((i.shape[0], 100, 14), np.float32))):
        srv = ModelServer(model).start()
        try:
            rm = RemoteModel(srv.url)
            rm(img, txt)
            res[name] = timed(lambda: rm(img, txt), iters)
        finally:
            srv.stop()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": res,
                      "median_ms": {k: float(np.median(v)) for k, v in res.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
