"""Model serving: an HTTP inference server and its client (a port of the
JAX package's `tamtr_tpu/serve.py`, the counterpart of the reference's
Triton serving path, `ultralytics/utils/triton.py`).

The wire format is the JAX package's: request and response bodies are
`.npz` archives of named numpy arrays.

  GET  /v1/models/<endpoint>           -> JSON metadata (inputs, outputs, nc)
  POST /v1/models/<endpoint>:infer     -> npz in ("img", "txt_feats"), npz out ("pred")

An unknown path gets 404, a body over `max_request_bytes` 413, a body the
model cannot take 400 with the error. The server binds loopback unless
given another host. `ThreadingHTTPServer` answers each request on a thread
of its own, but every call into the model is made by one long-lived model
thread, in turn: the port's kernel wrappers build their kernels and keep
per-shape launch plans on first use, so calls must not overlap, and a
thread's first CUDA work pays a setup the card's libraries keep per thread
(a batch-1 forward at 640 px: ~182 ms from a new thread against ~43-46 ms
from a warm one, `tools/profile_torch_serve.py`, `PERF.md`).
`serve_checkpoint` warms the model up on that thread before it returns.

`AutoBackend` routes `http://...` weights to `RemoteModel`.
"""

from __future__ import annotations

import io
import json
import queue
import threading
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence
from urllib.parse import urlsplit
from urllib.request import Request, urlopen

import numpy as np


def _pack_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack_npz(body: bytes) -> Dict[str, np.ndarray]:
    data = np.load(io.BytesIO(body))
    return {k: data[k] for k in data.files}


class ModelServer:
    """Serve a callable model over HTTP (threaded, one process).

    Args:
      model: callable `(img, txt_feats) -> pred` on numpy arrays: an
        `AutoBackend`, or any function with the same contract.
      endpoint: model name in the URL path.
      meta: extra metadata merged into the `/v1/models/<endpoint>` reply.
      input_names / input_dtypes: the advertised inputs (the client casts
        to these dtypes before sending, as the reference's
        `np_input_formats`).
      max_request_bytes: the largest request body taken.
    """

    def __init__(self, model: Callable[..., np.ndarray], endpoint: str = "tamtr", host: str = "127.0.0.1",
                 port: int = 0, meta: Optional[dict] = None, input_names: Sequence[str] = ("img", "txt_feats"),
                 input_dtypes: Sequence[str] = ("float32", "float32"),
                 max_request_bytes: int = 256 * 1024 * 1024) -> None:
        self.model = model
        self.endpoint = endpoint
        self.max_request_bytes = int(max_request_bytes)
        self.meta = {
            "name": endpoint,
            "inputs": [{"name": n, "dtype": d} for n, d in zip(input_names, input_dtypes)],
            "outputs": [{"name": "pred", "dtype": "float32"}],
            **(meta or {}),
        }
        self._names = list(input_names)
        self._jobs: "queue.Queue" = queue.Queue()
        self._model_thread = threading.Thread(target=self._run_jobs, daemon=True)
        self._model_thread.start()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") == f"/v1/models/{server.endpoint}":
                    self._reply(200, json.dumps(server.meta).encode(), "application/json")
                else:
                    self._reply(404, b"{}", "application/json")

            def do_POST(self):  # noqa: N802
                if self.path != f"/v1/models/{server.endpoint}:infer":
                    self._reply(404, b"{}", "application/json")
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n > server.max_request_bytes:
                    self._reply(413, json.dumps({"error": f"request {n} B exceeds cap {server.max_request_bytes} B"})
                                .encode(), "application/json")
                    return
                try:
                    arrays = _unpack_npz(self.rfile.read(n))
                    inputs = [arrays[k] for k in server._names]
                    pred = np.asarray(server.run(server.model, *inputs))
                    self._reply(200, _pack_npz({"pred": pred}), "application/octet-stream")
                except Exception as e:  # noqa: BLE001 - surface to the client
                    self._reply(400, json.dumps({"error": str(e)}).encode(), "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    def _run_jobs(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fn, args, fut = job
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn(*args))
                except Exception as e:  # noqa: BLE001 - handed to the caller, which raises it
                    fut.set_exception(e)

    def run(self, fn: Callable, *args):
        """`fn(*args)` on the model thread, after the calls queued before
        it; returns its result or raises its exception."""
        if not self._model_thread.is_alive():
            raise RuntimeError("the server is stopped")
        fut: Future = Future()
        self._jobs.put((fn, args, fut))
        return fut.result()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/{self.endpoint}"

    def start(self) -> "ModelServer":
        """Serve on a background thread."""
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self._httpd.serve_forever()

    def stop(self) -> None:
        """Stop serving (from another thread than `serve_forever`'s) and
        end the model thread."""
        if self._serving:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self._jobs.put(None)
        self._model_thread.join(timeout=60)


class RemoteModel:
    """Client of a `ModelServer` (the reference's `TritonRemoteModel` API).

    Built from one URL `<scheme>://<netloc>/<endpoint>` or from its parts;
    inputs are cast to the server's advertised dtypes; the outputs come back
    cast to the first input's dtype (the reference's behaviour).
    """

    def __init__(self, url: str, endpoint: str = "", scheme: str = "") -> None:
        if not endpoint and not scheme:
            parts = urlsplit(url)
            endpoint = parts.path.strip("/").split("/")[0]
            scheme = parts.scheme
            url = parts.netloc
        self.endpoint = endpoint
        self.url = url
        self.scheme = scheme or "http"
        if self.scheme != "http":
            raise ValueError(f"unsupported scheme {self.scheme!r}: the tamtr_torch server speaks http")
        self._base = f"http://{self.url}/v1/models/{self.endpoint}"
        with urlopen(self._base, timeout=30) as r:
            self.meta = json.loads(r.read())
        self.input_names: List[str] = [x["name"] for x in self.meta["inputs"]]
        self.np_input_formats = [np.dtype(x["dtype"]) for x in self.meta["inputs"]]
        self.output_names: List[str] = [x["name"] for x in self.meta["outputs"]]

    def __call__(self, *inputs: np.ndarray) -> List[np.ndarray]:
        out_format = inputs[0].dtype
        arrays = {name: np.asarray(x, dtype=dt) for name, dt, x in zip(self.input_names, self.np_input_formats, inputs)}
        req = Request(f"{self._base}:infer", data=_pack_npz(arrays),
                      headers={"Content-Type": "application/octet-stream"}, method="POST")
        with urlopen(req, timeout=300) as r:
            if r.status != 200:
                raise RuntimeError(f"inference failed: HTTP {r.status}")
            out = _unpack_npz(r.read())
        return [out[k].astype(out_format) for k in self.output_names]


def serve_checkpoint(weights: str, endpoint: str = "tamtr", host: str = "127.0.0.1", port: int = 8000,
                     nc: Optional[int] = None, imgsz: Optional[int] = None, device=None) -> ModelServer:
    """Load weights through `AutoBackend` (a checkpoint, a model config or
    a URL), run one warm-up forward on the server's model thread, and
    return the server, not yet serving: `.start()` serves on a background thread, `.serve_forever()`
    blocks. The server is unauthenticated and binds loopback by default;
    pass host="0.0.0.0" to expose it on every interface."""
    from tamtr_torch.nn.autobackend import AutoBackend

    backend = AutoBackend(weights, nc=nc, imgsz=imgsz, device=device)
    meta = {"nc": backend.nc, "imgsz": backend.imgsz, "backend": backend.backend, "text_width": backend.text_width,
            "names": backend.names}
    srv = ModelServer(backend, endpoint=endpoint, host=host, port=port, meta=meta)
    srv.run(backend.warmup)
    return srv
