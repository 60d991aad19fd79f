"""Training-session tracking — the reference HUB's capability surface (a
port of the JAX package's `tamtr_tpu/hub.py`).

The reference `ultralytics/hub/` couples training to a cloud service: auth
(`hub/auth.py:11`), a `HUBTrainingSession` with a heartbeat thread and
metric/checkpoint upload queues (`hub/session.py:17-110`), and `Events`
telemetry (`hub/utils.py:149`). This rebuild keeps the same session
life-cycle and API but writes to a pluggable backend; the default backend is
the local filesystem (this deployment environment has no egress), and a
custom backend object can forward the same calls to any service.

API parity:
    session = TrainingSession(model_id="exp1")
    session.start_heartbeat()
    session.upload_metrics(step, {"loss": ...})
    session.upload_model(epoch, ckpt_path, is_best=..., final=...)
    session.stop()

Two faults of the JAX package's module are not ported:
`TrainingSession.upload_metrics` keeps every step whose upload failed,
whether the backend raised or returned False (`HTTPBackend` signals a
failure by returning False), and sends it again with the next batch; and
`smart_request` gives each attempt its share of the time budget that is
left, so that a hung connection cannot spend it all, and does not sleep
after its last attempt.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional


class Auth:
    """API-key holder (reference `hub/auth.py`). Local backend: format check only."""

    def __init__(self, api_key: str = "") -> None:
        self.api_key = api_key

    @property
    def authenticated(self) -> bool:
        # reference keys are "<42 chars>_<id>"; accept any non-empty key here
        return bool(self.api_key)

    def get_auth_header(self) -> Optional[Dict[str, str]]:
        return {"x-api-key": self.api_key} if self.authenticated else None


class LocalBackend:
    """Filesystem backend: sessions live under <root>/<model_id>/."""

    def __init__(self, root: str = "runs/hub") -> None:
        self.root = Path(root)

    def heartbeat(self, model_id: str, payload: Dict[str, Any]) -> None:
        d = self.root / model_id
        d.mkdir(parents=True, exist_ok=True)
        (d / "status.json").write_text(json.dumps(payload))

    def upload_metrics(self, model_id: str, step: int, metrics: Dict[str, Any]) -> None:
        d = self.root / model_id
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "metrics.jsonl", "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")

    def upload_model(
        self, model_id: str, epoch: int, ckpt_path: str, is_best: bool, final: bool
    ) -> None:
        d = self.root / model_id / "weights"
        d.mkdir(parents=True, exist_ok=True)
        src = Path(ckpt_path)
        name = "final" if final else ("best" if is_best else f"epoch{epoch}")
        dst = d / name
        if src.is_dir():
            if dst.exists():
                shutil.rmtree(dst)
            shutil.copytree(src, dst)
        elif src.exists():
            shutil.copy2(src, dst.with_suffix(src.suffix))


def smart_request(
    method: str,
    url: str,
    data: Optional[bytes] = None,
    headers: Optional[Dict[str, str]] = None,
    retry: int = 3,
    timeout: float = 30.0,
):
    """HTTP request with the reference's retry semantics
    (`hub/utils.py:92-148` smart_request): retry ONLY on 408/500 with
    exponential backoff (2**i), bounded by a total `timeout`; any other
    status returns immediately. Each attempt may take its share of the
    budget that is left (that budget over the attempts left), and no
    backoff follows the last attempt. Returns (status_code, body_bytes) or
    (None, b"") when the connection itself failed on every attempt.
    """
    import urllib.error
    import urllib.request

    retry_codes = (408, 500)
    t0 = time.time()
    status, body = None, b""
    for i in range(retry + 1):
        left = timeout - (time.time() - t0)
        if left <= 0:
            break
        req = urllib.request.Request(
            url, data=data, headers=headers or {},
            method=method.upper(),
        )
        try:
            with urllib.request.urlopen(req, timeout=left / (retry + 1 - i)) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
            if status not in retry_codes:
                return status, body
        except (urllib.error.URLError, OSError, ConnectionError):
            status, body = None, b""
        if i < retry:
            time.sleep(max(min(2**i, timeout - (time.time() - t0)), 0.0))
    return status, body


class HTTPBackend:
    """Cloud-protocol backend: the reference `HUBTrainingSession`'s wire
    shape (heartbeat posts, metric-queue posts, checkpoint upload with
    retry via `smart_request`) against any HTTP service. The endpoint
    layout is this package's own (the reference's service protocol is
    proprietary); a fake-server test drives every path including the
    server-vanishes-mid-train negative case (tests/test_hub.py).

    Failures never propagate into the training loop: each call returns
    False on failure and the session keeps training (reference behavior —
    its uploads run in fire-and-forget daemon threads).
    """

    def __init__(self, base_url: str, api_key: str = "", retry: int = 3,
                 timeout: float = 10.0) -> None:
        self.base = base_url.rstrip("/")
        self.auth = Auth(api_key)
        self.retry = retry
        self.timeout = timeout

    def _post_json(self, path: str, payload: Dict[str, Any]) -> bool:
        headers = {"Content-Type": "application/json"}
        headers.update(self.auth.get_auth_header() or {})
        status, _ = smart_request(
            "post", f"{self.base}{path}", data=json.dumps(payload).encode(),
            headers=headers, retry=self.retry, timeout=self.timeout,
        )
        return status is not None and status < 300

    def heartbeat(self, model_id: str, payload: Dict[str, Any]) -> bool:
        return self._post_json(f"/v1/agent/{model_id}/heartbeat", payload)

    def upload_metrics(self, model_id: str, step: int, metrics: Dict[str, Any]) -> bool:
        return self._post_json(
            f"/v1/models/{model_id}/metrics", {"step": step, "metrics": metrics}
        )

    def upload_model(
        self, model_id: str, epoch: int, ckpt_path: str, is_best: bool, final: bool
    ) -> bool:
        p = Path(ckpt_path)
        if p.is_dir():  # orbax checkpoints are directories: ship a zip
            import io
            import zipfile

            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w") as z:
                for f in sorted(p.rglob("*")):
                    if f.is_file():
                        z.write(f, f.relative_to(p))
            blob = buf.getvalue()
        elif p.exists():
            blob = p.read_bytes()
        else:
            return False
        headers = {
            "Content-Type": "application/octet-stream",
            "X-Epoch": str(epoch),
            "X-Is-Best": str(bool(is_best)).lower(),
            "X-Final": str(bool(final)).lower(),
        }
        headers.update(self.auth.get_auth_header() or {})
        status, _ = smart_request(
            "post", f"{self.base}/v1/models/{model_id}/upload", data=blob,
            headers=headers, retry=self.retry, timeout=self.timeout,
        )
        return status is not None and status < 300


class TrainingSession:
    """Session with heartbeat + upload queue (reference `hub/session.py:17`)."""

    def __init__(
        self,
        model_id: str,
        auth: Optional[Auth] = None,
        backend: Any = None,
        heartbeat_interval: float = 30.0,
    ) -> None:
        self.model_id = model_id
        self.auth = auth or Auth("local")
        self.backend = backend or LocalBackend()
        self.heartbeat_interval = heartbeat_interval
        self.alive = False
        self._t0 = time.time()
        self._thread: Optional[threading.Thread] = None
        self.metrics_queue: Dict[int, Dict[str, Any]] = {}

    # -------------------------------------------------------------- lifecycle
    def start_heartbeat(self) -> None:
        self.alive = True
        self._thread = threading.Thread(target=self._heartbeat_loop, daemon=True)
        self._thread.start()

    def _heartbeat_loop(self) -> None:
        while self.alive:
            try:
                self.backend.heartbeat(
                    self.model_id,
                    {"alive": True, "uptime_s": round(time.time() - self._t0, 1),
                     "ts": time.time()},
                )
            except Exception:
                pass  # a vanished backend must never kill the heartbeat thread
            # small sleep steps so stop() is prompt
            for _ in range(int(self.heartbeat_interval * 10)):
                if not self.alive:
                    break
                time.sleep(0.1)

    def stop(self) -> None:
        self.alive = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        try:
            self.backend.heartbeat(
                self.model_id,
                {"alive": False, "uptime_s": round(time.time() - self._t0, 1)},
            )
        except Exception:
            pass

    # ---------------------------------------------------------------- uploads
    def upload_metrics(self, step: int, metrics: Dict[str, Any]) -> None:
        """Queue + flush metrics (the reference batches via a queue dict):
        the queued steps go in order, each leaving the queue once the
        backend took it; at the first that fails (the backend raised or
        returned False) it and the later ones stay queued, to go with the
        next batch (the reference's uploads are fire-and-forget daemon
        threads: a failure never reaches training)."""
        self.metrics_queue[step] = metrics
        for s, m in sorted(self.metrics_queue.items()):
            try:
                ok = self.backend.upload_metrics(self.model_id, s, m)
            except Exception:
                ok = False
            if ok is False:
                return
            del self.metrics_queue[s]

    def upload_model(
        self, epoch: int, ckpt_path: str, is_best: bool = False, final: bool = False
    ) -> None:
        try:
            self.backend.upload_model(self.model_id, epoch, ckpt_path, is_best, final)
        except Exception:
            pass


def attach_to_callbacks(session: TrainingSession, callbacks) -> None:
    """Register the session on the engine's event registry (the reference
    wires HUB through `utils/callbacks/hub.py`)."""

    def on_fit_epoch_end(engine, epoch, metrics):
        session.upload_metrics(epoch, {k: float(v) for k, v in metrics.items()})

    def on_model_save(engine, epoch, ckpt_path, is_best):
        session.upload_model(epoch, str(ckpt_path), is_best=is_best)

    def on_train_end(engine, *a, **k):
        session.stop()

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_model_save", on_model_save)
    callbacks.add("on_train_end", on_train_end)
