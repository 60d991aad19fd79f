"""The port's `tamtr_torch/hub.py` against a fake in-process HTTP server:
the JAX package's protocol cases (`tests/test_hub.py`) — heartbeat posts,
metric uploads, checkpoint upload, smart_request's 408/500
exponential-backoff retry (reference `hub/utils.py:92-148`), the auth
header, the server vanishing mid-train — and the local backend's session
(`tests/test_utils.py:test_hub_session`), then one case for each fault of
the JAX module that the port does not copy: a batch whose upload failed
stays queued and goes with the next one, and `smart_request` neither sleeps
after its last attempt nor lets one hung connection spend the whole
budget.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tamtr_torch.hub import Auth, HTTPBackend, LocalBackend, TrainingSession, attach_to_callbacks, smart_request


class _FakeHub(BaseHTTPRequestHandler):
    store = None  # dict injected per-test

    def do_POST(self):
        st = self.store
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        st["requests"].append(
            {"path": self.path, "len": len(body),
             "auth": self.headers.get("x-api-key"),
             "headers": dict(self.headers)}
        )
        if st.get("hang_remaining", 0) > 0:  # programmable hang: hold the first N requests unanswered
            st["hang_remaining"] -= 1
            time.sleep(st["hang_s"])
            return
        # programmable failure: fail the first N requests with `code`
        if st["fail_remaining"] > 0:
            st["fail_remaining"] -= 1
            self.send_response(st["fail_code"])
            self.end_headers()
            self.wfile.write(b"{}")
            return
        if self.path.endswith("/metrics"):
            st["metrics"].append(json.loads(body))
        elif self.path.endswith("/upload"):
            st["uploads"].append(
                {"len": len(body), "epoch": self.headers.get("X-Epoch"),
                 "best": self.headers.get("X-Is-Best")}
            )
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b'{"ok": true}')

    def log_message(self, *a):
        pass


@pytest.fixture()
def fake_hub():
    store = {"requests": [], "metrics": [], "uploads": [],
             "fail_remaining": 0, "fail_code": 500}
    handler = type("H", (_FakeHub,), {"store": store})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    yield url, store, srv
    srv.shutdown()


def test_http_backend_full_protocol(fake_hub, tmp_path):
    url, store, _ = fake_hub
    be = HTTPBackend(url, api_key="k123", retry=1, timeout=5)
    sess = TrainingSession("exp1", auth=Auth("k123"), backend=be,
                           heartbeat_interval=0.2)
    sess.start_heartbeat()
    sess.upload_metrics(0, {"loss": 1.5})
    sess.upload_metrics(1, {"loss": 1.2})
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "weights.bin").write_bytes(b"x" * 512)
    sess.upload_model(1, str(ckpt), is_best=True)
    time.sleep(0.5)
    sess.stop()
    paths = [r["path"] for r in store["requests"]]
    assert any("/v1/agent/exp1/heartbeat" in p for p in paths)
    assert [m["step"] for m in store["metrics"]] == [0, 1]
    assert store["metrics"][1]["metrics"]["loss"] == 1.2
    assert len(store["uploads"]) == 1 and int(store["uploads"][0]["len"]) > 500
    assert store["uploads"][0]["best"] == "true"
    assert all(r["auth"] == "k123" for r in store["requests"])


def test_smart_request_retries_500_then_succeeds(fake_hub):
    url, store, _ = fake_hub
    store["fail_remaining"], store["fail_code"] = 2, 500
    t0 = time.time()
    status, body = smart_request("post", f"{url}/v1/models/m/metrics",
                                 data=b"{}", retry=3, timeout=20)
    assert status == 200
    assert len(store["requests"]) == 3  # 2 failures + 1 success
    assert time.time() - t0 >= 2.9  # exponential backoff 2**0 + 2**1


def test_smart_request_no_retry_on_4xx(fake_hub):
    url, store, _ = fake_hub
    store["fail_remaining"], store["fail_code"] = 5, 403
    status, _ = smart_request("post", f"{url}/x", data=b"{}", retry=3, timeout=10)
    assert status == 403
    assert len(store["requests"]) == 1  # non-retryable: exactly one attempt


def test_session_survives_server_vanishing(fake_hub, tmp_path):
    """The negative path: the hub dies mid-train; heartbeat/uploads keep
    failing silently and the session (i.e. training) continues."""
    url, store, srv = fake_hub
    be = HTTPBackend(url, retry=0, timeout=1)
    sess = TrainingSession("exp2", backend=be, heartbeat_interval=0.1)
    sess.start_heartbeat()
    sess.upload_metrics(0, {"loss": 9.0})
    time.sleep(0.3)
    srv.shutdown()  # the server vanishes
    sess.upload_metrics(1, {"loss": 8.0})  # must not raise
    sess.upload_model(1, str(tmp_path / "missing"), is_best=False)  # must not raise
    time.sleep(0.3)  # heartbeat thread keeps running into the dead server
    assert sess.alive
    sess.stop()  # clean stop against a dead server must not raise
    assert [m["step"] for m in store["metrics"]] == [0]


def test_hub_session(tmp_path):
    """Local-backend session: heartbeat file, metric log, checkpoint copy."""
    backend = LocalBackend(root=str(tmp_path))
    s = TrainingSession("exp1", auth=Auth("k"), backend=backend, heartbeat_interval=0.1)
    s.start_heartbeat()
    time.sleep(0.3)
    s.upload_metrics(1, {"loss": 0.5})
    s.upload_metrics(2, {"loss": 0.4})
    ckpt = tmp_path / "ck.pt"
    ckpt.write_bytes(b"x")
    s.upload_model(3, str(ckpt), is_best=True)
    s.stop()
    status = json.loads((tmp_path / "exp1" / "status.json").read_text())
    assert status["alive"] is False
    lines = (tmp_path / "exp1" / "metrics.jsonl").read_text().strip().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2] and not s.metrics_queue
    assert (tmp_path / "exp1" / "weights" / "best.pt").exists()
    assert Auth("").authenticated is False


def test_failed_metric_batch_stays_queued(fake_hub):
    """The JAX module clears its queue although `HTTPBackend` reports a
    failed upload by returning False: the port keeps the failed step (and
    the later ones) and sends them, in order, with the next batch."""
    url, store, _ = fake_hub
    sess = TrainingSession("exp3", backend=HTTPBackend(url, retry=0, timeout=5))
    store["fail_remaining"], store["fail_code"] = 1, 503
    sess.upload_metrics(0, {"loss": 3.0})
    assert store["metrics"] == [] and list(sess.metrics_queue) == [0]
    sess.upload_metrics(1, {"loss": 2.0})
    assert [m["step"] for m in store["metrics"]] == [0, 1] and not sess.metrics_queue

    class Raising:
        def upload_metrics(self, *a):
            raise ConnectionError("down")

    sess.backend = Raising()
    sess.upload_metrics(2, {"loss": 1.0})  # must not raise
    assert list(sess.metrics_queue) == [2]


def test_smart_request_does_not_sleep_after_its_last_attempt(fake_hub):
    url, store, _ = fake_hub
    store["fail_remaining"], store["fail_code"] = 5, 500
    t0 = time.time()
    status, _ = smart_request("post", f"{url}/x", data=b"{}", retry=1, timeout=20)
    elapsed = time.time() - t0
    assert status == 500 and len(store["requests"]) == 2
    assert 0.9 <= elapsed < 1.9  # one backoff (2**0) between the two attempts, none after the last (JAX: 1 + 2 s)


def test_smart_request_gives_each_attempt_its_share(fake_hub):
    """A connection that hangs takes its attempt's share of the budget
    (here 6 s over 2 attempts), not the whole: the retry gets through."""
    url, store, _ = fake_hub
    store["hang_remaining"], store["hang_s"] = 1, 8.0
    t0 = time.time()
    status, _ = smart_request("post", f"{url}/v1/models/m/metrics", data=b"{}", retry=1, timeout=6)
    assert status == 200 and len(store["requests"]) == 2
    assert time.time() - t0 < 5.5


def test_attach_to_callbacks():
    """The session on the engine's event registry: epoch metrics uploaded,
    each checkpoint save uploaded, the train end stops the heartbeat."""
    from tamtr_torch.utils.callbacks import Callbacks

    class Recording:
        def __init__(self):
            self.calls = []

        def heartbeat(self, model_id, payload):
            self.calls.append(("heartbeat", payload["alive"]))

        def upload_metrics(self, model_id, step, metrics):
            self.calls.append(("metrics", step, metrics))

        def upload_model(self, model_id, epoch, ckpt_path, is_best, final):
            self.calls.append(("model", epoch, ckpt_path, is_best))

    be = Recording()
    cb = Callbacks()
    attach_to_callbacks(TrainingSession("exp4", backend=be), cb)
    cb.fire("on_fit_epoch_end", None, 0, {"loss": np.float32(1.5), "epoch": 1})
    cb.fire("on_model_save", None, 0, "runs/w/last.pt", True)
    cb.fire("on_train_end", None, {}, "runs")
    assert be.calls == [("metrics", 0, {"loss": 1.5, "epoch": 1.0}), ("model", 0, "runs/w/last.pt", True),
                        ("heartbeat", False)]
