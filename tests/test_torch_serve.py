"""The port's serving (`tamtr_torch/serve.py`: `ModelServer`, `RemoteModel`,
`serve_checkpoint`; `tamtr_torch/nn/autobackend.py`) on the CPU: the cases
of `tests/test_serve.py`, the wire format against the JAX package's server
and client in both directions, the 404 / 413 / 400 replies, `AutoBackend`
over a checkpoint written by the engine's checkpoint writer, and 8
concurrent requests to a nano model answered bitwise as 8 sequential
ones, every call into the model made by the server's one model thread."""

import copy
import http.client
import json
from concurrent.futures import ThreadPoolExecutor
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest
import torch

from tamtr_torch.nn.autobackend import AutoBackend
from tamtr_torch.serve import ModelServer, RemoteModel, serve_checkpoint

from torch_engine_data import HD, IMG, NC, one_thread  # noqa: F401


def _stub_model(img, txt):
    # a deterministic function of both inputs, so the round trip is checkable
    B = img.shape[0]
    pred = np.zeros((B, 5, 4 + txt.shape[1]), np.float32)
    pred[:, :, 0] = img.mean(axis=(1, 2, 3), keepdims=False)[:, None]
    pred[:, :, 4:] = txt.mean(axis=2)[:, None, :]
    return pred


@pytest.fixture(scope="module")
def server():
    srv = ModelServer(_stub_model, endpoint="stub", meta={"nc": 3}, max_request_bytes=1 << 20).start()
    yield srv
    srv.stop()


def test_remote_model_roundtrip(server):
    rm = RemoteModel(server.url)
    assert rm.endpoint == "stub"
    assert rm.input_names == ["img", "txt_feats"]
    assert rm.output_names == ["pred"]
    img = np.full((2, 8, 8, 3), 0.25, np.float64)  # wrong dtype: the client casts
    txt = np.ones((2, 3, 512), np.float32)
    (out,) = rm(img, txt)
    assert out.dtype == np.float64  # cast back to the first input's dtype
    np.testing.assert_allclose(out, _stub_model(img.astype(np.float32), txt), atol=1e-6)


def test_remote_model_explicit_parts(server):
    rm = RemoteModel(f"{server.host}:{server.port}", endpoint="stub", scheme="http")
    assert rm.meta["nc"] == 3
    with pytest.raises(ValueError):
        RemoteModel(f"{server.host}:{server.port}", endpoint="stub", scheme="grpc")


def test_autobackend_url_route(server):
    ab = AutoBackend(server.url, imgsz=8)
    assert ab.backend == "remote"
    assert ab.nc == 3  # from the server's metadata
    img = np.full((1, 8, 8, 3), 0.5, np.float32)
    txt = np.zeros((1, 3, 512), np.float32)
    np.testing.assert_allclose(ab(img, txt), _stub_model(img, txt), atol=1e-6)


def test_server_rejects_bad_requests(server):
    """400 for a body that is not an npz, 404 for other paths, 413 past
    `max_request_bytes`."""
    base = f"http://{server.host}:{server.port}/v1/models"
    with pytest.raises(HTTPError) as ei:
        urlopen(Request(f"{base}/stub:infer", data=b"not-an-npz", method="POST"), timeout=10)
    assert ei.value.code == 400 and "error" in json.loads(ei.value.read())
    for req in (Request(f"{base}/other", method="GET"), Request(f"{base}/other:infer", data=b"x", method="POST")):
        with pytest.raises(HTTPError) as ei:
            urlopen(req, timeout=10)
        assert ei.value.code == 404
    # a body past the cap is refused from its Content-Length, before it is read
    conn = http.client.HTTPConnection(server.host, server.port, timeout=10)
    try:
        conn.putrequest("POST", "/v1/models/stub:infer")
        conn.putheader("Content-Length", str((1 << 20) + 1))
        conn.endheaders()
        assert conn.getresponse().status == 413
    finally:
        conn.close()


def test_wire_format_matches_the_jax_package(server):
    """The port's client against the JAX package's server, and the JAX
    package's client against the port's server."""
    from tamtr_tpu.serve import ModelServer as JaxServer
    from tamtr_tpu.serve import RemoteModel as JaxRemote

    img = np.random.default_rng(0).random((2, 8, 8, 3), dtype=np.float32)
    txt = np.ones((2, 3, 512), np.float32)
    jsrv = JaxServer(_stub_model, endpoint="jstub").start()
    try:
        (a,) = RemoteModel(jsrv.url)(img, txt)
    finally:
        jsrv.stop()
    (b,) = JaxRemote(server.url)(img, txt)
    np.testing.assert_array_equal(a, _stub_model(img, txt))
    np.testing.assert_array_equal(b, _stub_model(img, txt))


@pytest.fixture(scope="module")
def nano():
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=NC)
    init_parameters(model, 3)
    return model.eval()


def test_concurrent_requests_answer_as_sequential_ones(nano):
    """8 requests sent at once to a server over the nano model get, bitwise,
    the replies of the same 8 sent one after another, which equal the
    in-process forward; every call into the model ran on one thread, the
    server's model thread, and none overlapped another."""
    import threading
    import time

    backend = AutoBackend(nano, device="cpu", imgsz=IMG)
    rng = np.random.default_rng(1)
    reqs = [(rng.random((1, IMG, IMG, 3), dtype=np.float32), rng.standard_normal((1, NC, HD)).astype(np.float32))
            for _ in range(8)]
    threads, busy, overlaps = set(), [False], [0]

    def model(img, txt):
        threads.add(threading.get_ident())
        overlaps[0] += busy[0]
        busy[0] = True
        time.sleep(0.01)
        try:
            return backend(img, txt)
        finally:
            busy[0] = False

    srv = ModelServer(model, meta={"nc": NC}).start()
    try:
        rm = RemoteModel(srv.url)
        seq = [rm(*r)[0] for r in reqs]
        with ThreadPoolExecutor(8) as pool:
            par = list(pool.map(lambda r: rm(*r)[0], reqs))
    finally:
        srv.stop()
    assert len(threads) == 1 and threading.get_ident() not in threads and overlaps[0] == 0
    for s, p, r in zip(seq, par, reqs):
        assert s.shape == (1, 20, 4 + NC)  # the nano head: 20 queries
        np.testing.assert_array_equal(s, p)
        np.testing.assert_array_equal(s, backend(*r))


def test_autobackend_checkpoint_and_serve_checkpoint(nano, tmp_path):
    """`AutoBackend` over a checkpoint (the EMA model, nc, names, model
    config and imgsz of its meta) gives the model's forward bitwise;
    `serve_checkpoint` warms up and serves it; the artifacts of other
    runtimes raise naming what would load them, and an npz archive without
    nc raises asking for it."""
    from tamtr_torch.engine.checkpoint import save_checkpoint
    from tamtr_torch.train.trainer import Trainer, TrainConfig

    ckpt = tmp_path / "weights" / "best.pt"
    save_checkpoint(ckpt, Trainer(copy.deepcopy(nano), TrainConfig(batch_size=1), device="cpu"),
                    {"epoch": 0, "nc": NC, "names": ["a", "b", "c"], "model_cfg": "tamtr-nano.yaml", "imgsz": IMG,
                     "max_gt": 8})
    ab = AutoBackend(str(ckpt), device="cpu")
    assert (ab.backend, ab.nc, ab.imgsz, ab.names, ab.text_width) == ("torch", NC, IMG, ["a", "b", "c"], HD)
    img = np.random.default_rng(2).random((2, IMG, IMG, 3), dtype=np.float32)
    txt = np.random.default_rng(3).standard_normal((1, NC, HD)).astype(np.float32)
    with torch.inference_mode():
        want = nano(torch.from_numpy(img), torch.from_numpy(txt))["pred"].numpy()
    np.testing.assert_array_equal(ab(img, txt), want)
    srv = serve_checkpoint(str(ckpt), port=0, device="cpu").start()
    try:
        assert RemoteModel(srv.url).meta["names"] == ["a", "b", "c"]
        np.testing.assert_array_equal(AutoBackend(srv.url)(img, txt), want)
    finally:
        srv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        srv.run(ab, img, txt)
    unstarted = ModelServer(_stub_model)
    assert unstarted.run(_stub_model, img, txt[:, :1]).shape == (2, 5, 5)
    unstarted.stop()  # a server never started stops at once
    for bad, error, match in (("model.tflite", RuntimeError, "tensorflow"), ("model.npz", ValueError, "pass nc"),
                              ("model.stablehlo", RuntimeError, "jax")):
        with pytest.raises(error, match=match):
            AutoBackend(str(tmp_path / bad), device="cpu")
