"""The port's HTTP server (``serve/server.py``) over loopback against the JAX
package's, on the CPU: the same bodies posted to both, the same statuses,
the answers within ``tests/test_torch_serve.py``'s tolerances.

The port serves the committed ``titanic_stock`` fixture on the CPU route
(``ModelRegistry(devices=[torch.device("cpu")])``), the JAX package the same
saved model on one CPU device.  Every server is stopped in its fixture's
finalizer, and every request has a timeout.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.serve import ModelRegistry as JModelRegistry
from transmogrifai_tpu.serve import ModelServer as JModelServer

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.ops import linear as PL
from transmogrifai_tpu_torch.ops.cuda_build import KernelError
from transmogrifai_tpu_torch.serve import ModelRegistry, ModelServer

from test_torch_serve import assert_answers_close, serve_records

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _post(url, payload, timeout=30):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(url, timeout=30, text=False):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body = resp.read()
            return resp.status, body.decode() if text else json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture(scope="module")
def servers():
    """(the port's server, the JAX package's), both with titanic_stock as v1."""
    registry = ModelRegistry(max_batch=8, devices=[CPU])
    registry.deploy(P.load_model(FX.TITANIC_STOCK, device="cpu"), version="v1")
    jregistry = JModelRegistry(max_batch=8, devices=[jax.devices()[0]])
    jregistry.deploy(J.OpWorkflowModel.load(FX.TITANIC_STOCK), version="v1")
    srv = ModelServer(registry, port=0, max_batch=8, max_wait_ms=1.0, queue_size=256).start()
    jsrv = JModelServer(jregistry, port=0, max_batch=8, max_wait_ms=1.0,
                        queue_size=256).start()
    yield srv, jsrv
    srv.stop()
    jsrv.stop()


def test_score_single_and_list(servers):
    srv, jsrv = servers
    recs = serve_records("titanic_stock", rows=12)
    for body in (recs[0], {"records": recs}, recs[:3], {"records": [recs[1], {}]}):
        status, out = _post(srv.url + "/score", body)
        jstatus, jout = _post(jsrv.url + "/score", body)
        assert status == jstatus == 200 and out["model_version"] == jout["model_version"]
        if "score" in jout:
            assert_answers_close([out["score"]], [jout["score"]])
        else:
            assert_answers_close(out["scores"], jout["scores"])


def test_bad_requests(servers):
    srv, jsrv = servers
    good = serve_records("titanic_stock", rows=3)[0]
    bodies = [b"{not json", {"records": [1, 2]}, {"records": "x"},
              {"records": [good, {"Age": float("inf")}, {"Fare": "cheap"}]},
              {"Age": [1, 2]}]
    for body in bodies:
        status, out = _post(srv.url + "/score", body)
        jstatus, jout = _post(jsrv.url + "/score", body)
        assert status == jstatus and status in (400, 422), (body, status, jstatus)
        assert [e.get("index") for e in out.get("errors", [])] == \
            [e.get("index") for e in jout.get("errors", [])]
        assert [e.get("reason") for e in out.get("errors", [])] == \
            [e.get("reason") for e in jout.get("errors", [])]
        if status == 422 and "scores" in jout:
            assert out["scores"][1:] == [None, None]
            assert_answers_close(out["scores"][:1], jout["scores"][:1])
    assert _get(srv.url + "/nope")[0] == _get(jsrv.url + "/nope")[0] == 404
    status, out = _post(srv.url + "/score?tenant=checkout", good)
    assert status == 501 and "Queue 1 item 3" in out["error"]


def test_healthz_and_metrics_endpoints(servers):
    srv, jsrv = servers
    for url in (srv.url, jsrv.url):
        status, health = _get(url + "/healthz")
        assert status == 200 and health == {"status": "ok", "model": "v1"}
        _post(url + "/score", serve_records("titanic_stock", rows=3)[0])
    (_, m), (_, jm) = _get(srv.url + "/metrics"), _get(jsrv.url + "/metrics")
    for snap in (m, jm):
        assert snap["serve"]["responses"] >= 1 and snap["serve"]["batches"] >= 1
        assert "p99_ms" in snap["serve"]["request_latency"]
        assert "queue_depth" in snap["serve"]
        assert snap["registry"]["active"] == "v1"
        assert snap["registry"]["buckets"] == [1, 2, 4, 8]
    assert set(m["serve"]) <= set(jm["serve"])
    assert m["registry"]["replica_info"][0]["aot"]
    status, text = _get(srv.url + "/metrics?format=prometheus", text=True)
    assert status == 200
    assert "tmog_serve_responses" in text and 'tmog_serve_replica_batches{replica="0"' in text
    assert "tmog_resilience_data_faults" in text


def test_http_hot_swap(servers):
    """POST /models loads, warms and swaps; traffic never fails; the
    responses flip to the new version once the deploy returns."""
    srv, _ = servers
    rec = serve_records("titanic_stock", rows=3)[0]
    stop = threading.Event()
    failures = []

    def client():
        while not stop.is_set():
            status, _ = _post(srv.url + "/score", rec)
            if status != 200:
                failures.append(status)
                return

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        status, out = _post(srv.url + "/models", {"path": FX.TITANIC_NEWTON, "version": "v2"})
        assert status == 200 and out["active"] == "v2" and out["versions"] == ["v1", "v2"]
        status, scored = _post(srv.url + "/score", rec)
        assert status == 200 and scored["model_version"] == "v2"
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not failures
    assert _get(srv.url + "/metrics")[1]["serve"]["errors"] == 0


def test_http_deploy_bad_path(servers):
    srv, jsrv = servers
    for s in (srv, jsrv):
        active = s.registry.active_version()
        status, out = _post(s.url + "/models", {"path": "/nonexistent/model"})
        assert status == 400 and out["error"].startswith("deploy failed")
        status, health = _get(s.url + "/healthz")
        assert status == 200 and health["model"] == active


@pytest.fixture
def slow_server():
    registry = ModelRegistry(max_batch=2, devices=[CPU])
    entry = registry.deploy(P.load_model(FX.TITANIC_STOCK, device="cpu"), version="v1")
    real_batch = entry.batch

    def slow_batch(records):
        time.sleep(0.05)
        return real_batch(records)

    entry.batch = slow_batch
    srv = ModelServer(registry, port=0, max_batch=2, max_wait_ms=1.0, queue_size=4).start()
    yield srv
    srv.stop()


def test_http_overload_sheds_with_429(slow_server):
    srv = slow_server
    rec = serve_records("titanic_stock", rows=3)[0]
    shed, ok, other = [], [], []

    def client():
        status, body = _post(srv.url + "/score", rec, timeout=60)
        (ok if status == 200 else shed if status == 429 and body.get("shed")
         else other).append(status)

    threads = [threading.Thread(target=client) for _ in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not other and len(shed) + len(ok) == 24 and shed
    assert _get(srv.url + "/metrics")[1]["serve"]["shed"] == len(shed)


@pytest.fixture
def fresh_server():
    registry = ModelRegistry(max_batch=4, devices=[CPU])
    registry.deploy(P.load_model(FX.TITANIC_STOCK, device="cpu"), version="v1")
    srv = ModelServer(registry, port=0, max_batch=4, max_wait_ms=1.0, queue_size=16).start()
    yield srv
    srv.stop()


def test_a_kernel_error_is_a_500_never_a_422(fresh_server, monkeypatch):
    """K-AF failing on the card is the server's fault: HTTP 500, and no row
    is reported as a data fault of the client's."""
    srv = fresh_server

    def broken_head(*args, **kwargs):
        raise KernelError("predict_head kernel launch failed: CUDA error 700")

    monkeypatch.setattr(PL, "predict_head", broken_head)
    recs = serve_records("titanic_stock", rows=3)
    for body in (recs[0], {"records": recs[:2]}):
        status, out = _post(srv.url + "/score", body)
        assert status == 500 and "errors" not in out and "kernel" in out["error"]
    serve = _get(srv.url + "/metrics")[1]["serve"]
    assert serve["data_faults"] == 0 and serve["quarantined"] == 0
