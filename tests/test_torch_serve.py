"""The port's serving plane (``transmogrifai_tpu_torch/serve/``) against the
JAX package's, on the CPU.

Both packages load the committed fixtures (``titanic_stock``: binary
logistic head, K-AF binary; ``letters_stock``: 26-class softmax, which
fuses fewer than two stages and serves through ``BatchScoreFunction``;
``boston_ridge``: linear head, captured with the plan; ``titanic_xgb``:
trees, the generic head path) and score the same records: the fixture's
requests (NaN sent as null, the way a JSON client sends it), null records
and an unseen category.  Tolerances: probabilities ``FX.PROB_ATOL``,
margins ``FX.MARGIN_ATOL`` / ``MARGIN_RTOL``, regression ``FX.PRED_ATOL`` /
``PRED_RTOL``, and predictions equal except within ``FX.BOUNDARY`` of the
decision boundary (the top-two margin gap for softmax).  The port runs on
the CPU route (``devices=[torch.device("cpu")]``): its bucket programs run
eagerly on padded inputs and its heads on K-AF's plain version; the card's
graphs and kernels are held to these in ``tests/test_torch_cuda.py``.
"""
import math
import threading
import time

import jax
import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression as JLR
from transmogrifai_tpu.impl.classification.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.impl.classification.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.impl.regression.linear import OpLinearRegression as JLin
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction
from transmogrifai_tpu.ops import linear as JL
from transmogrifai_tpu.resilience import inject as jinject
from transmogrifai_tpu.serve import MicroBatcher as JMicroBatcher
from transmogrifai_tpu.serve import ModelRegistry as JModelRegistry
from transmogrifai_tpu.serve import bucket_for as jbucket_for
from transmogrifai_tpu.serve import shape_buckets as jshape_buckets
from transmogrifai_tpu.serve.aot import AotUnsupported as JAotUnsupported
from transmogrifai_tpu.serve.aot import BucketScorer as JBucketScorer

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.impl.classification.trees import OpRandomForestClassifier as PRF
from transmogrifai_tpu_torch.impl.classification.trees import OpXGBoostClassifier as PXGB
from transmogrifai_tpu_torch.impl.regression.linear import OpLinearRegression as PLin
from transmogrifai_tpu_torch import resilience as presilience
from transmogrifai_tpu_torch.ops import linear as PL
from transmogrifai_tpu_torch.ops.cuda_build import KernelError
from transmogrifai_tpu_torch.parallel import mesh as PM
from transmogrifai_tpu_torch.resilience import inject as pinject
from transmogrifai_tpu_torch.resilience.quarantine import DataFault
from transmogrifai_tpu_torch.serve import batcher as batcher_mod
from transmogrifai_tpu_torch.serve import (MicroBatcher, ModelRegistry, ServeMetrics,
                                           ShedError, aot, bucket_for, shape_buckets)
from transmogrifai_tpu_torch.serve.aot import AotUnsupported, BucketScorer

torch.set_num_threads(1)

CPU = torch.device("cpu")
FIXTURES = {"titanic_stock": FX.TITANIC_STOCK, "letters_stock": FX.LETTERS_STOCK,
            "boston_ridge": FX.BOSTON_RIDGE, "titanic_xgb": FX.TITANIC_XGB}
#: a record with a category the model never saw, per fixture
UNSEEN = {"titanic_stock": {"Sex": "unknown", "Embarked": "Z", "Pclass": 7, "Age": 30.0},
          "titanic_xgb": {"Sex": "unknown", "Embarked": "Z", "Pclass": 7, "Age": 30.0},
          "boston_ridge": {"chas": 9, "rm": 6.0, "crim": 0.1},
          "letters_stock": {"x_box": 99, "onpix": 3}}
ROWS = 70


def _json_value(v):
    """NaN goes as null, the way a JSON client sends it."""
    return None if isinstance(v, float) and math.isnan(v) else v


def serve_records(name, rows=ROWS):
    """The fixture's requests with finite values (NaN as null), then a null
    record and one with an unseen category."""
    recs = FX.records(FX.load_columns(FIXTURES[name] + "/requests.npz"))
    finite = [{k: _json_value(v) for k, v in r.items()} for r in recs
              if not any(isinstance(v, float) and math.isinf(v) for v in r.values())]
    return finite[:rows - 2] + [{}, dict(UNSEEN[name])]


def assert_answers_close(mine, ref):
    """Score dicts of the two packages, record by record, within the
    stated tolerances."""
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.keys() == b.keys()
        for name in b:
            x, y = a[name], b[name]
            assert x.keys() == y.keys(), (x.keys(), y.keys())
            probs = [k for k in y if k.startswith("probability_")]
            raws = [k for k in y if k.startswith("rawPrediction_")]
            if not probs and not raws:
                assert x["prediction"] == pytest.approx(
                    y["prediction"], abs=FX.PRED_ATOL, rel=FX.PRED_RTOL, nan_ok=True)
                continue
            for k in probs:
                assert abs(x[k] - y[k]) <= FX.PROB_ATOL, (k, x[k], y[k])
            for k in raws:
                assert abs(x[k] - y[k]) <= FX.MARGIN_ATOL + FX.MARGIN_RTOL * abs(y[k]), \
                    (k, x[k], y[k])
            if x["prediction"] != y["prediction"]:
                top = sorted((y[k] for k in raws), reverse=True)
                gap = top[0] - top[1]
                assert gap <= (2 if len(raws) == 2 else 1) * FX.BOUNDARY, (x, y)


@pytest.fixture(scope="module")
def models():
    """Each fixture loaded by both packages (the port's on the CPU)."""
    return {name: (P.load_model(path, device="cpu"), J.OpWorkflowModel.load(path))
            for name, path in FIXTURES.items()}


def jax_answers(model, records):
    return JBatchScoreFunction(model)(records)


# ---------------------------------------------------------------------------
# bucket math
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_batch", [1, 2, 48, 64, 1024])
def test_shape_buckets_and_bucket_for_match_the_reference(max_batch):
    buckets = shape_buckets(max_batch)
    assert buckets == jshape_buckets(max_batch)
    for n in range(1, max_batch + 1):
        assert bucket_for(n, buckets) == jbucket_for(n, buckets)


# ---------------------------------------------------------------------------
# K-AF's plain version and the predictors' programs
# ---------------------------------------------------------------------------
HEADS = [("binary", None), ("softmax", 3), ("softmax", 26), ("softmax", 128), ("linear", None)]


def _head_inputs(p, mode, k, seed=0):
    rng = np.random.default_rng(seed + p + (k or 0))
    X = rng.normal(size=(64, p)).astype(np.float32)
    X[3] = 0.0  # a row at the boundary: z = the intercept
    if mode == "softmax":
        coef = (rng.normal(size=(p, k)) / np.sqrt(p)).astype(np.float32)
        b = rng.normal(size=k).astype(np.float32)
    else:
        coef = (rng.normal(size=p) / np.sqrt(p)).astype(np.float32)
        b = rng.normal(size=1).astype(np.float32)
    return X, coef, b


@pytest.mark.parametrize("p", [10, 85, 1024])
@pytest.mark.parametrize("mode,k", HEADS)
def test_predict_head_plain_matches_the_reference(p, mode, k):
    X, coef, b = _head_inputs(p, mode, k)
    pred, raw, prob = PL.predict_head(*(torch.from_numpy(a) for a in (X, coef, b)), mode)
    if mode == "linear":
        want = np.asarray(JL.predict_linear(X, coef, b))
        assert raw is None and prob is None
        np.testing.assert_allclose(pred.numpy(), want, atol=FX.PRED_ATOL, rtol=FX.PRED_RTOL)
        return
    jfn = JL.predict_softmax if mode == "softmax" else JL.predict_binary_logistic
    jraw, jprob, jpred = (np.asarray(a) for a in jfn(X, coef, b))
    assert raw.shape == jraw.shape and prob.shape == jprob.shape and pred.shape == jpred.shape
    np.testing.assert_allclose(raw.numpy(), jraw, atol=FX.MARGIN_ATOL, rtol=FX.MARGIN_RTOL)
    np.testing.assert_allclose(prob.numpy(), jprob, atol=FX.PROB_ATOL, rtol=0)
    top = np.sort(jraw, axis=1)
    near = (top[:, -1] - top[:, -2]) <= (2 if mode == "binary" else 1) * FX.BOUNDARY
    assert np.array_equal(pred.numpy()[~near], jpred[~near])


def test_predict_head_checks_its_inputs():
    X, coef, b = (torch.from_numpy(a) for a in _head_inputs(10, "softmax", 3))
    with pytest.raises(ValueError, match="unknown head mode"):
        PL.predict_head(X, coef, b, "hinge")
    with pytest.raises(ValueError, match="coef must be"):
        PL.predict_head(X, coef[:5], b, "softmax")
    with pytest.raises(ValueError, match="1 to 128 classes"):
        PL.predict_head(X, torch.zeros((10, 129)), torch.zeros(129), "softmax")


FAMILIES = {
    "binary": (PLR, JLR, lambda c, b: {"coef": c, "intercept": b}),
    "multinomial": (PLR, JLR, lambda c, b: {"coef": c, "intercept": b, "multinomial": True}),
    "linear": (PLin, JLin, lambda c, b: {"coef": c, "intercept": b}),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_predict_program_matches_the_reference(family):
    pcls, jcls, params = FAMILIES[family]
    X, coef, b = _head_inputs(85, "softmax" if family == "multinomial" else "binary", 26)
    mine = pcls.predict_program(params(coef, b))(torch.from_numpy(X))
    ref = jcls.predict_program(params(coef, b))(X)
    for got, want in zip(mine, ref):
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FX.MARGIN_ATOL,
                                       rtol=FX.MARGIN_RTOL)
    # predict_tensors goes through the same head
    pred, raw, prob = pcls.predict_tensors(pcls.device_params(params(coef, b), CPU),
                                           torch.from_numpy(X))
    np.testing.assert_array_equal(pred, mine[0].numpy())


@pytest.mark.parametrize("pair", [(PXGB, JXGB), (PRF, JRF)], ids=["xgboost", "forest"])
def test_tree_families_have_no_predict_program_in_either_package(pair):
    for cls in pair:
        with pytest.raises(NotImplementedError):
            cls.predict_program({})


# ---------------------------------------------------------------------------
# BucketScorer against the JAX package's, at every bucket of max_batch 64
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["titanic_stock", "boston_ridge", "titanic_xgb"])
def test_bucket_scorer_matches_the_reference_at_every_bucket(models, name):
    pm, jm = models[name]
    buckets = shape_buckets(64)
    mine = BucketScorer(pm, buckets, CPU)
    ref = JBucketScorer(jm, buckets, jax.devices()[0])
    mine.warm()
    ref.warm()
    recs = serve_records(name)
    for b in buckets:
        part = recs[-b:] if b < len(recs) else recs
        assert_answers_close(mine(part), ref(part))
    assert_answers_close(mine(recs), jax_answers(jm, recs))  # two chunks of 64
    assert mine.graph_heads == (["SelectedModel"] if name == "boston_ridge" else [])
    mine.release()


def test_letters_fuses_fewer_than_two_stages_in_both_packages(models):
    pm, jm = models["letters_stock"]
    with pytest.raises(AotUnsupported, match="fewer than two"):
        BucketScorer(pm, [1, 2], CPU)
    with pytest.raises(JAotUnsupported, match="fewer than two"):
        JBucketScorer(jm, [1, 2], jax.devices()[0])


# ---------------------------------------------------------------------------
# registry and batcher (the reference's test_serve / test_serve_replicas
# cases for one device and the default tenant)
# ---------------------------------------------------------------------------
def _registry(max_batch=16, replicas=1, metrics=None):
    return ModelRegistry(max_batch=max_batch, devices=[CPU] * replicas, metrics=metrics)


@pytest.fixture
def batchers():
    """Started batchers, stopped at the end of the test."""
    live = []

    def start(b):
        live.append(b)
        return b.start()

    yield start
    for b in live:
        b.stop()


def test_registry_warmup_and_versions(models):
    pm, _ = models["titanic_stock"]
    registry = _registry()
    entry = registry.deploy(pm, version="prod-1")
    assert entry.warmed and registry.replica(0).scorer is not None
    assert registry.active_version() == "prod-1"
    assert registry.versions() == ["prod-1"]
    info = registry.info()
    assert info["buckets"] == [1, 2, 4, 8, 16] and info["replica_info"][0]["aot"]
    with pytest.raises(ValueError):
        registry.deploy(pm, version="prod-1")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        registry.deploy(pm, version="t", tenant="checkout")


def test_registry_requires_deploy():
    with pytest.raises(LookupError):
        _registry().active()


def test_failed_warmup_leaves_active_model(models):
    pm, _ = models["titanic_stock"]
    registry = _registry(max_batch=4)
    registry.deploy(pm, version="v1")
    with pytest.raises(Exception):
        registry.deploy(object(), version="v2")
    pinject.configure("serve.warm:fatal")
    try:
        with pytest.raises(pinject.InjectedFatal):
            registry.deploy(models["titanic_xgb"][0], version="v3")
    finally:
        pinject.configure("")
    assert registry.active_version() == "v1"
    assert registry.replica(0).owner.version == "v1"


def test_batcher_answers_match_the_reference(models, batchers):
    """Every fixture through the port's micro-batcher and the JAX package's,
    odd batch sizes included."""
    for name, (pm, jm) in models.items():
        recs = serve_records(name, rows=40)
        registry = _registry(max_batch=8)
        registry.deploy(pm)
        jregistry = JModelRegistry(max_batch=8, devices=[jax.devices()[0]])
        jregistry.deploy(jm)
        b = batchers(MicroBatcher(registry, max_batch=8, max_wait_ms=2.0))
        jb = batchers(JMicroBatcher(jregistry, max_batch=8, max_wait_ms=2.0))
        mine = [f.result(30).output for f in [b.submit(r) for r in recs]]
        ref = [f.result(30).output for f in [jb.submit(r) for r in recs]]
        assert_answers_close(mine, ref)
        assert (registry.replica(0).scorer is None) == (name == "letters_stock")


def test_non_finite_records_are_rejected_in_both_packages(models, batchers):
    pm, jm = models["titanic_stock"]
    registry, jregistry = _registry(max_batch=4), JModelRegistry(
        max_batch=4, devices=[jax.devices()[0]])
    registry.deploy(pm)
    jregistry.deploy(jm)
    b = batchers(MicroBatcher(registry, max_batch=4))
    jb = batchers(JMicroBatcher(jregistry, max_batch=4))
    for bad in ({"Age": float("inf")}, {"Fare": float("nan")}, {"Age": "old"},
                {"Age": [1, 2]}):
        with pytest.raises(Exception) as mine:
            b.submit(bad)
        with pytest.raises(Exception) as ref:
            jb.submit(bad)
        assert mine.value.reason == ref.value.reason and mine.value.status == 422
    assert b.metrics.snapshot()["data_faults"] == 4


def test_hot_swap_under_load(models, batchers):
    """Swap under concurrent load: no failed request, and every request
    submitted after deploy() returns is answered by the new version."""
    model1 = models["titanic_stock"][0]
    model2 = P.load_model(FX.TITANIC_NEWTON, device="cpu")
    registry = _registry(metrics=ServeMetrics())
    registry.deploy(model1, version="v1")
    batcher = batchers(MicroBatcher(registry, max_batch=16, max_wait_ms=1.0, queue_size=2048))
    swapped, stop = threading.Event(), threading.Event()
    failures, stale = [], []
    rec = serve_records("titanic_stock", rows=3)[0]

    def client():
        while not stop.is_set():
            was = swapped.is_set()
            try:
                scored = batcher.submit(rec).result(30)
            except Exception as e:  # noqa: BLE001
                failures.append(e)
                return
            if was and scored.version != "v2":
                stale.append(scored.version)

    threads = [threading.Thread(target=client) for _ in range(6)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        registry.deploy(model2, version="v2")
        swapped.set()
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not failures and not stale
    assert registry.active_version() == "v2"
    snap = batcher.metrics.snapshot()
    assert snap["swaps"] == 2 and snap["errors"] == 0 and snap["degraded_batches"] == 0


def test_injected_fault_goes_to_the_row_path(models, batchers):
    """A system fault at the replica serves its batch on the per-record row
    path, with the same answers as the JAX package's under the same fault."""
    pm, jm = models["titanic_stock"]
    recs = serve_records("titanic_stock", rows=3)[:1]
    registry, jregistry = _registry(max_batch=4), JModelRegistry(
        max_batch=4, devices=[jax.devices()[0]])
    registry.deploy(pm)
    jregistry.deploy(jm)
    b = batchers(MicroBatcher(registry, max_batch=4, max_wait_ms=1.0))
    jb = batchers(JMicroBatcher(jregistry, max_batch=4, max_wait_ms=1.0))
    pinject.configure("serve.score:fatal:1:0:0:1")
    jinject.configure("serve.score:fatal:1:0:0:1")
    try:
        mine = [b.score(r, timeout_s=30) for r in recs]
        ref = [jb.score(r, timeout_s=30) for r in recs]
    finally:
        pinject.configure("")
        jinject.configure("")
    assert_answers_close(mine, ref)
    snap = b.metrics.snapshot()
    assert snap["fallback_batches"] == 1 and snap["fallback_records"] == 1
    assert snap["errors"] == 0 and snap["replica_failures"] == 1


@pytest.mark.parametrize("err,system", [
    (KernelError("predict_head kernel launch failed: CUDA error 700"), True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (ValueError("could not convert string to float: 'x'"), False),
    (DataFault("non_finite", index=0), False),
], ids=["kernel", "oom", "cuda-runtime", "value", "data-fault"])
def test_device_errors_are_system_faults(err, system):
    """A kernel or CUDA failure on the card is the machine's fault, never the
    data's: it goes to the breaker and the row path, not to bisection."""
    assert batcher_mod._is_system_fault(err) is system


def test_a_kernel_error_is_not_blamed_on_the_data(models, batchers, monkeypatch):
    """K-AF failing inside ``rep.score`` trips the slot's breaker and fails
    the rows as system errors: no bisection, no ``DataFault``."""
    pm, _ = models["titanic_stock"]
    registry = _registry(max_batch=4)
    registry.deploy(pm)
    b = batchers(MicroBatcher(registry, max_batch=4, max_wait_ms=1.0))

    def broken_head(*args, **kwargs):
        raise KernelError("predict_head kernel launch failed: CUDA error 700")

    monkeypatch.setattr(PL, "predict_head", broken_head)
    probes = presilience.scope.snapshot()["bisect_probes"]
    for r in serve_records("titanic_stock", rows=3)[:2]:
        with pytest.raises(KernelError):
            b.score(r, timeout_s=30)
    snap = b.metrics.snapshot()
    assert snap["data_faults"] == 0 and snap["quarantined"] == 0
    assert snap["replica_failures"] >= 1 and snap["errors"] == 2
    assert presilience.scope.snapshot()["bisect_probes"] == probes


def test_overload_sheds_never_hangs(models, batchers):
    pm, _ = models["titanic_stock"]
    registry = _registry(max_batch=2)
    entry = registry.deploy(pm)
    real_batch = entry.batch

    def slow_batch(records):
        time.sleep(0.05)
        return real_batch(records)

    entry.batch = slow_batch
    batcher = batchers(MicroBatcher(registry, max_batch=2, max_wait_ms=1.0, queue_size=4))
    shed, done, hung = [], [], []
    rec = serve_records("titanic_stock", rows=3)[0]

    def client():
        try:
            done.append(batcher.score(rec, timeout_s=30))
        except ShedError:
            shed.append(1)
        except Exception as e:  # noqa: BLE001
            hung.append(e)

    threads = [threading.Thread(target=client) for _ in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not hung and len(shed) + len(done) == 24 and shed
    snap = batcher.metrics.snapshot()
    assert snap["shed"] == len(shed) and snap["requests"] == 24
    assert snap["responses"] == len(done)


def test_serve_replicas_env_cycles_the_cards(monkeypatch):
    """``TMOG_SERVE_REPLICAS`` over one card: two slots on it (the device
    query is stubbed to one card; without one ``serve_devices`` raises)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("TMOG_SERVE_REPLICAS", raising=False)
    assert PM.serve_devices() == [torch.device("cuda", 0)]
    monkeypatch.setenv("TMOG_SERVE_REPLICAS", "2")
    assert PM.serve_devices() == [torch.device("cuda", 0)] * 2
    assert len(PM.serve_devices(5)) == 5 and len(PM.serve_devices(0)) == 1
    assert PM.serve_chip_index(PM.serve_devices(3)) == [0, 0, 0]


def test_two_replicas_share_the_traffic(models, batchers):
    pm, jm = models["boston_ridge"]
    metrics = ServeMetrics()
    registry = _registry(max_batch=4, replicas=2, metrics=metrics)
    registry.deploy(pm, version="v1")
    assert registry.n_replicas == 2
    assert [r["id"] for r in registry.info()["replica_info"]] == ["v1/0", "v1/1"]
    batcher = batchers(MicroBatcher(registry, max_batch=4, max_wait_ms=1.0, queue_size=4096))
    recs = serve_records("boston_ridge", rows=12)
    out, errors = {}, []

    def client(i):
        try:
            for j in range(6):
                out[(i, j)] = batcher.submit(recs[(i + j) % len(recs)]).result(60).output
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and len(out) == 72
    keys = sorted(out)
    ref = jax_answers(jm, [recs[(i + j) % len(recs)] for i, j in keys])
    assert_answers_close([out[k] for k in keys], ref)
    per_slot = metrics.snapshot()["replicas"]
    assert sum(s["responses"] for s in per_slot.values()) == 72
    assert len([s for s in per_slot.values() if s["batches"] > 0]) == 2, per_slot


def test_second_deploy_of_the_same_model_is_memo_only():
    pm = P.load_model(FX.BOSTON_RIDGE, device="cpu")
    registry = _registry(max_batch=8, replicas=2)
    aot.reset_warm_stats()
    registry.deploy(pm, version="v1")
    assert aot.warm_stats() == {"memo": 0, "capture": 0, "eager": 8}
    aot.reset_warm_stats()
    registry.deploy(pm, version="v2")
    assert aot.warm_stats() == {"memo": 8, "capture": 0, "eager": 0}
    first = registry.replica(0).score(serve_records("boston_ridge", rows=6))
    assert first == registry.replica(1).score(serve_records("boston_ridge", rows=6))


def test_a_failing_bucket_program_fails_the_deploy_naming_its_stage(models):
    """A kernel failure while a bucket warms (on the card: while it is
    captured) fails the deploy with the stage's name; nothing falls back,
    and the active version keeps serving."""
    pm, _ = models["titanic_stock"]
    registry = _registry(max_batch=4)
    registry.deploy(pm, version="v1")
    broken = P.load_model(FX.TITANIC_NEWTON, device="cpu")
    stage = next(s for s in broken.stages if type(s).__name__ == "AddTransformer")

    def boom(*args):
        raise RuntimeError("kernel launch failed")

    stage.torch_transform = boom
    with pytest.raises(RuntimeError, match="kernel launch failed") as err:
        registry.deploy(broken, version="v2")
    assert any("AddTransformer" in note for note in getattr(err.value, "__notes__", []))
    assert registry.active_version() == "v1" and registry.versions() == ["v1"]
    assert registry.replica(0).score(serve_records("titanic_stock", rows=3))
