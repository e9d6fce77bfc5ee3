"""The port's streaming executor (``workflow/stream.py``) against the JAX
package's, on the CPU.

Both packages fit the same pipelines on the same seeded numpy columns: the
JAX package's own stream test pipeline
(``tests/test_stream_pipeline.py::_pipeline``: a fill and two real
vectorizers, a combiner, a vector standard scaler) and its transform bench
pipeline (``bench.py:212-251``: the same stages over eight columns, fitted
on a head of the rows).  Then:

- ``build_plan``'s stages, terminals, base columns and host layers equal the
  JAX package's, with and without a liveness set;
- ``apply_streamed``'s outputs equal the JAX package's ``apply_streamed``
  (run under its own ``TMOG_TRANSFORM_CHUNK_ROWS``) bit for bit, at chunk
  sizes that divide the rows, exceed them and leave a tail (the scaler's
  product with the float32 reciprocal of std rounds as XLA's does);
- liveness leaves intermediates on the device, a host-prep stage (the
  one-hot pivot's codes) streams on base columns, the ``torch_chunkable``
  opt-out and a host-prep stage fed by a streamed output run on the host
  after the stream, and a run of fewer than two fusable stages is declined;
- past ``dag.STREAM_ROWS`` rows the DAG's training flushes and its scoring
  go through the executor in ``stream.CHUNK_ROWS`` chunks, with the layer
  path's scores and winner.
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JT
from transmogrifai_tpu import columns as JC
from transmogrifai_tpu.impl.feature import transformers as JTr
from transmogrifai_tpu.impl.feature import vectorizers as JV
from transmogrifai_tpu.workflow import stream as JS

import transmogrifai_tpu_torch as P
import transmogrifai_tpu_torch.types as PT
from transmogrifai_tpu_torch import columns as PC
from transmogrifai_tpu_torch.impl.feature import transformers as PTr
from transmogrifai_tpu_torch.impl.feature import vectorizers as PV
from transmogrifai_tpu_torch.workflow import dag as PDag
from transmogrifai_tpu_torch.workflow import stream as PS

torch.set_num_threads(1)

SIDES = {"jax": (J, JT, JC, JTr, JV), "port": (P, PT, PC, PTr, PV)}


def _raw(n, n_feat=6, seed=0):
    rng = np.random.default_rng(seed)
    cols = {}
    for j in range(n_feat):
        v = rng.normal(size=n)
        m = rng.random(n) > 0.1
        cols[f"x{j}"] = (np.where(m, v, 0.0), m)
    cols["label"] = ((rng.random(n) > 0.5).astype(float), np.ones(n, bool))
    return cols


def _dataset(side, raw, rows=None):
    pkg, T, C, _, _ = SIDES[side]
    sl = slice(None) if rows is None else slice(0, rows)
    return C.Dataset({k: C.NumericColumn(T.RealNN if k == "label" else T.Real, v[sl], m[sl])
                      for k, (v, m) in raw.items()})


def _pipeline(side, raw, split=3, head=None):
    """[[fill, vec1, vec2], [combiner], [scaler]] fitted on ``head`` rows
    (all by default), the JAX package's test and bench pipelines."""
    pkg, T, C, Tr, V = SIDES[side]
    n_feat = sum(k.startswith("x") for k in raw)
    xs = [pkg.FeatureBuilder(f"x{j}", T.Real).extract(field=f"x{j}").as_predictor()
          for j in range(n_feat)]
    fit_ds = _dataset(side, raw, head)
    fm = Tr.FillMissingWithMean().set_input(xs[0]).fit(fit_ds)
    m1 = V.RealVectorizer().set_input(*xs[:split]).fit(fit_ds)
    m2 = V.RealVectorizer(fill_with_mean=False, fill_value=-1.0).set_input(*xs[split:]) \
        .fit(fit_ds)
    comb = V.VectorsCombiner().set_input(m1.get_output(), m2.get_output())
    if side == "port":
        for t in (fm, m1, m2, comb):
            t.to("cpu")
    for t in (fm, m1, m2, comb):
        fit_ds = fit_ds.with_column(t.get_output().name, t.transform_dataset(fit_ds))
    sm = V.StandardScalerVectorizer().set_input(comb.get_output()).fit(fit_ds)
    if side == "port":
        sm.to("cpu")
    return [[fm, m1, m2], [comb], [sm]], {"fm": fm, "m1": m1, "m2": m2, "comb": comb, "sm": sm}


def _role_names(stages):
    return {k: t.get_output().name for k, t in stages.items()}


def _plan_summary(plan, names):
    back = {v: k for k, v in names.items()}
    return ([(back[e.out_name], e.out_kind, e.prep, e.terminal,
              [(kind, nm) for kind, nm in e.arg_specs]) for e in plan.stages],
            [[back.get(t.get_output().name) for t in lay] for lay in plan.host_layers],
            plan.base_numeric, plan.base_vector)


def _normalize_specs(summary, names):
    """Internal column names differ between the packages (uid counters):
    specs name the producing role instead."""
    back = {v: k for k, v in names.items()}
    stages, host, num, vec = summary
    stages = [(r, k, p, t, [(kind, back.get(nm, nm)) for kind, nm in specs])
              for r, k, p, t, specs in stages]
    return stages, host, num, vec


@pytest.mark.parametrize("which", ["test_pipeline", "bench_pipeline"])
@pytest.mark.parametrize("live_role", [None, "sm", "comb"])
def test_build_plan_equals_the_jax_packages(which, live_role):
    n = 300
    raw = _raw(n, 6 if which == "test_pipeline" else 8, seed=1)
    kw = {} if which == "test_pipeline" else {"split": 4, "head": 100}
    got = {}
    for side, mod in (("jax", JS), ("port", PS)):
        layers, st = _pipeline(side, raw, **kw)
        names = _role_names(st)
        live = None if live_role is None else {names[live_role]}
        plan = mod.build_plan(_dataset(side, raw), layers, live=live)
        got[side] = _normalize_specs(_plan_summary(plan, names), names)
    assert got["jax"] == got["port"]
    stages = got["port"][0]
    assert [s[0] for s in stages] == ["fm", "m1", "m2", "comb", "sm"]
    if live_role == "sm":
        assert [s[3] for s in stages] == [False, False, False, False, True]


@pytest.mark.parametrize("n,chunk", [(256, 64), (237, 64), (100, 256), (1000, 300)])
@pytest.mark.parametrize("which", ["test_pipeline", "bench_pipeline"])
def test_streamed_outputs_equal_the_jax_packages(monkeypatch, n, chunk, which):
    monkeypatch.setenv("TMOG_TRANSFORM_CHUNK_ROWS", str(chunk))
    monkeypatch.setattr(PS, "CHUNK_ROWS", chunk)
    raw = _raw(n, 6 if which == "test_pipeline" else 8, seed=n)
    kw = {} if which == "test_pipeline" else {"split": 4, "head": min(n, 100)}
    outs = {}
    for side, mod in (("jax", JS), ("port", PS)):
        layers, st = _pipeline(side, raw, **kw)
        mod.reset_stream_stats()
        out = mod.apply_streamed(_dataset(side, raw), layers)
        assert out is not None
        outs[side] = {k: out[nm] for k, nm in _role_names(st).items()}
    assert PS.stream_stats()["chunks"] == -(-n // chunk)
    for role in ("fm", "m1", "m2", "comb", "sm"):
        j, p = outs["jax"][role], outs["port"][role]
        if role == "fm":
            assert np.array_equal(j.mask, p.mask)
            assert np.array_equal(np.asarray(j.values, np.float32), p.values)
        else:
            assert np.array_equal(np.asarray(j.values), p.values.numpy()), role
            assert [c.indicator_value for c in j.metadata.columns] == \
                [c.indicator_value for c in p.metadata.columns]


def test_liveness_leaves_intermediates_on_the_device(monkeypatch):
    monkeypatch.setattr(PS, "CHUNK_ROWS", 64)
    raw = _raw(150, seed=3)
    layers, st = _pipeline("port", raw)
    names = _role_names(st)
    PS.reset_stream_stats()
    out = PS.apply_streamed(_dataset("port", raw), layers, live={names["sm"]})
    assert names["sm"] in out.columns
    assert not any(names[k] in out.columns for k in ("fm", "m1", "m2", "comb"))
    s = PS.stream_stats()
    assert s["device_only"] == 4 and s["terminals"] == 1 and s["chunks"] == 3


def test_host_prep_stage_streams_on_base_columns_only(monkeypatch):
    """The one-hot pivot's per-chunk codes stream on its base columns; a
    host-prep stage fed by a streamed output (``DropIndicesByTransformer`` on
    the combiner's vector) runs on the host after the stream, on the
    materialized terminal, in both packages."""
    monkeypatch.setenv("TMOG_TRANSFORM_CHUNK_ROWS", "32")
    monkeypatch.setattr(PS, "CHUNK_ROWS", 32)
    n = 120
    rng = np.random.default_rng(7)
    sex = rng.choice(["male", "female"], n).astype(object)
    emb = rng.choice(["S", "C", "Q", None], n).astype(object)
    age = np.where(rng.random(n) < 0.2, 0.0, rng.uniform(1, 80, n))
    age_m = age > 0
    outs = {}
    for side, mod in (("jax", JS), ("port", PS)):
        pkg, T, C, Tr, V = SIDES[side]
        f_sex = pkg.FeatureBuilder("sex", T.PickList).extract(field="sex").as_predictor()
        f_emb = pkg.FeatureBuilder("emb", T.PickList).extract(field="emb").as_predictor()
        f_age = pkg.FeatureBuilder("age", T.Real).extract(field="age").as_predictor()
        ds = C.Dataset({"sex": C.ObjectColumn(T.PickList, sex.copy()),
                        "emb": C.ObjectColumn(T.PickList, emb.copy()),
                        "age": C.NumericColumn(T.Real, age, age_m)})
        cm = V.OneHotVectorizer(top_k=5, min_support=1).set_input(f_sex, f_emb).fit(ds)
        rv = V.RealVectorizer().set_input(f_age).fit(ds)
        add = Tr.ScalarMathTransformer("plus", 1.0).set_input(f_age)
        rv2 = V.RealVectorizer().set_input(add.get_output())
        ds2 = ds.with_column(add.get_output().name, add.transform_dataset(ds))
        rv2 = rv2.fit(ds2)
        comb = V.VectorsCombiner().set_input(cm.get_output(), rv.get_output(),
                                             rv2.get_output())
        drop = Tr.DropIndicesByTransformer(lambda c: c.indicator_value is not None)
        drop.set_input(comb.get_output())
        stages = [cm, rv, add, rv2, comb, drop]
        if side == "port":
            for t in stages:
                t.to("cpu")
        ref = ds
        for t in stages:
            ref = ref.with_column(t.get_output().name, t.transform_dataset(ref))
        mod.reset_stream_stats()
        out = mod.apply_streamed(ds, [[cm, rv, add], [rv2], [comb], [drop]])
        outs[side] = (np.asarray(out[comb.get_output().name].values),
                      np.asarray(out[drop.get_output().name].values),
                      np.asarray(ref[cm.get_output().name].values),
                      np.asarray(out[cm.get_output().name].values), mod.stream_stats())
    (jc, jd, jr, jo, js), (pc, pd_, pr, po, ps) = outs["jax"], outs["port"]
    assert np.array_equal(jc, pc) and np.array_equal(jd, pd_)
    assert np.array_equal(po, pr) and np.array_equal(jo, po)      # one-hot: as the host path
    assert pd_.shape[1] < pc.shape[1]
    for s in (js, ps):
        assert (s["stages_fused"], s["stages_host"], s["chunks"]) == (5, 1, 4)


def test_chunkable_opt_out_and_declined_runs(monkeypatch):
    monkeypatch.setattr(PS, "CHUNK_ROWS", 64)
    raw = _raw(200, seed=5)
    layers, st = _pipeline("port", raw)
    fm, m1, m2 = layers[0]
    ds = _dataset("port", raw)
    ref = {k: st[k].transform_dataset(ds) for k in ("fm", "m1", "m2")}
    m2.torch_chunkable = False
    PS.reset_stream_stats()
    out = PS.apply_streamed(ds, [[fm, m1, m2]])
    assert np.array_equal(out[m2.get_output().name].values.numpy(), ref["m2"].values.numpy())
    assert np.array_equal(out[m1.get_output().name].values.numpy(), ref["m1"].values.numpy())
    s = PS.stream_stats()
    assert s["stages_fused"] == 2 and s["stages_host"] == 1
    PS.reset_stream_stats()
    assert PS.apply_streamed(ds, [[m1]]) is None
    assert PS.apply_streamed(ds, [[m2, m1]]) is None       # one fusable stage
    assert PS.stream_stats()["declined"] == 2
    assert PS.build_plan(ds, [[m1]]) is None


def test_dag_streams_past_the_threshold(monkeypatch):
    """A train and a score of the Titanic flow past a lowered ``STREAM_ROWS``:
    every flush of more than one fusable stage and the scoring DAG go
    through the executor in ``CHUNK_ROWS`` chunks, with the same scores as
    the layer path."""
    from transmogrifai_tpu_torch.apps import titanic
    from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression
    from transmogrifai_tpu_torch.impl.selector import defaults as D

    cols = titanic.titanic_data(1200, 3)
    space = [(OpLogisticRegression(), D.grid(reg_param=[0.01], elastic_net_param=[0.1]))]
    model, _ = titanic.train_titanic(cols, device="cpu", models_and_parameters=space)
    layer_scores = model.score(cols)
    monkeypatch.setattr(PDag, "STREAM_ROWS", 300)
    monkeypatch.setattr(PS, "CHUNK_ROWS", 256)
    PS.reset_stream_stats()
    streamed = model.score(cols)
    s = PS.stream_stats()
    assert s["streams"] == 1 and s["chunks"] == 5 and s["rows"] == 1200
    name = model.result_features[0].name
    a, b = layer_scores[name], streamed[name]
    np.testing.assert_array_equal(a.prediction, b.prediction)
    np.testing.assert_allclose(a.probability, b.probability, rtol=0, atol=1e-6)
    PS.reset_stream_stats()
    m2, _ = titanic.train_titanic(cols, device="cpu", models_and_parameters=space)
    s = PS.stream_stats()
    assert s["streams"] >= 2 and s["chunks"] >= 2 * s["streams"]
    assert m2.stages[-1].summary.best_grid == model.stages[-1].summary.best_grid
