"""The fill, scaler, calibrator, vectorizer and value-munging stages of the
port against the JAX package's, on the CPU.

Every stage is fitted by both packages on the same seeded numpy columns:

- the host path (``transform_columns``) is compared bit for bit (float64 on
  both sides, or the same objects);
- the device program (the port's ``torch_transform``, whose kernels take
  their plain versions on CPU tensors: K-AC ``numeric_scale``, K-AD
  ``column_affine``, K-C ``fill_indicator``, K-Z ``column_gather``) against
  the JAX package's jitted ``jax_transform``: fills, gathers, one-hot and
  buckets bit-equal, and the scalers' arithmetic bit-equal too (the port
  rounds as XLA compiles it: ``slope * v + intercept`` one fused
  multiply-add, a division by a fitted constant a product with its float32
  reciprocal), except log and exp, which XLA evaluates by its own
  approximations: within ``APPROX_RTOL`` (measured 1.2e-7 relative, under
  2 float32 ulps).  That is inside the JAX package's own stream-versus-host
  tolerance (rtol 2e-6 / atol 1e-6).
- ``transmogrify`` takes Binary and RealNN features: the combined vector of
  a mixed feature set equals the JAX package's.
"""
import jax
import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JT
from transmogrifai_tpu import columns as JC
from transmogrifai_tpu.impl.feature import scalers as JS
from transmogrifai_tpu.impl.feature import text as JTx
from transmogrifai_tpu.impl.feature import transformers as JTr
from transmogrifai_tpu.impl.feature import vectorizers as JV
from transmogrifai_tpu.impl.feature.transmogrifier import transmogrify as jtransmogrify

import transmogrifai_tpu_torch as P
import transmogrifai_tpu_torch.types as PT
from transmogrifai_tpu_torch import columns as PC
from transmogrifai_tpu_torch.impl.feature import scalers as PS
from transmogrifai_tpu_torch.impl.feature import text as PTx
from transmogrifai_tpu_torch.impl.feature import transformers as PTr
from transmogrifai_tpu_torch.impl.feature import vectorizers as PV
from transmogrifai_tpu_torch.impl.feature.transmogrifier import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.ops import layer as L

torch.set_num_threads(1)

#: log and exp: XLA's CPU approximations against torch's (2 float32 ulps)
APPROX_RTOL = 2.0 ** -22
N = 3000


def _columns(seed=0):
    """x: a real column with nulls, big and small values and ties; pos: its
    positive part; b: a 0/1 column with nulls; y: 0/1 labels."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=N) * 20
    x[::17] = 0.0
    x[1::23] = 1e6
    m = rng.random(N) > 0.15
    pos = np.abs(x) + 0.5
    pos[::31] = 0.0                       # log 0 = -inf: absent after the scaler
    b = (rng.random(N) < 0.4).astype(float)
    bm = rng.random(N) > 0.1
    y = (rng.random(N) < 0.5).astype(float)
    return {"x": (np.where(m, x, 0.0), m), "pos": (pos, m), "b": (np.where(bm, b, 0.0), bm),
            "y": (y, np.ones(N, bool))}


def _pair(raw, types=(("x", "Real"), ("pos", "Real"), ("b", "Binary"), ("y", "RealNN"))):
    """(JAX features, JAX dataset, port features, port dataset)."""
    out = []
    for pkg, tys, cols in ((J, JT, JC), (P, PT, PC)):
        feats = {n: pkg.FeatureBuilder(n, getattr(tys, t)).extract(field=n).as_predictor()
                 for n, t in types}
        ds = cols.Dataset({n: cols.NumericColumn(getattr(tys, t), *raw[n]) for n, t in types})
        out += [feats, ds]
    return out


def _jax_device(stage, *args):
    return jax.jit(stage.jax_transform)(*args)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _numeric_args(col):
    v = np.asarray(col.values, np.float32)
    return (v, col.mask), (torch.from_numpy(v.copy()), torch.from_numpy(col.mask.copy()))


def _check_numeric_stage(js, ps, jds, pds, approx=False):
    """Host paths bit-equal; device programs bit-equal (or within
    ``APPROX_RTOL`` for log / exp)."""
    jh = js.transform_columns([jds[f.name] for f in js.inputs])
    ph = ps.transform_columns([pds[f.name] for f in ps.inputs])
    assert np.array_equal(jh.mask, ph.mask)
    assert np.array_equal(np.asarray(jh.values, np.float64), np.asarray(ph.values, np.float64))
    jargs, pargs = [], []
    for f in js.inputs:
        a, b = _numeric_args(jds[f.name])
        jargs += a
        pargs += b
    jv, jm = _jax_device(js, *jargs)
    pv, pm = ps.torch_transform(*pargs)
    assert np.array_equal(_np(jm), _np(pm))
    jv, pv = np.asarray(jv), _np(pv)
    assert jv.dtype == pv.dtype == np.float32
    if approx:
        np.testing.assert_allclose(pv, jv, rtol=APPROX_RTOL, atol=0)
    else:
        assert np.array_equal(jv, pv)


def test_fill_missing_with_mean_matches_jax():
    jf, jds, pf, pds = _pair(_columns(1))
    js = JTr.FillMissingWithMean().set_input(jf["x"]).fit(jds)
    ps = PTr.FillMissingWithMean().set_input(pf["x"]).fit(pds)
    assert js.mean == ps.mean
    _check_numeric_stage(js, ps, jds, pds)


@pytest.mark.parametrize("with_mean,with_std", [(True, True), (False, True), (True, False)])
def test_scalar_standard_scaler_matches_jax(with_mean, with_std):
    jf, jds, pf, pds = _pair(_columns(2))
    js = JS.OpScalarStandardScaler(with_mean, with_std).set_input(jf["x"]).fit(jds)
    ps = PS.OpScalarStandardScaler(with_mean, with_std).set_input(pf["x"]).fit(pds)
    assert (js.mean, js.std) == (ps.mean, ps.std)
    _check_numeric_stage(js, ps, jds, pds)


@pytest.mark.parametrize("kind,slope,intercept", [("linear", 1.37, -0.291), ("linear", -3.0, 7.5),
                                                  ("log", 1.0, 0.0)])
def test_scaler_and_descaler_match_jax(kind, slope, intercept):
    jf, jds, pf, pds = _pair(_columns(3))
    src = "x" if kind == "linear" else "pos"
    js = JS.ScalerTransformer(JS.ScalingType(kind), slope, intercept).set_input(jf[src])
    ps = PS.ScalerTransformer(PS.ScalingType(kind), slope, intercept).set_input(pf[src])
    _check_numeric_stage(js, ps, jds, pds, approx=kind == "log")
    jds = jds.with_column(js.get_output().name, js.transform_dataset(jds))
    pds = pds.with_column(ps.get_output().name, ps.transform_dataset(pds))
    jd = JS.DescalerTransformer().set_input(js.get_output(), js.get_output())
    pd_ = PS.DescalerTransformer().set_input(ps.get_output(), ps.get_output())
    _check_numeric_stage(jd, pd_, jds, pds, approx=kind == "log")


@pytest.mark.parametrize("buckets", [2, 10, 100, 1024])
def test_percentile_calibrator_matches_jax(buckets):
    raw = _columns(4)
    v = raw["x"][0].copy()
    v[5:40] = np.quantile(v, 0.5)         # ties at a split
    v[40] = np.nan                        # out of the fit (absent), searched as NaN
    m = np.ones(N, bool)
    m[40] = False
    raw["x"] = (v, m)
    jf, jds, pf, pds = _pair(raw)
    js = JS.PercentileCalibrator(buckets).set_input(jf["x"]).fit(jds)
    ps = PS.PercentileCalibrator(buckets).set_input(pf["x"]).fit(pds).to("cpu")
    assert np.array_equal(js.splits, ps.splits)
    _check_numeric_stage(js, ps, jds, pds)


def test_isotonic_calibrator_matches_jax():
    raw = _columns(5)
    jf, jds, pf, pds = _pair(raw)
    js = JS.IsotonicRegressionCalibrator().set_input(jf["y"], jf["x"]).fit(jds)
    ps = PS.IsotonicRegressionCalibrator().set_input(pf["y"], pf["x"]).fit(pds)
    assert np.array_equal(js.thresholds, ps.thresholds) and np.array_equal(js.values, ps.values)
    jh = js.transform_columns([jds["y"], jds["x"]])
    ph = ps.transform_columns([pds["y"], pds["x"]])
    assert np.array_equal(jh.values, ph.values) and not hasattr(ps, "torch_transform")
    x, y = np.random.default_rng(0).random(50), np.random.default_rng(1).random(50)
    for a, b in zip(JS.pav_fit(x, y), PS.pav_fit(x, y)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("with_mean,with_std", [(True, True), (False, True)])
def test_standard_scaler_vectorizer_matches_jax(with_mean, with_std):
    rng = np.random.default_rng(6)
    X = (rng.normal(size=(N, 24)) * rng.uniform(0.1, 50, 24)).astype(np.float32)
    X[:, 3] = 2.0                          # a constant column: std 1
    out = []
    for pkg, tys, cols, V in ((J, JT, JC, JV), (P, PT, PC, PV)):
        f = pkg.FeatureBuilder("v", tys.OPVector).extract(field="v").as_predictor()
        ds = cols.Dataset({"v": cols.VectorColumn(tys.OPVector, X.copy())})
        out.append((V.StandardScalerVectorizer(with_mean, with_std).set_input(f).fit(ds)
                    .to("cpu") if V is PV else
                    V.StandardScalerVectorizer(with_mean, with_std).set_input(f).fit(ds), ds))
    (js, jds), (ps, pds) = out
    assert np.array_equal(js.mean, ps.mean) and np.array_equal(js.std, ps.std)
    jh = np.asarray(js.transform_columns([jds["v"]]).values)
    ph = ps.transform_columns([pds["v"]]).numpy()
    jd = np.asarray(_jax_device(js, X))
    # the host paths divide in float32; the device programs multiply by the
    # float32 reciprocal, as XLA compiles the division by a constant
    assert np.array_equal(ph, jh)
    assert np.array_equal(ps.torch_transform(torch.from_numpy(X)).numpy(), jd)


@pytest.mark.parametrize("track_nulls", [True, False])
def test_binary_and_realnn_vectorizers_match_jax(track_nulls):
    raw = _columns(7)
    jf, jds, pf, pds = _pair(raw)
    for jst, pst, ins in ((JV.BinaryVectorizer(track_nulls=track_nulls),
                           PV.BinaryVectorizer(track_nulls=track_nulls), ("b", "x")),
                          (JV.RealNNVectorizer(), PV.RealNNVectorizer(), ("y", "x"))):
        jst.set_input(*[jf[n] for n in ins])
        pst.set_input(*[pf[n] for n in ins]).to("cpu")
        jh = jst.transform_columns([jds[n] for n in ins])
        ph = pst.transform_columns([pds[n] for n in ins])
        assert np.array_equal(np.asarray(jh.values), ph.numpy())
        assert [c.indicator_value for c in jh.metadata.columns] == \
            [c.indicator_value for c in ph.metadata.columns]
        jargs, pargs = [], []
        for n in ins:
            a, b = _numeric_args(jds[n])
            jargs += a
            pargs += b
        assert np.array_equal(np.asarray(_jax_device(jst, *jargs)),
                              pst.torch_transform(*pargs).numpy())


def test_drop_indices_by_matches_jax():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(200, 6)).astype(np.float32)
    out = []
    for pkg, tys, cols, V, Tr in ((J, JT, JC, JV, JTr), (P, PT, PC, PV, PTr)):
        a = pkg.FeatureBuilder("a", tys.Real).extract(field="a").as_predictor()
        ds = cols.Dataset({"a": cols.NumericColumn(tys.Real, X[:, 0].astype(float),
                                                   X[:, 1] > 0)})
        vec_stage = V.RealVectorizer().set_input(a).fit(ds)
        if V is PV:
            vec_stage.to("cpu")
        ds = ds.with_column(vec_stage.get_output().name, vec_stage.transform_dataset(ds))
        drop = Tr.DropIndicesByTransformer(lambda c: c.indicator_value is not None)
        drop.set_input(vec_stage.get_output())
        col = ds[vec_stage.get_output().name]
        host = drop.transform_columns([col])
        prep = drop.jax_host_prep([col]) if hasattr(drop, "jax_host_prep") else \
            drop.torch_host_prep([col])
        dev = drop.jax_transform(*prep) if hasattr(drop, "jax_transform") else \
            drop.torch_transform(*prep)
        out.append((np.asarray(host.values if not hasattr(host, "numpy") else host.numpy()),
                    _np(dev), [c.indicator_value for c in host.metadata.columns]))
    (jh, jd, jm), (ph, pd_, pm) = out
    assert jh.shape == (200, 1) and np.array_equal(jh, ph) and np.array_equal(jd, pd_)
    assert jm == pm == [None]


def _object_pair(values, jt, pt):
    jc = JC.ObjectColumn(jt, np.array(values, dtype=object))
    pc = PC.ObjectColumn(pt, np.array(values, dtype=object))
    return jc, pc


def _values(col):
    return [col.to_scalar(i).value for i in range(len(col))]


def test_value_munging_transformers_match_jax():
    words = ["adult", "Child", None, "", "adult", "teen"]
    for make in (lambda M, T: M.LambdaTransformer(
                     lambda v: None if v.value is None else v.value.upper(), T.Text, T.Text),
                 lambda M, T: M.FilterTransformer(lambda v: v.startswith("a"), T.Text),
                 lambda M, T: M.ReplaceTransformer("adult", "grown", T.Text),
                 lambda M, T: M.ExistsTransformer(T.Text),
                 lambda M, T: M.ToOccurTransformer(T.Text)):
        got = []
        for M, T, pkg in ((JTr, JT, J), (PTr, PT, P)):
            f = pkg.FeatureBuilder("w", T.Text).extract(field="w").as_predictor()
            st = make(M, T).set_input(f)
            col = (JC if pkg is J else PC).ObjectColumn(T.Text, np.array(words, dtype=object))
            got.append(_values(st.transform_columns([col])))
        assert got[0] == got[1]
    got = []
    for M, T, pkg, C in ((JTr, JT, J, JC), (PTr, PT, P, PC)):
        a = pkg.FeatureBuilder("a", T.Text).extract(field="a").as_predictor()
        b = pkg.FeatureBuilder("b", T.Text).extract(field="b").as_predictor()
        st = M.SubstringTransformer().set_input(a, b)
        got.append(_values(st.transform_columns([
            C.ObjectColumn(T.Text, np.array(["Hello", "abc", None, "xyz"], dtype=object)),
            C.ObjectColumn(T.Text, np.array(["ell", "Z", "a", "y"], dtype=object))])))
    assert got[0] == got[1] == [True, False, None, True]
    got = []
    for M, T, pkg, C in ((JTx, JT, J, JC), (PTx, PT, P, PC)):
        f = pkg.FeatureBuilder("i", T.RealNN).extract(field="i").as_predictor()
        st = M.OpIndexToString(["a", "b", "c"]).set_input(f)
        got.append(_values(st.transform_columns([
            C.NumericColumn(T.RealNN, np.array([0.0, 2.0, 5.0, -1.0]), np.ones(4, bool))])))
    assert got[0] == got[1] == ["a", "c", None, None]


def test_prediction_deindexer_matches_jax():
    got = []
    for M, T, pkg, C in ((JTr, JT, J, JC), (PTr, PT, P, PC)):
        f = pkg.FeatureBuilder("p", T.Prediction).extract(field="p").as_predictor()
        st = M.PredictionDeIndexer(["no", "yes"]).set_input(f)
        col = C.PredictionColumn(T.Prediction, prediction=np.array([0.0, 1.0, 3.0]),
                                 raw_prediction=np.zeros((3, 2)), probability=np.zeros((3, 2)))
        got.append(list(st.transform_columns([col]).values))
    assert got[0] == got[1] == ["no", "yes", None]


def test_transmogrify_takes_binary_and_realnn_features():
    raw = _columns(9)
    jf, jds, pf, pds = _pair(raw)
    outs = []
    for feats, ds, tm in ((jf, jds, jtransmogrify), (pf, pds, ptransmogrify)):
        vec = tm([feats["b"], feats["y"], feats["x"]])
        stages = []
        for layer in (J if tm is jtransmogrify else P).OpWorkflow().set_result_features(
                vec).dag:
            stages += layer
        for st in stages:
            model = st.fit(ds) if hasattr(st, "fit_columns") else st
            if tm is ptransmogrify:
                model.to("cpu")
            ds = ds.with_column(model.get_output().name, model.transform_dataset(ds))
        col = ds[vec.name]
        outs.append((np.asarray(col.values) if tm is jtransmogrify else col.numpy(),
                     [(c.parent_feature_name, c.indicator_value) for c in col.metadata.columns],
                     sorted(type(s).__name__ for s in stages)))
    (jv, jm, js), (pv, pm, ps) = outs
    assert js == ps and "BinaryVectorizer" in ps and "RealNNVectorizer" in ps
    assert jm == pm and np.array_equal(jv, pv)


def test_numeric_scale_rejects_what_its_kernel_does_not_take():
    v, m = torch.zeros(4), torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown scale mode"):
        L.numeric_scale("nope", v, m)
    with pytest.raises(ValueError, match="splits"):
        L.numeric_scale("bucket", v, m, splits=torch.zeros(L.MAX_SPLITS + 1))
    with pytest.raises(ValueError, match="shift"):
        L.column_affine(torch.zeros((4, 3)), torch.zeros(2), torch.ones(3))
    before = L.numeric_scale.launches, L.column_affine.launches
    L.numeric_scale("fill", v, m, 1.0)
    L.column_affine(torch.zeros((4, 3)), torch.zeros(3), torch.ones(3))
    assert (L.numeric_scale.launches, L.column_affine.launches) == before   # plain on the CPU
