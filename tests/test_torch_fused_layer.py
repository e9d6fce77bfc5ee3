"""The fused layer's arithmetic and column gathers (K-Z) on the port against the JAX package's, on the CPU.

``transmogrifai_tpu_torch/ops/layer.py`` ports the device programs of the
JAX package's fused layer and streamed chunk program that K-C and K-D do not:
the numeric arithmetic of ``_NumericBinaryOp`` / ``ScalarMathTransformer``
(``numeric_op``) and the column gathers of ``VectorsCombiner`` /
``SanityCheckerModel`` (``column_gather``, ``concat_columns``).  On CPU
tensors the kernels' plain versions run.  ``tests/test_torch_vectorizers.py``
holds the stages on the Titanic frame against the JAX package; these cases
add what it does not reach, on numpy inputs made from a seed:

- the scalar operations beyond its scalar 2.0 (a general power, log, exp,
  round to whole numbers, a division each way), with absent rows, zeros and
  overflows: masks equal, values within ``APPROX_RTOL`` where XLA's CPU code
  evaluates them by its own approximations (the largest gap measured over
  these cases was 1.94e-7 relative, under 2 float32 ulps), else bit-equal;
- a concatenation of more inputs than one gather launch takes, an empty and
  a full keep-set, any gather map, and the wrappers' input checks;
- past ``dag.STREAM_ROWS`` rows a layer's lone fusable stage runs its device
  program, as the JAX package streams it; at or below, its host path.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.impl.feature import transformers as JT
from transmogrifai_tpu.impl.feature import vectorizers as JV
from transmogrifai_tpu.impl.preparators import sanity_checker as JSC

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.columns import Dataset, NumericColumn
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.impl.feature import transformers as PT
from transmogrifai_tpu_torch.impl.feature import vectorizers as PV
from transmogrifai_tpu_torch.impl.preparators import sanity_checker as PSC
from transmogrifai_tpu_torch.ops import layer as L
from transmogrifai_tpu_torch.workflow import dag

torch.set_num_threads(1)

#: log, exp, power and rdivide: the JAX package's XLA CPU
#: approximations against torch's correctly rounded or libm results, 2
#: float32 ulps (measured: 1.94e-7 relative)
APPROX_RTOL = 2.0 ** -22
APPROX = {"log", "exp", "power", "rdivide"}


def _column(rng, n, kind):
    """(values f32[n], presence bool[n]) with absent rows, zeros and, for
    ``kind`` "wide", values that overflow exp and round at a tie."""
    v = (rng.normal(size=n) * 4).astype(np.float32)
    if kind == "wide":
        v[::7] = 0.0
        v[1::11] = 100.0
        v[2::13] = 0.125
        v[3::17] = -2.5
    m = rng.random(n) > 0.2
    return v, m


def _jax_pair(out):
    v, m = out
    return np.asarray(v), np.asarray(m)


def _held(op, got, want):
    gv, gm = (t.numpy() for t in got)
    wv, wm = want
    assert gv.dtype == np.float32 and np.array_equal(gm, wm)
    if op in APPROX:
        scale = np.maximum(np.abs(wv), 1e-30)
        assert float((np.abs(gv - wv) / scale).max()) <= APPROX_RTOL
    else:
        assert np.array_equal(gv, wv)


@pytest.mark.parametrize("op,scalar", [("power", 2.0), ("power", 0.5), ("power", 1.7),
                                       ("log", 0.0), ("exp", 0.0), ("round", 0.0),
                                       ("divide", 7.0), ("rdivide", 3.0)])
def test_scalar_math_matches_jax(op, scalar):
    rng = np.random.default_rng(int(scalar * 10) + len(op))
    v, m = _column(rng, 3000, "wide")
    if op in ("log", "sqrt", "power"):
        v = np.abs(v)
    want = _jax_pair(JT.ScalarMathTransformer(op, scalar).jax_transform(v, m))
    got = PT.ScalarMathTransformer(op, scalar).torch_transform(torch.from_numpy(v),
                                                               torch.from_numpy(m))
    _held(op, got, want)


def test_numeric_op_rejects_what_its_kernel_does_not_take():
    v, m = torch.zeros(4), torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        L.numeric_op("power", v, m, v, m)  # power is a scalar operation only
    with pytest.raises(ValueError):
        L.numeric_op("plus", v.double(), m)
    with pytest.raises(ValueError):
        L.numeric_op("nope", v, m)


def test_vectors_combiner_matches_jax_past_one_launchs_sources():
    """69 inputs: more than a column_gather launch takes, joined in groups."""
    widths = tuple(range(1, 70))
    rng = np.random.default_rng(len(widths))
    mats = [rng.normal(size=(500, w)).astype(np.float32) for w in widths]
    want = np.asarray(JV.VectorsCombiner().jax_transform(*mats))
    got = PV.VectorsCombiner().torch_transform(*(torch.from_numpy(a) for a in mats))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("keep", [list(range(24)), []])
def test_sanity_checker_gather_matches_jax(keep):
    rng = np.random.default_rng(len(keep))
    X = rng.normal(size=(700, 24)).astype(np.float32)
    want = np.asarray(JSC.SanityCheckerModel(np.array(keep, int), None).jax_transform(X))
    model = PSC.SanityCheckerModel(np.array(keep, int), None)
    got = model.torch_transform(torch.from_numpy(X))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


def test_column_gather_plain_in_any_order():
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    b = -torch.arange(6, dtype=torch.float32).reshape(3, 2)
    got = L.column_gather([a, b], [1, 0, 0, 1], [1, 3, 0, 1])
    assert torch.equal(got, torch.stack([b[:, 1], a[:, 3], a[:, 0], b[:, 1]], dim=1))
    with pytest.raises(ValueError):
        L.column_gather([a, b], [2], [0])
    with pytest.raises(ValueError):
        L.column_gather([a], [0], [4])


@pytest.mark.parametrize("rows,device_path", [(dag.STREAM_ROWS, False),
                                              (dag.STREAM_ROWS + 1, True)])
def test_lone_numeric_stage_runs_its_device_program_past_the_stream_rows(
        monkeypatch, rows, device_path):
    """A layer of one AddTransformer: the host float64 path at or below
    ``STREAM_ROWS`` rows, the device program (K-Z) above, where the JAX
    package streams it; the values agree (integers, as the Titanic flow's
    family size)."""
    sib = FeatureBuilder("SibSp", T.Integral).extract(field="SibSp").as_predictor()
    par = FeatureBuilder("Parch", T.Integral).extract(field="Parch").as_predictor()
    add = PT.AddTransformer().set_input(sib, par).to("cpu")
    rng = np.random.default_rng(rows)
    ds = Dataset({"SibSp": NumericColumn(T.Integral, rng.integers(0, 4, rows).astype(float),
                                         rng.random(rows) > 0.1),
                  "Parch": NumericColumn(T.Integral, rng.integers(0, 3, rows).astype(float),
                                         rng.random(rows) > 0.1)})
    calls = []
    real = L.numeric_op

    def counted(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(L, "numeric_op", counted)
    out = dag._apply_layer_transforms(ds, [add])[add.get_outputs()[0].name]
    assert calls == (["plus"] if device_path else [])
    a, b = ds["SibSp"], ds["Parch"]
    want_v, want_m = JT.AddTransformer()._compute(np, a.values, a.mask, b.values, b.mask)
    assert np.array_equal(out.mask, want_m) and np.array_equal(out.values, want_v)
