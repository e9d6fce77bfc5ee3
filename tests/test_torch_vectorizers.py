"""PyTorch port vs JAX package: the serve slice's stage transforms.

Each stage is fitted by the JAX package on data made from a seed, carried
into the port through the model format (the JAX package's stage encoder,
the port's decoder) and applied to the same input columns.  Outputs must be
bit-equal, in values and in ``VectorMetadata``, to both of the JAX stage's
paths: ``transform_columns`` (host) and ``jax_transform`` (the fused
layer).  On the CPU the port's K-C / K-D wrappers run their plain versions.

The raw columns come from each package's reader over the same data, so the
reader's numeric coercion (``pd.to_numeric(errors="coerce")`` in the JAX
package, numpy in the port) is held equal too.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.columns as JC
import transmogrifai_tpu.types as JT
from transmogrifai_tpu.impl.feature.bucketizers import (DecisionTreeNumericBucketizer,
                                                        NumericBucketizer)
from transmogrifai_tpu.impl.feature.hashing import hash_term as j_hash_term
from transmogrifai_tpu.impl.feature.smart_text import SmartTextVectorizer
from transmogrifai_tpu.impl.feature.transformers import (AddTransformer, AliasTransformer,
                                                         DivideTransformer,
                                                         MultiplyTransformer,
                                                         ScalarMathTransformer,
                                                         SubtractTransformer)
from transmogrifai_tpu.impl.feature.vectorizers import (OneHotVectorizer, RealVectorizer,
                                                        VectorsCombiner)
from transmogrifai_tpu.impl.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu.readers.base import CustomReader as JReader
from transmogrifai_tpu.workflow import dag as jdag
from transmogrifai_tpu.workflow.serialization import _encode_stage

import transmogrifai_tpu_torch.columns as PC
import transmogrifai_tpu_torch.types as PT
from transmogrifai_tpu_torch.features.feature import Feature as PFeature
from transmogrifai_tpu_torch.features.metadata import VectorMetadata as PVectorMetadata
from transmogrifai_tpu_torch.impl.feature.hashing import hash_term as p_hash_term
from transmogrifai_tpu_torch.readers.base import CustomReader as PReader
from transmogrifai_tpu_torch.impl.feature._util import run_on_device
from transmogrifai_tpu_torch.workflow.serialization import _decode_stage

torch.set_num_threads(1)
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# carrying data and stages across
# ---------------------------------------------------------------------------
def _frame(n=200, seed=0):
    rng = np.random.default_rng(seed)
    age = rng.uniform(1, 80, n).astype(object)
    age[rng.random(n) < 0.15] = None
    age[3], age[4], age[5] = "abc", "1.5", " 2 "       # coerced like pd.to_numeric
    fare = rng.uniform(5, 100, n)
    fare[rng.random(n) < 0.1] = np.nan
    fare[7], fare[8] = np.inf, -np.inf
    emb = rng.choice(["S", "C", "Q", "X"], n).astype(object)
    emb[rng.random(n) < 0.1] = None
    emb[9] = np.nan
    name = rng.choice(["alice smith", "bob the builder", "carol", "dave", "Éve Ünder",
                       "the and of"], n).astype(object)
    name[rng.random(n) < 0.1] = None
    return pd.DataFrame({
        "label": (rng.random(n) < 0.4).astype(float),
        "age": age, "fare": fare,
        "sibsp": rng.integers(0, 4, n), "parch": rng.integers(0, 3, n),
        "pclass": rng.choice([1, 2, 3], n),
        "sex": rng.choice(["male", "female"], n),
        "embarked": emb, "name": name,
        "tags": [set(rng.choice(["a", "b", "c"], rng.integers(0, 3), replace=False))
                 for _ in range(n)],
    })


SPEC = {"label": JT.RealNN, "age": JT.Real, "fare": JT.Real, "sibsp": JT.Integral,
        "parch": JT.Integral, "pclass": JT.PickList, "sex": JT.PickList,
        "embarked": JT.PickList, "name": JT.Text, "tags": JT.MultiPickList}


def _raw(df):
    feats = {}
    for name, t in SPEC.items():
        b = J.FeatureBuilder(name, t).extract(field=name)
        feats[name] = b.as_response() if name == "label" else b.as_predictor()
    ds = JReader(df).generate_dataset(list(feats.values()))
    return feats, ds


def _port_feature(f):
    return PFeature(name=f.name, ftype=PT.feature_type_by_name(f.ftype.__name__),
                    is_response=f.is_response, origin_stage=None, uid=f.uid)


def _port_col(c):
    ft = PT.feature_type_by_name(c.ftype.__name__)
    if isinstance(c, JC.NumericColumn):
        return PC.NumericColumn(ft, c.values.copy(), c.mask.copy())
    if isinstance(c, JC.VectorColumn):
        meta = None if c.metadata is None else PVectorMetadata.from_json(c.metadata.to_json())
        return PC.VectorColumn(ft, np.array(c.values), meta)
    return PC.ObjectColumn(ft, c.values.copy())


def _carry(jstage):
    arrays = {}
    pstage = _decode_stage(_encode_stage(jstage, arrays), arrays)
    pstage.inputs = tuple(_port_feature(f) for f in jstage.inputs)
    return pstage.to(CPU)


def _fit(est, ds, *inputs):
    est.set_input(*inputs)
    model = est.fit(ds) if hasattr(est, "fit") else est
    return model


def _assert_same(pcol, jcol):
    if isinstance(jcol, JC.VectorColumn):
        assert isinstance(pcol, PC.VectorColumn)
        got = pcol.numpy()
        assert got.dtype == np.float32 and got.shape == jcol.values.shape
        np.testing.assert_array_equal(got, jcol.values)
        assert (pcol.metadata is None) == (jcol.metadata is None)
        if jcol.metadata is not None:
            assert pcol.metadata.to_json() == jcol.metadata.to_json()
    else:
        np.testing.assert_array_equal(pcol.values, jcol.values)
        assert pcol.values.dtype == jcol.values.dtype
        np.testing.assert_array_equal(pcol.mask, jcol.mask)


def _check_stage(jstage, jds, fused=True, fused_ulp=0):
    """Port transform == JAX transform_columns (and jax_transform)."""
    pstage = _carry(jstage)
    jcols = [jds[f.name] for f in jstage.inputs]
    pcols = [_port_col(c) for c in jcols]
    want = jstage.transform_columns(jcols)
    got = pstage.transform_columns(pcols)
    _assert_same(got, want)
    if fused and hasattr(jstage, "jax_transform"):
        jf = jdag._fused_layer(jds, [jstage])[jstage.get_outputs()[0].name]
        pf = run_on_device(pstage, pcols)
        if fused_ulp:
            np.testing.assert_array_max_ulp(pf.values, jf.values, maxulp=fused_ulp)
            np.testing.assert_array_equal(pf.mask, jf.mask)
        else:
            _assert_same(pf, jf)
    return pstage, got


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_reader_columns_match():
    df = _frame()
    feats, jds = _raw(df)
    pfeats = {n: _port_feature(f) for n, f in feats.items()}
    for n, f in pfeats.items():  # origin stages for the port reader
        object.__setattr__(f, "origin_stage", _carry_generator(feats[n]))
    cols = {c: df[c].to_numpy() for c in df.columns}
    for data in (cols, df):
        pds = PReader(data).generate_dataset(list(pfeats.values()))
        for n in SPEC:
            jc, pc = jds[n], pds[n]
            if isinstance(jc, JC.NumericColumn):
                _assert_same(pc, jc)
            else:
                assert list(pc.values) == list(jc.values), n


def _carry_generator(jfeat):
    from transmogrifai_tpu_torch.features.generator import (FeatureGeneratorStage,
                                                            FieldExtractor)

    st = jfeat.origin_stage
    ft = PT.feature_type_by_name(jfeat.ftype.__name__)
    return FeatureGeneratorStage(FieldExtractor(st.extract_fn.field_name, ft), ft,
                                 jfeat.name, is_response=jfeat.is_response, uid=st.uid)


@pytest.mark.parametrize("track_nulls", [True, False])
def test_real_vectorizer(track_nulls):
    feats, jds = _raw(_frame())
    m = _fit(RealVectorizer(track_nulls=track_nulls), jds, feats["age"], feats["fare"])
    _check_stage(m, jds)


@pytest.mark.parametrize("track_nulls", [True, False])
def test_one_hot_vectorizer(track_nulls):
    # unseen categories: fit on a slice without "X"; nulls: None and NaN
    df = _frame()
    feats, jds = _raw(df)
    fit_ds = jds.take(np.nonzero(df["embarked"].to_numpy() != "X")[0])
    m = _fit(OneHotVectorizer(top_k=2, min_support=1, track_nulls=track_nulls), fit_ds,
             feats["embarked"], feats["pclass"], feats["sex"], feats["sibsp"])
    pstage, _ = _check_stage(m, jds)
    assert pstage.torch_host_ready([_port_col(jds[f.name]) for f in m.inputs])


def test_one_hot_vectorizer_collections_take_the_host_path():
    feats, jds = _raw(_frame())
    m = _fit(OneHotVectorizer(top_k=5, min_support=1), jds, feats["tags"], feats["sex"])
    pstage, _ = _check_stage(m, jds, fused=False)
    assert not pstage.torch_host_ready([_port_col(jds[f.name]) for f in m.inputs])


def test_vectors_combiner():
    feats, jds = _raw(_frame())
    rv = _fit(RealVectorizer(), jds, feats["age"], feats["fare"])
    oh = _fit(OneHotVectorizer(min_support=1), jds, feats["sex"])
    jds = jds.with_columns({rv.get_output().name: rv.transform_dataset(jds),
                            oh.get_output().name: oh.transform_dataset(jds)})
    comb = VectorsCombiner().set_input(rv.get_output(), oh.get_output())
    _check_stage(comb, jds)


def test_bucketizers():
    df = _frame(n=400)
    df["age"] = np.where(df["label"] > 0, 20.0, 60.0) + np.arange(400) % 7
    feats, jds = _raw(df)
    dt = _fit(DecisionTreeNumericBucketizer(), jds, feats["label"], feats["age"])
    assert dt.did_split
    _check_stage(dt, jds)
    nb = NumericBucketizer([0.0, 10.0, 50.0, 90.0], track_invalid=True).set_input(feats["fare"])
    _check_stage(nb, jds)


@pytest.mark.parametrize("op", ["plus", "minus", "multiply", "divide", "abs", "sqrt",
                                "ceil", "floor", "round", "rminus", "rdivide"])
def test_scalar_math(op):
    # float32 fused path of "round": XLA rewrites the division by the
    # constant 10**digits as a product with its reciprocal, torch divides;
    # the two differ by at most one unit in the last place
    feats, jds = _raw(_frame())
    _check_stage(ScalarMathTransformer(op, 2.0).set_input(feats["fare"]), jds,
                 fused_ulp=1 if op == "round" else 0)


@pytest.mark.parametrize("cls", [AddTransformer, SubtractTransformer, MultiplyTransformer,
                                 DivideTransformer])
def test_binary_math_and_alias(cls):
    feats, jds = _raw(_frame())
    t = cls().set_input(feats["sibsp"], feats["age"])
    _check_stage(t, jds)
    jds = jds.with_column(t.get_output().name, t.transform_dataset(jds))
    alias = AliasTransformer("family").set_input(t.get_output())
    pstage = _carry(alias)
    assert pstage.get_outputs()[0].name == "family"
    _check_stage(alias, jds, fused=False)


def test_smart_text_categorical_and_hashed():
    feats, jds = _raw(_frame())
    m = _fit(SmartTextVectorizer(max_cardinality=4, num_hashes=16, min_support=1), jds,
             feats["name"], feats["embarked"])
    assert m.is_categorical == [False, True]
    _check_stage(m, jds)
    for term in ("", "a", "abc", "smith", "über", "日本"):
        assert p_hash_term(term, 64) == j_hash_term(term, 64)


def test_sanity_checker_gather():
    feats, jds = _raw(_frame())
    rv = _fit(RealVectorizer(), jds, feats["age"], feats["fare"])
    oh = _fit(OneHotVectorizer(min_support=1), jds, feats["sex"], feats["embarked"])
    comb = VectorsCombiner().set_input(rv.get_output(), oh.get_output())
    for s in (rv, oh, comb):
        jds = jds.with_column(s.get_output().name, s.transform_dataset(jds))
    sc = _fit(SanityChecker(min_variance=0.2), jds, feats["label"], comb.get_output())
    assert 0 < len(sc.indices_to_keep) < jds[comb.get_output().name].width
    _check_stage(sc, jds)
