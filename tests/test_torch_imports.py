"""The PyTorch port stands alone: no JAX, no pandas, nothing of the JAX
package, and no silent CPU fallback.

- A full CPU scoring run of the committed fixture, and CPU training runs of
  the Titanic flow (XGBoost with a save and a reload; logistic regression
  and random forest through the fused sweep; a streamed Spearman sanity
  check and the streamed statistics; the text flow's Word2Vec and LDA, and
  the JAX-saved text model's scores; the OpTitanicSimple flow through the
  streaming executor at a lowered threshold, and the JAX-saved
  OpTitanicSimple model's scores; round-collapsed XGBoost under the
  multiclass selector, the train/validation split and
  ``parallel/sweep.sharded_logistic_sweep``; a deploy and a score through the
  serving plane, ``serve/``), each case in a fresh interpreter at one
  thread with its own time limit, leave no ``jax*``, ``pandas*`` or
  ``transmogrifai_tpu[.*]`` module loaded.
- A scan of the port's sources finds no such import; pandas appears only
  inside the reader's DataFrame branch, and Triton only
  in the kernel modules that the launching wrappers import lazily.
- With no CUDA device, the entry points raise unless ``device="cpu"`` is
  given, and the serving plane's registry and ``serve_devices`` unless
  ``devices=[torch.device("cpu")]`` is.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "transmogrifai_tpu_torch")
#: the only place pandas may be imported: inside this function
PANDAS_OK = {("readers/base.py", "_frame_columns")}
TRITON_MODULES = {"ops/triton_vectorize.py": "triton_vectorize",
                  "ops/triton_boost.py": "triton_boost",
                  "ops/triton_forest.py": "triton_forest"}

#: the start of every case: one thread, the port and its fixtures
PRELUDE = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import titanic
from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression
"""
#: the end of every case: the modules that must not be loaded
EPILOGUE = r"""
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "pandas", "transmogrifai_tpu"))
print("BAD=" + ",".join(bad))
"""
#: one fresh interpreter a case, each with its own time limit (seconds)
CASES = {
    "serve": (r"""
m = P.load_model(FX.TITANIC_XGB, device="cpu")
cols = FX.load_columns(FX.TITANIC_XGB + "/requests.npz")
s = m.score(cols)
out = P.BatchScoreFunction(m)(FX.records(cols)[:8])
one = P.ScoreFunction(m)(FX.records(cols)[0])
assert len(s) == len(cols["Age"]) and len(out) == 8 and one
""", 120),
    "xgb_train_save_reload": (r"""
import tempfile
from transmogrifai_tpu_torch.impl.classification.trees import OpXGBoostClassifier
grid = [{"num_round": 2, "max_depth": 2, "min_child_weight": 1.0}]
trained, _ = titanic.train_titanic(
    titanic.titanic_data(120, 1), device="cpu", model_types=None,
    models_and_parameters=[(OpXGBoostClassifier(), grid)])
with tempfile.TemporaryDirectory() as tmp:
    trained.save(tmp)
    again = P.load_model(tmp, device="cpu").score(titanic.titanic_data(50, 2))
assert len(again) == 50
""", 180),
    "fused_sweep": (r"""
from transmogrifai_tpu_torch.impl.classification.trees import OpRandomForestClassifier
stock, _ = titanic.train_titanic(
    titanic.titanic_data(120, 1), device="cpu", models_and_parameters=[
        (OpLogisticRegression(), [{"reg_param": 0.01, "elastic_net_param": 0.5}]),
        (OpRandomForestClassifier(), [{"num_trees": 3, "max_depth": 3}])])
assert len(stock.stages[-1].summary.validation_results) == 2
""", 180),
    "streamed_spearman": (r"""
streamed, _ = titanic.train_titanic(
    titanic.titanic_data(120, 1), device="cpu", models_and_parameters=[
        (OpLogisticRegression(), [{"reg_param": 0.01, "elastic_net_param": 0.0}])],
    sanity_check_params={"correlation_type": "spearman", "sharded_stats": True})
from transmogrifai_tpu_torch.parallel import stats as PS
X = np.random.default_rng(0).normal(size=(300, 4)).astype(np.float32)
assert PS.sharded_correlations(X, X[:, 0], chunk_rows=128, method="spearman",
                               device="cpu")[0].count == 300
""", 180),
    "text_flow": (r"""
text, _ = titanic.train_titanic(
    titanic.text_columns(120, 1), device="cpu", text_embeddings=True, models_and_parameters=[
        (OpLogisticRegression(), [{"reg_param": 0.01, "elastic_net_param": 0.5}])])
assert {"OpWord2VecModel", "OpLDAModel"} <= {type(s).__name__ for s in text.stages}
tm = P.load_model(FX.TITANIC_TEXT, device="cpu")
assert len(P.BatchScoreFunction(tm)(FX.records(FX.load_columns(
    FX.TITANIC_TEXT + "/requests.npz"))[:4])) == 4
""", 240),
    "titanic_simple_streamed": (r"""
from transmogrifai_tpu_torch.workflow import dag, stream
dag.STREAM_ROWS, stream.CHUNK_ROWS = 100, 64
simple, _ = titanic.train_titanic(
    titanic.titanic_data(300, 1), device="cpu", reference_features=True,
    models_and_parameters=[
        (OpLogisticRegression(), [{"reg_param": 0.01, "elastic_net_param": 0.5}])])
assert stream.stream_stats()["chunks"] > 0
assert len(simple.score(titanic.titanic_data(200, 2))) == 200
sm = P.load_model(FX.TITANIC_SIMPLE, device="cpu")
assert len(P.BatchScoreFunction(sm)(FX.records(FX.load_columns(
    FX.TITANIC_SIMPLE + "/requests.npz"))[:4])) == 4
""", 180),
    "collapse_branches_sweep": (r"""
import os
from transmogrifai_tpu_torch.impl.classification.trees import OpXGBoostClassifier
from transmogrifai_tpu_torch.parallel import sweep as PS
os.environ["TMOG_GBT_ROUND_COLLAPSE"] = "2"
grid = [{"num_round": 4, "max_depth": 2, "subsample": 0.8}]
m, _ = titanic.train_titanic(titanic.titanic_data(120, 1), device="cpu", selector="multiclass",
                             models_and_parameters=[(OpXGBoostClassifier(), grid)])
assert abs(float(m.stages[-1].model_params["eta"]) - 0.15) < 1e-9
s, _ = titanic.train_titanic(titanic.titanic_data(120, 1), device="cpu", selector="split",
                             models_and_parameters=[(OpLogisticRegression(), [{"reg_param": 0.01}])])
assert s.stages[-1].summary.validation_type.endswith("OpTrainValidationSplit")
X = np.random.default_rng(0).normal(size=(200, 4)).astype(np.float32)
err, _, _ = PS.sharded_logistic_sweep(X, (X[:, 0] > 0).astype(np.float32),
                                      np.array([0.1], np.float32), device="cpu")
assert err.shape == (1,)
""", 180),
    "serve_plane": (r"""
from transmogrifai_tpu_torch.serve import MicroBatcher, ModelRegistry
reg = ModelRegistry(max_batch=4, devices=[torch.device("cpu")])
reg.deploy(P.load_model(FX.BOSTON_RIDGE, device="cpu"))
b = MicroBatcher(reg, max_batch=4).start()
try:
    out = b.score({"rm": 6.0, "chas": 0, "crim": None}, timeout_s=30)
finally:
    b.stop()
assert reg.replica(0).scorer is not None and "prediction" in next(iter(out.values()))
""", 120),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_scoring_run_loads_no_jax_pandas_or_jax_package(case):
    body, timeout = CASES[case]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", PRELUDE + body + EPILOGUE],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("BAD=")][-1]
    assert line == "BAD=", line


def _imports(tree):
    """(module name, enclosing function or None) for every import."""
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            f = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                else func
            if isinstance(child, ast.Import):
                found.extend((a.name, func) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module or "", func))
            visit(child, f)

    visit(tree, None)
    return found


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                yield os.path.relpath(path, PKG).replace(os.sep, "/"), path


def test_sources_import_no_jax_pandas_or_jax_package():
    problems = []
    for rel, path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for mod, func in _imports(tree):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "transmogrifai_tpu"):
                problems.append(f"{rel}: imports {mod}")
            if top == "pandas" and (rel, func) not in PANDAS_OK:
                problems.append(f"{rel}: imports pandas in {func or 'module scope'}")
            if top == "triton" and rel not in TRITON_MODULES:
                problems.append(f"{rel}: imports triton")
            if mod.split(".")[-1] in TRITON_MODULES.values() and func is None:
                problems.append(f"{rel}: imports the Triton kernels at module scope")
    assert not problems, problems
    for rel, path in _sources():  # relative imports of the Triton modules too
        with open(path) as fh:
            for node in ast.parse(fh.read()).body:
                if isinstance(node, ast.ImportFrom) and any(
                        a.name in TRITON_MODULES.values() for a in node.names):
                    problems.append(f"{rel}: imports the Triton kernels at module scope")
    assert not problems, problems


def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is available")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        P.load_model(FX.TITANIC_XGB)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        P.resolve_device("cuda")
    unplaced = P.load_model(FX.TITANIC_XGB, device="cpu")
    unplaced.device = None
    with pytest.raises(RuntimeError, match='device="cpu"'):
        P.BatchScoreFunction(unplaced)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        P.ScoreFunction(unplaced)
    assert P.load_model(FX.TITANIC_XGB, device="cpu").device == torch.device("cpu")
    from transmogrifai_tpu_torch.apps import titanic

    wf, _ = titanic.build_workflow()
    wf.set_input_dataset(titanic.titanic_data(60, 3), key="PassengerId")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        wf.train()


def test_serving_plane_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is available")
    from transmogrifai_tpu_torch.parallel.mesh import serve_devices
    from transmogrifai_tpu_torch.serve import ModelRegistry

    for call in (serve_devices, ModelRegistry, lambda: ModelRegistry(replicas=2)):
        with pytest.raises(RuntimeError, match=r'devices=\[torch.device\("cpu"\)\]'):
            call()
    assert ModelRegistry(devices=[torch.device("cpu")]).n_replicas == 1


def test_serving_plane_sources_are_scanned():
    """The import scan above covers the serving plane's packages."""
    scanned = {rel for rel, _ in _sources()}
    for rel in ("obs/registry.py", "obs/trace.py", "obs/slo.py", "resilience/inject.py",
                "resilience/circuit.py", "resilience/retry.py", "resilience/quarantine.py",
                "parallel/mesh.py", "serve/aot.py", "serve/batcher.py", "serve/registry.py",
                "serve/server.py", "serve/contract.py", "serve/metrics.py",
                "serve/supervisor.py"):
        assert rel in scanned, rel


def test_model_class_paths_map_to_the_port():
    from transmogrifai_tpu_torch.workflow.serialization import _resolve_class, port_module

    assert port_module("transmogrifai_tpu.impl.feature.vectorizers") == \
        "transmogrifai_tpu_torch.impl.feature.vectorizers"
    assert port_module("transmogrifai_tpu_torch.ops.trees") == "transmogrifai_tpu_torch.ops.trees"
    assert port_module("transmogrifai_tpu") == "transmogrifai_tpu_torch"
    assert port_module("mypkg.transmogrifai_tpu.x") == "mypkg.transmogrifai_tpu.x"
    cls = _resolve_class("transmogrifai_tpu.impl.classification.trees:OpXGBoostClassifier")
    assert cls.__module__ == "transmogrifai_tpu_torch.impl.classification.trees"
    with pytest.raises(NotImplementedError, match="not ported"):
        _resolve_class("transmogrifai_tpu.impl.feature.dates:DateListVectorizer")
