"""The per-family sweep's failure tolerance, on the port against the JAX
package's, on the CPU.

A candidate whose fit, prediction or evaluation raises is recorded with
its error (``"<type>: <message>"``) and the worst metric, and the sweep
goes on (OpValidator.scala:323-353; the JAX package's
``impl/tuning/validators.py:186-208``).  Two kinds of exception end the
sweep instead: a kernel fault (``ops/cuda_build.KernelError``) and an
unported branch (``NotImplementedError``), since no fallback may hide a
kernel or turn a branch the port lacks into a lost candidate.  A
subclassed estimator builds no fused plan in either package (exact types
only), so these candidates take the per-family path.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators.classification import (
    OpBinaryClassificationEvaluator as JBinEv)
from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression as JLR
from transmogrifai_tpu.impl.tuning.validators import OpCrossValidation as JCV

from transmogrifai_tpu_torch.evaluators.classification import (
    OpBinaryClassificationEvaluator as PBinEv)
from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.impl.tuning.validators import OpCrossValidation as PCV
from transmogrifai_tpu_torch.ops.cuda_build import KernelError

torch.set_num_threads(1)


def _data(n=200, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    y = (X @ np.array([1.0, -2.0, 0.5, 0.0]) + 0.3 * rng.standard_normal(n) > 0)
    return X, y.astype(np.float32)


def _exploding(base, exc):
    class Exploding(base):
        def fit_grid_folds(self, *a, **k):
            raise NotImplementedError

        def fit_arrays(self, *a, **k):
            raise exc

    return Exploding


@pytest.mark.parametrize("plain", [{"reg_param": 0.01},
                                   {"reg_param": 0.01, "elastic_net_param": 0.5}])
def test_a_failed_candidate_is_recorded_as_the_jax_package_records_it(plain):
    """An ``OpLogisticRegression`` whose fit raises ``RuntimeError("boom")``
    beside a plain LR point (Newton, or FISTA), under ``OpCrossValidation``:
    errors ``['RuntimeError: boom', None]`` and index 1 chosen in both
    packages, the plain point's fold AuPR alike."""
    X, y = _data()
    js = JCV(JBinEv(), num_folds=3, seed=7).validate(
        [(_exploding(JLR, RuntimeError("boom"))(), [{}]), (JLR(), [plain])], X, y)
    ps = PCV(PBinEv(), num_folds=3, seed=7).validate(
        [(_exploding(PLR, RuntimeError("boom"))().to("cpu"), [{}]), (PLR().to("cpu"), [plain])],
        torch.from_numpy(X), y)
    assert [r.error for r in js.results] == ["RuntimeError: boom", None]
    assert [r.error for r in ps.results] == [r.error for r in js.results]
    assert js.best_index == ps.best_index == 1
    assert ps.results[0].metric_value == js.results[0].metric_value == -np.inf
    np.testing.assert_allclose(ps.results[1].fold_metrics, js.results[1].fold_metrics,
                               rtol=0, atol=1e-6)


def test_all_candidates_failing_raises_in_both_packages():
    X, y = _data()
    with pytest.raises(RuntimeError, match="All models"):
        JCV(JBinEv(), num_folds=3).validate([(_exploding(JLR, RuntimeError("boom"))(), [{}])],
                                            X, y)
    with pytest.raises(RuntimeError, match="All models"):
        PCV(PBinEv(), num_folds=3).validate(
            [(_exploding(PLR, RuntimeError("boom"))().to("cpu"), [{}])], torch.from_numpy(X), y)


@pytest.mark.parametrize("exc", [KernelError("level_hist kernel launch failed: CUDA error 1"),
                                 NotImplementedError("an unported branch")])
def test_a_kernel_fault_or_an_unported_branch_ends_the_sweep(exc):
    """A ``KernelError`` (also a ``RuntimeError``) or a
    ``NotImplementedError`` in a candidate's fit makes ``validate`` raise
    it, though a plain candidate beside it would fit."""
    X, y = _data()
    with pytest.raises(type(exc), match=str(exc).split(":")[0]):
        PCV(PBinEv(), num_folds=3).validate(
            [(_exploding(PLR, exc)().to("cpu"), [{}]), (PLR().to("cpu"), [{"reg_param": 0.01}])],
            torch.from_numpy(X), y)
    assert issubclass(KernelError, RuntimeError)
