"""K-H's margin update (``boost_step``) on the port against the JAX
package's, on the CPU.

XLA's CPU code contracts the reference's margin update ``F + eta *
leaf[row_node]`` (``transmogrifai_tpu/ops/trees.py`` ``_gbt_impl``) into a
fused multiply-add; rounding the product and the sum apart misses the
reference's margins by an ulp on many rows.  The trees of the reference's
own ``fit_gbt`` are replayed (each round's leaves found by the plain tree
walk) from the same base score:

- through ``metrics.fma``, for the logistic and the squared loss: the
  margins equal the reference's final margins bit for bit on every row,
  and rounding twice misses some;
- through ``boost_step_plain`` (K-H's plain version) for the logistic
  loss: bit for bit.  Its squared update still rounds twice, a stated gap
  (``ops/trees.py::boost_step``): with the fused update the Boston
  fixture's GBT folds leave their tolerance through other split flips.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.ops import trees as JT

from transmogrifai_tpu_torch.ops import metrics as PM
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)


def _frame(loss, seed=3, n=3000, d=6, n_bins=16):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, n_bins, (n, d)).astype(np.int8)
    z = Xb[:, 0].astype(np.float32) - 0.6 * Xb[:, 1] + rng.standard_normal(n) * 2
    if loss == "logistic":
        y = (z > 0).astype(np.float32)
    else:
        y = (z * 3.7 + 20.0).astype(np.float32)
    return Xb, y


def _replay(loss):
    """(the reference's final margins f32[n], its trees on the port, each
    row's leaf per round i32[n, R], base score, eta, rounds)."""
    Xb, y = _frame(loss)
    n, d = Xb.shape
    R, depth, n_bins = 12, 4, 16
    rng = np.random.default_rng(9)
    rw = (rng.random((R, n)) < 0.8).astype(np.float32)
    fm = np.ones((R, d), np.float32)
    w = rng.integers(1, 3, n).astype(np.float32)
    eta = 0.3 if loss == "logistic" else 0.1
    base = 0.0 if loss == "logistic" else float(np.float32(y.mean()))
    trees, Fj = JT.fit_gbt(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w), jnp.asarray(rw),
                           jnp.asarray(fm), loss, R, depth, n_bins, 16, eta=eta,
                           base_score=base)
    tree = PT.Tree(*(torch.from_numpy(np.array(a)) for a in trees))
    _, leaves = PT.ensemble_walk_plain(torch.from_numpy(Xb), tree, depth, return_leaves=True)
    return np.asarray(Fj)[:, 0], tree, leaves, y, base, eta, R


@pytest.mark.parametrize("loss", ["logistic", "squared"])
def test_the_references_update_is_one_fused_multiply_add(loss):
    ref, tree, leaves, _, base, eta, R = _replay(loss)
    n = ref.shape[0]
    fused = torch.full((n,), base, dtype=torch.float32)
    two = fused.clone()
    eta_t = torch.tensor(eta, dtype=torch.float32)
    for t in range(R):
        lv = tree.leaf_val[t, :, 0][leaves[:, t].long()]
        fused = PM.fma(eta_t.expand_as(lv), lv, fused)
        two = two + eta_t * lv
    differ = int(np.sum(fused.numpy() != ref))
    assert differ == 0, f"{differ} of {n} fused margins differ from the reference's"
    assert int(np.sum(two.numpy() != ref)) > 0


def test_plain_logistic_update_equals_the_reference_margins_bit_for_bit():
    ref, tree, leaves, y, base, eta, R = _replay("logistic")
    n = ref.shape[0]
    F = torch.full((1, n), base, dtype=torch.float32)
    yt, wt = torch.from_numpy(y), torch.ones((1, n), dtype=torch.float32)
    eta_t = torch.tensor([eta], dtype=torch.float32)
    for t in range(R):
        PT.boost_step_plain(F, yt, wt, eta_t, tree.leaf_val[t:t + 1, :, 0],
                            leaves[:, t:t + 1].T.contiguous(), None, "logistic")
    differ = int(np.sum(F[0].numpy() != ref))
    assert differ == 0, f"{differ} of {n} margins differ from the reference's"
