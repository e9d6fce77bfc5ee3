"""Multilayer perceptron fits on the device: full-batch Adam, and its kernel K-U.

The port's counterpart of ``transmogrifai_tpu/ops/mlp.py`` (reference:
Spark's MultilayerPerceptronClassifier, sigmoid hidden layers and a softmax
output): ``init_params``, ``forward``, ``fit_mlp``, ``predict_mlp``,
``fit_mlp_grid_folds`` and ``predict_mlp_grid``.  A fit's parameters are
one flat float32 vector (each layer's weight matrix [fan_in, fan_out]
row-major, then its bias); the public functions take and return the
reference's list of (W, b) pairs.

``mlp_grad`` (K-U, ``csrc/mlp.cu``, gradient mode) replaces
``jax.grad(loss_fn)`` of the reference's ``fit_mlp`` for a batch of fits at
once: one pass over the rows, forward through the sigmoid layers, the
softmax, ``dz = w (p - Y) / sum(w)``, backward through every layer, each
weight's gradient summed in float64 and rounded once.  ``mlp_forward``
(K-U, forward mode) replaces ``forward`` / ``predict_mlp_grid``: every
fit's logits and softmax probabilities on every row.  The Adam update stays
in plain torch ops on the small parameter tensors; its bias corrections
``1 - 0.9^t`` and ``1 - 0.999^t`` are float32 powers on the host.  The
Glorot init replays ``jax.random`` (``ops/threefry.py``: ``split``, then
``uniform`` with its affine map and its ``max(minval, .)``), bit for bit.
K-U takes up to ``MLP_MAX_LAYERS - 1`` (8) hidden layers, features and
hidden widths up to ``MLP_MAX_WIDTH`` (4,096) and 2 .. ``MLP_MAX_CLASSES``
(128) classes; past that both devices raise one ``ValueError`` naming the
size, so a network the CPU tests pass also runs on the card.  The wrappers
take the plain version only for tensors on the CPU; for CUDA tensors they
launch the kernel or raise ``KernelError``; ``<wrapper>.launches`` counts
their launches.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build
from . import threefry
from .linear import _sigmoid, _softmax
from .metrics import fma

Params = List[Tuple[torch.Tensor, torch.Tensor]]

#: K-U's limits: weight layers (hidden layers + 1), features and hidden
#: widths, classes
MLP_MAX_LAYERS = 9
MLP_MAX_WIDTH = 4096
MLP_MAX_CLASSES = 128
_TARGET_BLOCKS = 2 * 132
#: the ceiling of K-U's float64 partial buffer [chunks, C, E]: past it the
#: chunks grow (fewer of them), down to one a fit
MLP_PARTIAL_BYTES = 256 << 20
_DIMS = ctypes.POINTER(ctypes.c_int)
_GRAD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [_DIMS, ctypes.c_void_p]
_FORWARD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [_DIMS, ctypes.c_void_p]
_SIGNATURES = {"mlp_grad": (_GRAD_ARGS, ctypes.c_int),
               "mlp_forward": (_FORWARD_ARGS, ctypes.c_int),
               "mlp_plan": ([ctypes.c_int, ctypes.c_int, _DIMS, ctypes.POINTER(ctypes.c_int)],
                            ctypes.c_int)}


def param_count(layers: Sequence[int]) -> int:
    """Floats in one fit's flat parameter vector."""
    return sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))


def unflatten(flat: torch.Tensor, layers: Sequence[int]) -> Params:
    """The (W [..., fan_in, fan_out], b [..., fan_out]) pairs of flat
    parameters [..., E] (views)."""
    lead = flat.shape[:-1]
    out, off = [], 0
    for a, b in zip(layers[:-1], layers[1:]):
        W = flat[..., off:off + a * b].reshape(lead + (a, b))
        off += a * b
        out.append((W, flat[..., off:off + b]))
        off += b
    return out


def flatten(params: Params) -> torch.Tensor:
    """Flat parameters [..., E] of (W, b) pairs with the same leading shape."""
    parts = []
    for W, b in params:
        parts += [W.reshape(W.shape[:-2] + (-1,)), b]
    return torch.cat(parts, dim=-1).contiguous()


def init_params(seed: int, layers: Sequence[int], device=None) -> Params:
    """Glorot-uniform (W, b) pairs of ``jax.random.PRNGKey(seed)``, bit for
    bit as the reference's ``init_params`` inside its fit: per layer one
    ``split``, then ``uniform(sub, (fan_in, fan_out), -s, s)`` with ``s =
    sqrt(6 / (fan_in + fan_out))`` in float32, its map ``u * (2 s) - s`` one
    fused multiply-add, as XLA's CPU code contracts it; zero biases."""
    key = threefry.key(seed)
    params = []
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        key, sub = threefry.split(key)
        s = torch.sqrt(torch.tensor(6.0 / (fan_in + fan_out), dtype=torch.float32))
        u = threefry.uniform(sub, (fan_in, fan_out), device)
        lo, span = (-s).to(u.device), (s + s).to(u.device)
        W = torch.maximum(lo, fma(u, span.expand_as(u), lo.expand_as(u)))
        params.append((W, torch.zeros(fan_out, dtype=torch.float32, device=u.device)))
    return params


def forward(params: Params, X: torch.Tensor) -> torch.Tensor:
    """Sigmoid hidden layers and a linear output (the logits)."""
    h = X
    for W, b in params[:-1]:
        h = _sigmoid(h @ W + b[..., None, :])
    W, b = params[-1]
    return h @ W + b[..., None, :]


def _check_net(layers: Sequence[int]) -> None:
    """One ``ValueError`` past K-U's bounds, on either device."""
    L = len(layers) - 1
    if not (1 <= L <= MLP_MAX_LAYERS and all(1 <= v <= MLP_MAX_WIDTH for v in layers[:-1])
            and 2 <= layers[-1] <= MLP_MAX_CLASSES):
        raise ValueError(
            f"mlp kernels take at most {MLP_MAX_LAYERS - 1} hidden layers, features and "
            f"hidden widths up to {MLP_MAX_WIDTH} and 2 .. {MLP_MAX_CLASSES} classes, got "
            f"layers {tuple(layers)}")


def _check(X, params, layers) -> None:
    _check_net(layers)
    if X.dtype != torch.float32 or X.ndim != 2 or X.shape[1] != layers[0]:
        raise ValueError(f"X must be float32[n, {layers[0]}]")
    E = param_count(layers)
    if params.dtype != torch.float32 or params.ndim != 2 or params.shape[1] != E:
        raise ValueError(f"params must be float32[C, {E}]")


_PLANS = {}


def _plan(lib, grad: bool, layers: Sequence[int]) -> Tuple[int, int]:
    """(tile rows R, accumulators in shared memory) of csrc/mlp.cu's
    ``mlp_plan`` for this network."""
    key = (grad, tuple(layers))
    if key not in _PLANS:
        smem_acc = ctypes.c_int(0)
        R = lib.mlp_plan(int(grad), len(layers) - 1, _dims(layers), ctypes.byref(smem_acc))
        if R <= 0:
            raise ValueError(f"no K-U tile fits the network {tuple(layers)}")
        _PLANS[key] = (R, smem_acc.value)
    return _PLANS[key]


def _chunking(n: int, C: int, R: int, E: int = 0) -> Tuple[int, int]:
    """(rows a chunk, chunks): about two blocks an SM over the C fits, at
    least 8 tiles of R rows a chunk, and at most ``MLP_PARTIAL_BYTES`` of
    float64 partials [chunks, C, E]."""
    rows = max(8 * R, -(-n * C // _TARGET_BLOCKS), -(-n * C * E * 8 // MLP_PARTIAL_BYTES))
    rows = -(-rows // R) * R
    return rows, -(-n // rows)


def _dims(layers: Sequence[int]):
    """The layer sizes as csrc/mlp.cu's ``dims`` (a host int array)."""
    return (ctypes.c_int * len(layers))(*[int(v) for v in layers])


def mlp_forward_plain(X: torch.Tensor, params: torch.Tensor, layers: Sequence[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K-U's forward mode."""
    z = forward(unflatten(params, layers), X)
    return z, _softmax(z)


def mlp_forward(X: torch.Tensor, params: torch.Tensor, layers: Sequence[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, probabilities) f32[C, n, k] of C fits with flat parameters
    ``params`` f32[C, E] on the rows of ``X`` f32[n, d]; the probabilities
    as the reference's ``jax.nn.softmax`` writes them."""
    _check(X, params, layers)
    if not _on_cuda(X, params):
        return mlp_forward_plain(X, params, layers)
    n = X.shape[0]
    C, k = params.shape[0], layers[-1]
    z = torch.empty((C, n, k), dtype=torch.float32, device=X.device)
    prob = torch.empty_like(z)
    if n == 0:
        return z, prob
    X, params = X.contiguous(), params.contiguous()
    lib = cuda_build.load("mlp", _SIGNATURES)
    R, _ = _plan(lib, False, layers)
    rows, chunks = _chunking(n, C, R)
    with torch.cuda.device(X.device):
        rc = lib.mlp_forward(X.data_ptr(), params.data_ptr(), z.data_ptr(), prob.data_ptr(), n,
                             C, chunks, rows, R, len(layers) - 1, _dims(layers),
                             ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream))
    cuda_build.check_launch("mlp_forward", rc)
    mlp_forward.launches += 1
    return z, prob


mlp_forward.launches = 0


def mlp_grad_plain(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
                   wsum: torch.Tensor, params: torch.Tensor, layers: Sequence[int]
                   ) -> torch.Tensor:
    """Plain PyTorch version of K-U's gradient mode: the forward pass and
    the deltas in float32, each weight's sum over the rows in float64,
    rounded once, as the kernel's."""
    k = layers[-1]
    ps = unflatten(params, layers)
    acts = [X]
    for W, b in ps[:-1]:
        acts.append(_sigmoid(acts[-1] @ W + b[:, None, :]))
    W, b = ps[-1]
    z = acts[-1] @ W + b[:, None, :]                                           # [C, n, k]
    Y = torch.nn.functional.one_hot(y.long(), k).to(torch.float32)
    delta = (w[fold.long()][..., None] * (_softmax(z) - Y)) / wsum[:, None, None]
    grads = []
    for li in range(len(ps) - 1, -1, -1):
        a = acts[li]
        sub = "nq,cnm->cqm" if a.ndim == 2 else "cnq,cnm->cqm"
        gW = torch.einsum(sub, a.double(), delta.double()).to(torch.float32)
        grads.append((gW, delta.double().sum(1).to(torch.float32)))
        if li > 0:
            delta = (delta @ ps[li][0].transpose(1, 2)) * (a * (1.0 - a))
    return flatten(grads[::-1])


def mlp_grad(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
             wsum: torch.Tensor, params: torch.Tensor, layers: Sequence[int]) -> torch.Tensor:
    """The loss gradients f32[C, E] of C fits at their flat parameters
    ``params`` f32[C, E]: the gradient of ``-sum_r w_r log softmax(net(x_r))
    [y_r] / wsum`` with ``w = w[fold[c]]`` (``w`` f32[F, n] the folds' row
    weights, ``fold`` i32[C], ``wsum`` f32[C] the fits' weight sums), ``y``
    f32[n] the class labels 0 .. k - 1."""
    _check(X, params, layers)
    n = X.shape[0]
    C = params.shape[0]
    for name, a, dt, shape in (("y", y, torch.float32, (n,)), ("fold", fold, torch.int32, (C,)),
                               ("wsum", wsum, torch.float32, (C,))):
        if a.dtype != dt or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {dt}{list(shape)}")
    if w.dtype != torch.float32 or w.ndim != 2 or w.shape[1] != n:
        raise ValueError(f"w must be float32[F, {n}]")
    if not _on_cuda(X, y, w, fold, wsum, params):
        return mlp_grad_plain(X, y, w, fold, wsum, params, layers)
    E = params.shape[1]
    grad = torch.zeros((C, E), dtype=torch.float32, device=X.device)
    if n == 0:
        return grad
    X, y, w, fold = X.contiguous(), y.contiguous(), w.contiguous(), fold.contiguous()
    wsum, params = wsum.contiguous(), params.contiguous()
    lib = cuda_build.load("mlp", _SIGNATURES)
    R, smem_acc = _plan(lib, True, layers)
    rows, chunks = _chunking(n, C, R, 0 if smem_acc else E)
    partial = torch.empty((chunks, C, E), dtype=torch.float64, device=X.device)
    with torch.cuda.device(X.device):
        rc = lib.mlp_grad(X.data_ptr(), y.data_ptr(), w.data_ptr(), fold.data_ptr(),
                          wsum.data_ptr(), params.data_ptr(), partial.data_ptr(),
                          grad.data_ptr(), n, C, chunks, rows, R, smem_acc, len(layers) - 1,
                          _dims(layers),
                          ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream))
    cuda_build.check_launch("mlp_grad", rc)
    mlp_grad.launches += 1
    return grad


mlp_grad.launches = 0


def _bias_corrections(max_iter: int) -> List[Tuple[float, float]]:
    """``(1 - 0.9^t, 1 - 0.999^t)`` of each step t = 1 .. max_iter, float32
    powers as the reference's scan computes them."""
    t = torch.arange(1, max_iter + 1, dtype=torch.float32)
    b1 = 1.0 - torch.pow(torch.tensor(0.9, dtype=torch.float32), t)
    b2 = 1.0 - torch.pow(torch.tensor(0.999, dtype=torch.float32), t)
    return list(zip(b1.tolist(), b2.tolist()))


def fit_mlp_grid_folds(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor, lrs, seeds,
                       layers: Sequence[int], max_iter: int = 100) -> Params:
    """MLP fits for every (fold, grid) pair on X's device: the reference's
    ``fit_mlp`` for each (fold f, candidate g) with step size ``lrs[g]`` and
    init seed ``seeds[g]``: ``max_iter`` full-batch Adam steps (0.9, 0.999,
    1e-8) on the weighted softmax cross-entropy, the gradients by K-U for
    all F G fits at once.  Returns the (W [F, G, fan_in, fan_out], b [F, G,
    fan_out]) pairs."""
    dev = X.device
    layers = tuple(int(v) for v in layers)
    X = X.to(torch.float32).contiguous()
    F = train_w.shape[0]
    lr = np.asarray(lrs, np.float32).reshape(-1)
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    G = len(seeds)
    C = F * G
    w = train_w.to(dev, torch.float32).contiguous()
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
    wsum = torch.clamp_min(w.sum(1), 1e-12)[fold.long()].contiguous()
    init = torch.stack([flatten(init_params(s, layers, dev)) for s in seeds])   # [G, E]
    p = init.repeat(F, 1).contiguous()                                          # [C, E]
    lr_c = torch.as_tensor(np.tile(lr, F), device=dev)[:, None]
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    yd = y.to(dev, torch.float32).contiguous()
    for b1, b2 in _bias_corrections(max_iter):
        g = mlp_grad(X, yd, w, fold, wsum, p, layers)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * (g * g)
        p = p - lr_c * (m / b1) / (torch.sqrt(v / b2) + 1e-8)
    return unflatten(p.reshape(F, G, -1), layers)


def fit_mlp(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor,
            layers: Sequence[int], max_iter: int = 100, lr: float = 0.03,
            seed: int = 0) -> Params:
    """One softmax cross-entropy MLP fit: its (W, b) pairs."""
    params = fit_mlp_grid_folds(X, y, sample_weight[None], [lr], [seed], layers, max_iter)
    return [(W[0, 0], b[0, 0]) for W, b in params]


def predict_mlp_grid(params: Params, X: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits, probabilities, predictions) [F, G, n, (k)] of [F, G]-leading
    (W, b) pairs, by K-U's forward mode."""
    lead = params[0][1].shape[:-1]
    layers = [params[0][0].shape[-2]] + [b.shape[-1] for _, b in params]
    flat = flatten(params).reshape(-1, param_count(layers))
    z, prob = mlp_forward(X.to(torch.float32).contiguous(), flat, layers)
    z, prob = z.reshape(lead + z.shape[1:]), prob.reshape(lead + prob.shape[1:])
    return z, prob, torch.argmax(z, dim=-1).to(torch.float32)


def predict_mlp(params: Params, X: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(raw logits [n, k], probability [n, k], prediction [n]) of one fit."""
    z, prob, pred = predict_mlp_grid([(W[None], b[None]) for W, b in params], X)
    return z[0], prob[0], pred[0]
