"""Time the kernels' narrow shapes with the package found under ``--root`` (a
checkout of this repository: the current one, or an unpacked earlier
commit), so that two commits' kernels can be compared in turns on one card
(parent, change, change, parent: one process each).  ``--set classes``: the
k <= 8 shapes of K-E, K-F, K-P, K-Q and K-R; ``--set families``: the shapes
K-U, K-V, K-AA and K-AB took before their tiled redesign (up to 2 hidden
layers of 64 and 128 features, 256 features and 8 classes, 256 dimensions,
32 topics over at most 51,200 topic x term entries), and where the sources
name them, the rivals of the narrow entries at those shapes: ``sgns.cu`` and
``lda.cu`` built again with ``-DSGNS_NARROW_MAX_DIM=0 -DLDA_NARROW_TOPICS=0``
(K-AA's slab path at every width, K-AB's estep with the topics across the
lanes at every k), timed under the names ``*_rival``.

Usage, on a host with a CUDA card (run as a file, so that the package is
imported from ``--root`` alone)::

    python3 transmogrifai_tpu_torch/tools/kernel_turns.py --root DIR [--set classes] [--reps 20]

Prints one JSON line: the card's name and power limit, and for each shape the
median of ``--reps`` CUDA-event runs (L2 flushed) in ms.  The inputs are made
from a seed with numpy, the same for every root.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys


def shapes(torch, Tr, L, M, dev):
    """{name: a call of the kernel at that shape}."""
    import numpy as np

    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = {}
    for c, n, d, T, m in ((1, 1 << 18, 10, 6, 64), (3, 157286, 8, 50, 64)):
        B = 32
        Xb = t(rng.integers(0, B, (n, d)).astype(np.int8))
        w = rng.poisson(1.0, (T, n)).astype(np.float32)
        g = -np.eye(max(c, 2), dtype=np.float32)[rng.integers(0, max(c, 2), n)][:, :c]
        ghw = t(np.concatenate([w[..., None] * g[None], w[..., None]], 2))
        ids = t(rng.integers(-1, m, (T, n)).astype(np.int32))
        out[f"level_hist_c{c}"] = lambda Xb=Xb, ghw=ghw, ids=ids, m=m, B=B: \
            Tr.level_hist_launch(Xb, ghw, ids, m, B)
        hist = Tr.level_hist_launch(Xb, ghw, ids, m, B)
        fm = torch.ones((T, d), device=dev)
        params = torch.tensor([[1e-6, 0.0, 10.0, 0.001]] * T, device=dev)
        n_act = torch.full((T,), m, dtype=torch.int32, device=dev)
        P_ = 4 * m
        nodes = torch.zeros((T, P_, 4), dtype=torch.int32, device=dev)
        leaf = torch.zeros((T, P_, c), device=dev)
        out[f"split_scan_c{c}"] = lambda hist=hist, fm=fm, params=params, n_act=n_act, \
            nodes=nodes, leaf=leaf, m=m: Tr.split_scan(hist, fm, params, n_act, nodes, leaf,
                                                       m - 1, 2 * m - 1, m, Tr.CAP_BEAM, False)
    for name, n, p, k, C, F in (("softmax_fista_grad_k3", 1 << 18, 9, 3, 24, 3),
                                ("softmax_fista_grad_wide_k8", 1 << 17, 85, 8, 6, 3)):
        X1 = rng.normal(size=(n, p)).astype(np.float32)
        X1[:, -1] = 1.0
        w = rng.integers(0, 3, (F, n)).astype(np.float32)
        fold = (np.arange(C) % F).astype(np.int32)
        l2m = np.full((C, p, k), 0.01, np.float32)
        args = [t(a) for a in (X1, rng.integers(0, k, n).astype(np.float32), w, fold,
                                (0.1 * rng.normal(size=(C, p, k))).astype(np.float32), l2m,
                                np.maximum(w.sum(1), 1.0)[fold].astype(np.float32))]
        out[name] = lambda args=args: L.softmax_fista_grad(*args)
    n, F, C, k = 1 << 18, 3, 26, 3
    probs = t(rng.random((F * C, n, k)).astype(np.float32))
    y = t(rng.integers(0, k, n).astype(np.float32))
    vm = t((rng.random((F, n)) < 0.34).astype(np.float32))
    out["multiclass_metrics_k3"] = lambda: M.multiclass_metrics(probs, y, vm, C)
    B, n, P_, k = 6, 1 << 18, 63, 3
    Fm = t((rng.normal(size=(B, n, k)) * 2).astype(np.float32))
    w = t(rng.integers(0, 3, (B, n)).astype(np.float32))
    eta = t(rng.random(B).astype(np.float32))
    for name, K in (("softmax_boost_step_k3", 1), ("softmax_boost_step_collapse_k3", 4)):
        leaf = t(rng.normal(size=(B * K, P_, k)).astype(np.float32))
        node = t(rng.integers(0, P_, (B * K, n)).astype(np.int32))
        rw = t((rng.random((K, n)) < 0.8).astype(np.float32)) if K > 1 else None
        ghw = torch.empty((B * K, n, k + 1), device=dev)
        out[name] = lambda leaf=leaf, node=node, rw=rw, ghw=ghw: Tr.softmax_boost_step(
            Fm, y, w, eta, leaf, node, ghw, rw)
    return out


def family_shapes(torch, dev):
    """{name: a call of K-U, K-V, K-AA or K-AB at a shape it took before its
    tiled redesign}."""
    import numpy as np

    from transmogrifai_tpu_torch.impl.classification import naive_bayes as NB
    from transmogrifai_tpu_torch.ops import embeddings as E
    from transmogrifai_tpu_torch.ops import mlp as M

    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = {}
    for name, layers, n, F in (("mlp_titanic", (21, 10, 2), 1 << 18, 3),
                               ("mlp_widest", (128, 64, 64, 8), 20000, 2)):
        k = layers[-1]
        X = t((rng.normal(size=(n, layers[0])) * 2).astype(np.float32))
        y = t(rng.integers(0, k, n).astype(np.float32))
        w = t(rng.integers(0, 3, (F, n)).astype(np.float32))
        fold = torch.arange(F, dtype=torch.int32, device=dev)
        wsum = torch.clamp_min(w.sum(1), 1e-12).contiguous()
        flat = t((rng.normal(size=(F, M.param_count(layers))) * 0.1).astype(np.float32))
        out[f"{name}_grad"] = lambda a=(X, y, w, fold, wsum, flat, layers): M.mlp_grad(*a)
        out[f"{name}_forward"] = lambda X=X, flat=flat, layers=layers: \
            M.mlp_forward(X, flat, layers)
    for name, n, d, k, F, Q in (("nb_titanic", 1 << 18, 21, 2, 3, 3),
                                ("nb_widest", 20000, 256, 8, 3, 6)):
        X = t(rng.poisson(2.0, (n, d)).astype(np.float32))
        y = t(rng.integers(0, k, n).astype(np.float32))
        w = t(rng.integers(0, 3, (F, n)).astype(np.float32))
        pi = t(rng.normal(size=(Q, k)).astype(np.float32))
        th = t(-rng.random((Q, k, d)).astype(np.float32))
        out[f"{name}_mass"] = lambda a=(X, y, w, k): NB.nb_tables_mass(*a)
        out[f"{name}_score"] = lambda a=(X, pi, th): NB.nb_tables_score(*a)
    for name, V, d, P_ in (("sgns_d64", 2000, 64, 200000), ("sgns_d256", 2000, 256, 200000)):
        p = 1.0 / np.arange(1, V + 1) ** 1.1
        p /= p.sum()
        W = t((rng.standard_normal((V, d)) / np.sqrt(d)).astype(np.float32))
        C = t((0.1 * rng.standard_normal((V, d))).astype(np.float32))
        pairs = t(rng.choice(V, (P_, 2), p=p).astype(np.int32))
        negs = t(rng.choice(V, (P_, 5), p=p).astype(np.int32))
        lists = E.sgns_lists(pairs, negs, V)
        a = (W, C, pairs, negs, 0.2)
        out[name] = lambda a=a, lists=lists: E.sgns_epoch(*a, lists=lists, want_loss=False)
    for name, n, k, v in (("lda_k10", 1 << 17, 10, 512), ("lda_k32", 20000, 32, 1600)):
        X = t(rng.poisson(0.04, (n, v)).astype(np.float32))
        eb = E.lda_beta(t(rng.gamma(2.0, 1.0, (k, v)).astype(np.float32)))
        docs = E.lda_docs(X)
        gamma = E.lda_estep(eb, X, 0.1, 30, docs=docs)
        out[f"{name}_estep"] = lambda eb=eb, X=X, docs=docs: E.lda_estep(eb, X, 0.1, 30,
                                                                         docs=docs)
        out[f"{name}_sstats"] = lambda eb=eb, X=X, g=gamma, docs=docs: E.lda_sstats(
            eb, X, g, 0.01, docs=docs)
    return out


#: the build of ``sgns.cu`` and ``lda.cu`` whose narrow entries take nothing
RIVAL_FLAGS = ("-DSGNS_NARROW_MAX_DIM=0", "-DLDA_NARROW_TOPICS=0")


def _names_rival(cuda_build, src: str) -> bool:
    with open(os.path.join(cuda_build.CSRC, src + ".cu")) as fh:
        text = fh.read()
    return any(flag[2:].split("=")[0] in text for flag in RIVAL_FLAGS)


def measure(root: str, reps: int, which: str = "classes") -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from transmogrifai_tpu_torch.ops import cuda_build
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import trees as Tr

    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: no CUDA device")
    cuda_build.build()
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def median_ms(fn):
        fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    calls = shapes(torch, Tr, L, M, dev) if which == "classes" else family_shapes(torch, dev)
    res = {name: median_ms(fn) for name, fn in calls.items()}
    if which == "families" and all(_names_rival(cuda_build, src) for src in ("sgns", "lda")):
        cuda_build.NVCC_FLAGS = cuda_build.NVCC_FLAGS + RIVAL_FLAGS
        for src in ("sgns", "lda"):
            cuda_build._LIBS.pop(src, None)
        res.update({f"{name}_rival": median_ms(fn) for name, fn in calls.items()
                    if name.startswith("sgns_") or name.endswith("_estep")})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    return {"root": root, "card": smi, "ms": res,
            "package": os.path.dirname(os.path.dirname(os.path.abspath(Tr.__file__)))}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout whose package to time")
    ap.add_argument("--set", default="classes", choices=("classes", "families"),
                    help="which kernels' narrow shapes to time")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    print(json.dumps(measure(args.root, args.reps, args.set)), flush=True)
