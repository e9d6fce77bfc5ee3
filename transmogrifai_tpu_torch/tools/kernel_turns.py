"""Time the kernels' narrow shapes with the package found under ``--root`` (a
checkout of this repository: the current one, or an unpacked earlier
commit), so that two commits' kernels can be compared in turns on one card
(parent, change, change, parent: one process each).  ``--set classes``: the
k <= 8 shapes of K-E, K-F, K-P, K-Q and K-R; ``--set wide``: K-S's wide
entry, K-P's tiled entry and the wide entries of K-P (k <= 8) and K-T at
``chip_smoke.py``'s shapes, each beside its PyTorch yardstick
(``*_library``); ``--set families``: the shapes
K-U, K-V, K-AA and K-AB took before their tiled redesign (up to 2 hidden
layers of 64 and 128 features, 256 features and 8 classes, 256 dimensions,
32 topics over at most 51,200 topic x term entries), and where the sources
name them, the rivals of the narrow entries at those shapes: ``sgns.cu`` and
``lda.cu`` built again with ``-DSGNS_NARROW_MAX_DIM=0 -DLDA_NARROW_TOPICS=0``
(K-AA's slab path at every width, K-AB's estep with the topics across the
lanes at every k), timed under the names ``*_rival``.  ``--set trains``: the
walls (host clock, synchronized, in s) of the stock Titanic, Boston and Iris
trains at 2^18 rows and the Letter families, "bow" text, Letter stock (26
classes: K-P's tiled entry) and text-embedding Newton + SVC (the wide K-S)
flows at 2^16,
each after a warm-up at 4,096 rows, ``--reps`` runs each (the median).
``--set stats``: K-I, both modes, at the sanity checker's shapes (``corr_gram``
on [100000, 23] as the stock train's checker takes it, and at d = 85 and 300;
the centered mode on the scale train's [262144, 25] chunk and at 2^18 x 513),
each beside ``torch.mm`` on the same operands (``*_library``; the centered
mode's on the pre-centered float64 chunk, as ``chip_smoke.py`` times it).
``--set ranks``: K-Y (``midranks``: the route, ``*_sort`` its sort,
``*_stage`` the kernel on the sorted columns, ``*_stage_direct`` and
``*_stage_partition`` each of its routes there where the package has both,
``*_scatter`` ``scatter_`` of the ordinal ranks on the same operands,
``*_library`` sort + ``scatter_``) on the sanity checker's Titanic vector
(``checker_vector``: [1048576, 24], the main path's columns, and its first
2^19, 2^18 and 100,000 rows), on normal draws at [1048576, 24] in float32
and float64, on tie-heavy [1048576, 4] columns and at 2^18 x 512, with each
stage's bound (``bound_ms``: the values, the int64 order and the rank once a
position), and K-AF (``predict_head``) at
the serve fixtures' heads (titanic_stock, letters_stock, boston_ridge at 64
and 1,024 rows; titanic_stock at 2^18), and binary at p = 1,024 (64 and
1,024 rows), each beside ``torch.addmm`` on the same operands.

Usage, on a host with a CUDA card (run as a file, so that the package is
imported from ``--root`` alone)::

    python3 transmogrifai_tpu_torch/tools/kernel_turns.py --root DIR [--set classes] [--reps 20]
    python3 transmogrifai_tpu_torch/tools/kernel_turns.py --root DIR --set stats
    python3 transmogrifai_tpu_torch/tools/kernel_turns.py --root DIR --set ranks
    python3 transmogrifai_tpu_torch/tools/kernel_turns.py --root DIR --set trains --reps 1 \
        [--only letters_stock,text_wide_newton_svc]

Prints one JSON line: the card's name and power limit, and for each shape the
median of ``--reps`` CUDA-event runs (L2 flushed) in ms (``--set ranks``
also the stages' bounds).  The inputs are made from a seed with numpy, the
same for every root.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


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


def wide_shapes(torch, L, dev):
    """{name: a call of K-S's wide entry (Newton, ridge, GLM at p = 85 and
    513, 12 fits: ``chip_smoke.py``'s ``wide_kernels`` shapes), of K-P's
    tiled entry (26 classes at p = 33, 24 fits; 64 at p = 33; 26 at p = 85,
    12 fits; 128 at p = 64), or of K-P's and K-T's wide entries at p = 85
    and 513 (``softmax_fista_grad_wide_k{3,8}_p*``, ``svc_grad_wide_p*``),
    and under ``*_library`` the one PyTorch call that computes the same
    function (an ``einsum`` with the weights given; two ``matmul`` and a
    ``softmax``; two ``matmul`` and the hinge)}."""
    import numpy as np

    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa
    out = {}
    for p, n in ((85, 1 << 17), (513, 1 << 15)):
        rng = np.random.default_rng(p)
        X1 = np.concatenate([(rng.random((n, p - 1)) < 0.15) * 1.0, np.ones((n, 1))], 1)
        X1[:, :6] = rng.normal(size=(n, 6))
        F, C = 3, 12
        X1t = t(X1)
        w = t(rng.random((F, n)) < 0.67)
        fold = t(np.arange(C) % F, torch.int32)
        beta = t(rng.normal(size=(C, p)) * 0.05)
        for mode, args in (("newton", (beta,)), ("ridge", ()),
                           ("glm", (beta, ("poisson", "log", t(np.zeros(C)))))):
            yy = t(rng.poisson(1.5, n)) if mode == "glm" else t(rng.random(n) < 0.4)
            out[f"weighted_gram_{mode}_p{p}"] = lambda a=(X1t, yy, w, fold, *args): \
                L.weighted_gram(*a)
            v = L._gram_weights(X1t, yy, w, fold, *(args or (None,)))[0]
            out[f"weighted_gram_{mode}_p{p}_library"] = lambda v=v, X=X1t: \
                torch.einsum("cn,np,nq->cpq", v, X, X)
    rng = np.random.default_rng(17)
    for n, p, k, C in ((58983, 33, 26, 24), (29496, 33, 64, 24), (1 << 17, 85, 26, 12),
                       (1 << 16, 64, 128, 24)):
        F = 3
        X1 = rng.normal(size=(n, p)).astype(np.float32)
        X1[:, -1] = 1.0
        w = rng.integers(0, 3, (F, n)).astype(np.float32)
        fold = (np.arange(C) % F).astype(np.int32)
        l2m = np.full((C, p, k), 0.01, np.float32)
        l2m[:, -1] = 0.0
        X1t, yt, wt, foldt, zt, l2t, wsumt = args = [
            torch.from_numpy(a).to(dev) for a in (X1, rng.integers(0, k, n).astype(np.float32),
                                                  w, fold,
                           (0.1 * rng.normal(size=(C, p, k))).astype(np.float32), l2m,
                           np.maximum(w.sum(1), 1.0)[fold].astype(np.float32))]
        name = f"softmax_fista_grad_k{k}_p{p}"
        out[name] = lambda args=args: L.softmax_fista_grad(*args)
        zf = zt.permute(1, 0, 2).reshape(p, C * k)
        Yk = torch.nn.functional.one_hot(yt.long(), k).float().repeat(1, C)
        wk = wt[foldt.long()].T.repeat_interleave(k, dim=1)

        def library(X1t=X1t, zf=zf, Yk=Yk, wk=wk, wsumt=wsumt, l2t=l2t, zt=zt, n=n, p=p, k=k,
                    C=C):
            mu = torch.softmax(torch.matmul(X1t, zf).view(n, C, k), -1).view(n, C * k)
            g = torch.matmul(X1t.T, wk * (mu - Yk)).view(p, C, k).permute(1, 0, 2)
            return g / wsumt[:, None, None] + l2t * zt

        out[name + "_library"] = library
    # K-P's wide entry (k = 3, 6 fits; k = 8, 2 fits) and K-T's (12 fits) on
    # chip_smoke.py's phase 42 inputs, beside its yardsticks
    smoke = _chip_smoke()
    for p, n in ((85, 1 << 17), (513, 1 << 15)):
        inp = smoke.wide_inputs(p, n)
        X1t, y, w = t(inp.pop("X1")), t(inp["y"]), t(inp["w"])
        fold = t(inp["fold"], torch.int32)
        beta, C = t(inp["beta"]), len(inp["fold"])
        wsum, l2v = w.sum(1)[fold.long()], t(np.full((C, p), 0.01))
        args = (X1t, y, w, fold, beta, l2v, wsum)
        out[f"svc_grad_wide_p{p}"] = lambda args=args: L.svc_grad(*args)
        out[f"svc_grad_wide_p{p}_library"] = smoke.svc_library(torch, *args)
        for k, Cs in smoke.WIDE_SOFTMAX:
            fs = fold[:Cs].contiguous()
            args = (X1t, t(inp[f"y{k}"]), w, fs, t(inp[f"z{k}"]), t(np.full((Cs, p, k), 0.01)),
                    w.sum(1)[fs.long()])
            name = f"softmax_fista_grad_wide_k{k}_p{p}"
            out[name] = lambda args=args: L.softmax_fista_grad(*args)
            out[name + "_library"] = smoke.softmax_library(torch, *args)
    return out


def stats_shapes(torch, dev):
    """{name: a call of K-I (``corr_gram_d*``, ``centered_gram_D*``) at the
    ``--set stats`` shapes, and under ``*_library`` ``torch.mm`` on the same
    operands}."""
    import numpy as np

    from transmogrifai_tpu_torch.ops import stats as K

    rng = np.random.default_rng(19)
    out = {}
    for n, d in ((100000, 23), (100000, 85), (100000, 300)):
        Z = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
        out[f"corr_gram_d{d}"] = lambda Z=Z: K.corr_gram(Z)
        out[f"corr_gram_d{d}_library"] = lambda Z=Z: torch.mm(Z.T, Z)
    for n, d in ((1 << 18, 24), (1 << 18, 512)):
        X = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32) * 3 + 1).to(dev)
        y = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(dev)
        c = K.chunk_moments_plain(X, y, "chan")[0]
        Zc = (torch.cat([X, y[:, None]], 1).double() - c).contiguous()
        out[f"centered_gram_D{d + 1}"] = lambda X=X, y=y, c=c: K.centered_gram(X, y, c)
        out[f"centered_gram_D{d + 1}_library"] = lambda Zc=Zc: torch.mm(Zc.T, Zc)
    return out


def _ranks_library(torch, X, ordinal):
    """Sort + ``scatter_`` of the ordinal ranks: ``chip_smoke.py``'s
    ``ranks_library``, K-Y's yardstick."""
    order = torch.sort(X.T.contiguous(), dim=1)[1]
    return torch.empty(order.shape, dtype=torch.float32, device=X.device).scatter_(
        1, order, ordinal)


#: ``--set ranks``: K-Y's shapes (label, rows, columns, dtype, columns):
#: "checker" the sanity checker's Titanic vector (``checker_vector``: the
#: main path's columns, its first rows below 2^20), "normal" draws,
#: "ties" integers in [0, 16)
RANK_SHAPES = (("checker", 1 << 20, 24, "float32", "checker"),
               ("checker_r19", 1 << 19, 24, "float32", "checker"),
               ("checker_r18", 1 << 18, 24, "float32", "checker"),
               ("checker_100k", 100000, 24, "float32", "checker"),
               ("f32", 1 << 20, 24, "float32", "normal"), ("f64", 1 << 20, 24, "float64", "normal"),
               ("ties", 1 << 20, 4, "float32", "ties"), ("wide", 1 << 18, 512, "float32", "normal"))


def checker_vector(torch, dev, rows):
    """The vector f32[rows, 24] that the Titanic flow's sanity checker
    ranks in ``chip_smoke.py``'s Spearman scale train: the flow's features
    (``apps/titanic.build_workflow``) fitted and made on
    ``chip_smoke.titanic_columns(rows, 0)`` (its ``--stats-rows`` and
    ``--seed`` defaults), the whole frame being the checker's sample."""
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.apps import titanic

    _, pred = titanic.build_workflow()
    features = pred.origin_stage.inputs[1].origin_stage.inputs[1]  # selector <- checker <- vector
    model = OpWorkflow().set_result_features(features).set_input_dataset(
        _chip_smoke().titanic_columns(rows, 0), key="PassengerId").train(device=dev)
    return model.train_data[features.name].values.contiguous()


def ranks_shapes(torch, dev):
    """{name: a call of K-Y or K-AF at the ``--set ranks`` shapes, and the
    calls it is read beside}, and {name: the K-Y stage's bound in ms}."""
    import numpy as np

    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch import fixtures as FX
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import stats as K

    rng = np.random.default_rng(20)
    out, bounds = {}, {}
    checker = checker_vector(torch, dev, max(n for _, n, _, _, kind in RANK_SHAPES
                                             if kind == "checker"))
    for label, n, k, dtype, kind in RANK_SHAPES:
        if kind == "checker":
            X = checker[:n].contiguous().to(getattr(torch, dtype))
        else:
            A = rng.integers(0, 16, (n, k)) if kind == "ties" else rng.normal(size=(n, k)) * 3 + 1
            X = torch.from_numpy(A.astype(dtype)).to(dev)
        ss, order = torch.sort(X.T.contiguous(), dim=1)
        res = torch.empty((n, k), dtype=torch.float32, device=dev)
        ordinal = torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(k, n)
        ranked = torch.empty((k, n), dtype=torch.float32, device=dev)
        name = f"midranks_{label}"
        out[name] = lambda X=X: K.midranks(X)
        out[name + "_sort"] = lambda X=X: torch.sort(X.T.contiguous(), dim=1)
        out[name + "_stage"] = lambda a=(ss, order, res): K._midrank_launch(*a)
        for route in getattr(K, "MIDRANK_ROUTES", ()):  # each route on the same operands
            if n <= K.PART_MAX_BUCKETS * K.PART_BUCKET_ROWS:
                out[f"{name}_stage_{route}"] = \
                    lambda a=(ss, order, res, route): K._midrank_launch(*a)
        out[name + "_scatter"] = lambda a=(ranked, order, ordinal): a[0].scatter_(1, a[1], a[2])
        out[name + "_library"] = lambda X=X, ordinal=ordinal: _ranks_library(torch, X, ordinal)
        bounds[name + "_stage"] = n * k * (X.element_size() + 8 + 4) / 3.35e12 * 1e3
    smoke = _chip_smoke()
    for nm in ("titanic_stock", "letters_stock", "boston_ridge"):
        model = P.load_model(getattr(FX, nm.upper()), device=dev)
        cols = FX.load_columns(getattr(FX, nm.upper()) + "/requests.npz")
        finite = ~smoke.serve_records_of(FX, nm)[1]
        cols = {c: v[finite] for c, v in cols.items()}
        for rows in (64, 1024) + ((1 << 18,) if nm == "titanic_stock" else ()):
            X, coef, b, mode = smoke.head_inputs(torch, model, cols, rows)
            w = coef if mode == "softmax" else coef[:, None]
            bias = b if mode == "softmax" else b[:1]
            out[f"predict_head_{nm}_{rows}"] = lambda a=(X, coef, b, mode): L.predict_head(*a)
            out[f"predict_head_{nm}_{rows}_library"] = lambda a=(bias, X, w): torch.addmm(*a)
    Xw = torch.from_numpy(rng.normal(size=(1024, 1024)).astype(np.float32)).to(dev)
    cw = torch.from_numpy((rng.normal(size=1024) / 32).astype(np.float32)).to(dev)
    bw = torch.zeros(1, device=dev)
    for rows in (64, 1024):
        Xr = Xw[:rows]
        out[f"predict_head_p1024_{rows}"] = lambda Xr=Xr: L.predict_head(Xr, cw, bw, "binary")
        out[f"predict_head_p1024_{rows}_library"] = lambda Xr=Xr: torch.addmm(bw, Xr,
                                                                               cw[:, None])
    return out, bounds


def _chip_smoke():
    """``chip_smoke.py`` of this tool's own checkout (not ``--root``'s): the
    wide phase's inputs and yardsticks, the serve heads' inputs."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("kernel_turns_chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


def train_calls(rows: int, text_rows: int) -> dict:
    """{name: a call training that flow at that size on the card}."""
    from transmogrifai_tpu_torch import fixtures as FX
    from transmogrifai_tpu_torch.apps import boston, iris, titanic

    def letters(n):
        wf, _ = FX.letters_workflow(FX.port_letters_families_space())
        return wf.set_input_dataset(FX.letters_data(n, 26, 0), key="id").train(device="cuda")

    def bow(n):
        wf, _ = FX.port_wide_text_workflow("bow")
        return wf.set_input_dataset(titanic.text_columns(n, 0), key="PassengerId") \
            .train(device="cuda")

    def letters_stock(n):
        wf, _ = FX.letters_workflow()
        return wf.set_input_dataset(FX.letters_data(n, 26, 0), key="id").train(device="cuda")

    def text_wide(n):  # chip_smoke.py's wide_reference_phase space: wide K-S and K-T
        from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression
        from transmogrifai_tpu_torch.impl.classification.svc import OpLinearSVC
        from transmogrifai_tpu_torch.impl.selector import defaults as D

        space = [(OpLogisticRegression(), D.grid(reg_param=[0.001, 0.01, 0.1, 0.2],
                                                  elastic_net_param=[0.0])),
                 (OpLinearSVC(), D.linear_svc_grid())]
        return titanic.train_titanic(titanic.text_columns(n, 0), device="cuda",
                                     text_embeddings=True, models_and_parameters=space)

    return {
        "titanic_stock": lambda: titanic.train_titanic(titanic.titanic_data(rows, 0),
                                                       device="cuda"),
        "boston_stock": lambda: boston.train_boston(boston.boston_data(rows, 0), device="cuda"),
        "iris_stock": lambda: iris.train_iris(iris.iris_data(rows, 0), device="cuda"),
        "letters_families": lambda: letters(text_rows),
        "wide_text_bow": lambda: bow(text_rows),
        "letters_stock": lambda: letters_stock(text_rows),
        "text_wide_newton_svc": lambda: text_wide(text_rows)}


def train_walls(reps: int, only=None) -> dict:
    """The median wall of ``reps`` runs of each ``train_calls`` flow (those
    named in ``only``, if given), after one run at 4,096 rows (its kernels
    built and compiled)."""
    import torch

    res = {}
    warm = train_calls(4096, 4096)
    for name, fn in train_calls(1 << 18, 1 << 16).items():
        if only and name not in only:
            continue
        warm[name]()
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res[name] = statistics.median(walls)
    return res


def measure(root: str, reps: int, which: str = "classes", only=None) -> dict:
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

    if which == "trains":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        return {"root": root, "card": smi.strip(), "wall_s": train_walls(reps, only)}
    bounds = None
    if which == "ranks":
        calls, bounds = ranks_shapes(torch, dev)
    else:
        calls = (shapes(torch, Tr, L, M, dev) if which == "classes" else
                 wide_shapes(torch, L, dev) if which == "wide" else
                 stats_shapes(torch, dev) if which == "stats" else family_shapes(torch, dev))
    if only:
        calls = {name: fn for name, fn in calls.items() if name.startswith(tuple(only))}
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
            "package": os.path.dirname(os.path.dirname(os.path.abspath(Tr.__file__))),
            **({"bound_ms": bounds} if bounds else {})}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout whose package to time")
    ap.add_argument("--set", default="classes",
                    choices=("classes", "families", "wide", "stats", "ranks", "trains"),
                    help="which kernels' narrow shapes (or which trains) to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="the flows (--set trains) or the names' prefixes to time, "
                         "comma-separated (default all)")
    args = ap.parse_args()
    only = [name for name in args.only.split(",") if name]
    print(json.dumps(measure(args.root, args.reps, args.set, only)), flush=True)
