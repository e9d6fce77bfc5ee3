"""Chip smoke test of the PyTorch/CUDA port: serve and train Titanic on the GPU.

Run from the repository root on a host with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--rows 1048576] [--reps 20] [--train-rows 262144]

Phases, each printing its findings on a line of its own:

1. device   -- the card (nvidia-smi's name and power limit), and the build of
               every kernel from ``transmogrifai_tpu_torch/csrc`` and the
               Triton sources, with its seconds;
2. kernels  -- each kernel of the serve path against its plain PyTorch
               version on the inputs the path gives it (a Titanic-schema
               batch of ``--rows`` rows made from ``--seed``): equal bins,
               leaves and vectors, margins within the stated tolerance;
               median time over ``--reps`` runs by CUDA events, beside the
               plain version's, one library call's where one exists, and
               the least time the card could take (``bound_ms``);
3. reference -- the committed fixture (a full-width Titanic XGB model the
               JAX package saved, with its answers for 256 requests) scored
               through ``BatchScoreFunction`` on the card, against those
               answers;
4. serve    -- the main path: request batches of 1, 64 and 1024 records
               through ``BatchScoreFunction`` (p50 latency), a few records
               through ``ScoreFunction``, and the ``--rows`` batch through
               ``OpWorkflowModel.score`` (rows/s).  Every kernel's launch
               count is reset just before and read just after; each must be
               above 0;
5. breakdown -- the ``--rows`` batch again, split into the reader and each
               DAG layer on the host clock, and profiled for the device's
               busy time and idle share;
6. train reference -- the full-width Titanic XGBoost train (the stock grid:
               200 rounds, depth 10, min_child_weight 1 and 10, 3-fold CV)
               on the 891-row synthetic frame, through
               ``OpWorkflow.train`` with ``model_types=["OpXGBoostClassifier"]``
               (the fused sweep): the winner must be the committed
               fixture's and every fold's AuPR within ``TRAIN_AUPR_TOL`` of
               the fixture's; the share of refit trees equal to the
               fixture's and the saved model's gaps on the fixture's
               requests are printed;
7. sweep reference -- the full-width stock train (LR + RF + XGBoost, 28
               candidates) on the 891-row frame, held to the committed
               fixture ``titanic_stock``: the same winner (LR reg_param
               0.001, elastic_net_param 0.1), the forests' draws equal to
               the fixture's, each family's fold AuPR within its tolerance
               (``FX.LR_AUPR_TOL``, ``FX.RF_AUPR_TOL``, ``TRAIN_AUPR_TOL``),
               and the saved model's probabilities on the fixture's requests
               within ``FX.PROB_ATOL``; every metric of each sweep call is
               printed beside the fixture's;
8. train    -- the main path of training: the stock flow on a Titanic-schema
               frame of ``--train-rows`` rows from ``--seed``; every
               kernel's launch count is reset just before and read just
               after (K-A, K-E ... K-M must be above 0), with the wall time
               and the host-clock breakdown (the sweep split into fista,
               forest, gbt and metrics); a second run is profiled for the
               device's busy time and idle share;
9. train kernels -- K-E ... K-H against their plain versions on the inputs
               of the deepest level of the second boosting round of one
               sweep fold of the ``--train-rows`` data (the first round's
               gradients are dyadic; the second's are checked not to be):
               K-E, K-F and K-G bit-equal (K-E on integer-valued and on
               real gradients, K-F and K-G fed one histogram), K-H's
               gradients within the stated gap; timed as in phase 2;
10. stats kernels -- K-I and K-J (the sanity checker's correlation matrix
               and contingency counts) against their plain versions on the
               sanity checker's 100k-row sample of the ``--train-rows``
               data: K-J bit-equal, K-I within ``STATS_GRAM_ATOL``; timed
               as in phase 2;
11. sweep kernels -- K-K, K-L and K-M against their plain versions on the
               first sweep call of the ``--train-rows`` train (its feature
               matrix, folds and candidates): K-K's gradients at the fitted
               coefficients within ``FISTA_GRAD_RTOL``, K-L on the sweep's
               28 score rows and K-M on its deepest forest group bit-equal;
               timed as in phase 2 (K-L's sort timed apart).

The line before the last holds the kernels' JSON record, then the card's
name and power limit; the last line is ``{"ok": true, "device": ...}``.  Any
failed build, launch or comparison raises, so the script exits non-zero
without that line.  There is no CPU path.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet):
#: HBM3 bytes/s, and float32 / int32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
BATCH_SIZES = (1, 64, 1024)
#: largest gap of a fold's AuPR to the committed fixture's (trained by the
#: JAX package's fused sweep, its metrics in float32): the card sums the
#: histograms in fixed point and its exp may differ by an ulp, so near-tied
#: splits can flip.  Measured on the H100: 2.7e-5 and 1.9e-5 in two runs
TRAIN_AUPR_TOL = 2e-4
#: largest gap of K-I's correlation matrix to its plain version (cuBLAS):
#: float32 sums of 100k products in another order
STATS_GRAM_ATOL = 2e-6
#: largest gap of K-K's gradients to its plain version (cuBLAS products),
#: relative to the largest gradient entry: float32 sums of 2^18 rows in
#: another order
FISTA_GRAD_RTOL = 1e-5


def check(cond, msg="check failed"):
    if not cond:
        raise AssertionError(msg)


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def titanic_columns(n, seed):
    """A Titanic-schema columnar batch of ``n`` rows from ``seed``."""
    rng = np.random.default_rng(seed)
    cols = {
        "PassengerId": np.arange(1, n + 1),
        "Survived": rng.integers(0, 2, n),
        "Pclass": rng.choice([1, 2, 3], n),
        "Name": rng.choice(["p", "q"], n, p=[0.95, 0.05]).astype(object),
        "Sex": rng.choice(["male", "female"], n).astype(object),
        "Age": rng.uniform(1, 80, n),
        "SibSp": rng.integers(0, 4, n),
        "Parch": rng.integers(0, 3, n),
        "Fare": rng.uniform(5, 100, n),
        "Embarked": rng.choice(["S", "C", "Q"], n).astype(object),
    }
    cols["Age"][rng.random(n) < 0.2] = np.nan
    cols["Fare"][rng.random(n) < 0.01] = np.nan
    cols["Embarked"][rng.random(n) < 0.01] = None
    return cols


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median milliseconds of a callable over ``reps`` runs, by CUDA events,
    with the 50 MB L2 flushed before each run (the serve path meets its
    inputs cold).  A spin of the card after the flush holds the start event
    back until the host has queued the call's kernels, so the time is the
    card's and not the host's launch overhead."""

    SPIN_CYCLES = 2_000_000  # ~1.1 ms at the H100's boost clock

    def __init__(self, torch, reps):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn):
        torch = self.torch
        fn()  # warm-up: compiles a Triton kernel on its first call
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_steps(tree, leaves, max_depth):
    """Node visits the walk made for these rows: the depth of each (row,
    tree) leaf, from a breadth-first pass over the pools."""
    sf = tree.split_feat.cpu().numpy()
    lt, rt = tree.left.cpu().numpy(), tree.right.cpu().numpy()
    T = sf.shape[0]
    depth = np.zeros(sf.shape, np.int64)
    tt, nn = np.arange(T), np.zeros(T, np.int64)
    for level in range(1, max_depth + 1):
        keep = sf[tt, nn] >= 0
        tt, nn = tt[keep], nn[keep]
        if not tt.size:
            break
        tt, nn = np.concatenate([tt, tt]), np.concatenate([lt[tt, nn], rt[tt, nn]])
        depth[tt, nn] = level
    leaves = leaves.cpu().numpy()
    return int(depth[np.arange(T)[None, :], leaves].sum())


def kernel_phase(torch, model, cols, timer):
    """Each kernel against its plain version on the main path's inputs."""
    from transmogrifai_tpu_torch.ops import trees as Tr
    from transmogrifai_tpu_torch.ops import vectorize as V

    dev = model.device
    full = model.score(cols, keep_intermediate_features=True)
    by_type = {type(s).__name__: s for s in model.stages}
    rv, oh, sel = by_type["RealVectorizerModel"], by_type["OneHotVectorizerModel"], model.stages[-1]

    def upload(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    values, mask, fills = upload(rv.torch_host_prep([full[f.name] for f in rv.inputs]))
    (codes,) = upload(oh.torch_host_prep([full[f.name] for f in oh.inputs]))
    widths = oh._widths()
    X = full[sel.inputs[-1].name].tensor(dev)
    dparams = sel._device_params()
    edges, tree = dparams["edges"], dparams["tree"]
    depth, eta = int(dparams["max_depth"]), float(dparams["eta"])
    Xb = Tr.bin_rows_plain(X, edges)
    track = bool(rv.track_nulls)
    n, d = X.shape
    k, W = values.shape[0], 2 * values.shape[0] if track else values.shape[0]
    T, P, c = tree.leaf_val.shape
    XT = X.T.contiguous()
    records = []

    # K-A bin_rows
    got, want = Tr.bin_rows(X, edges), Tr.bin_rows_plain(X, edges)
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max().item())
    check(torch.equal(got, want) and got.dtype == want.dtype, "bin_rows differs from plain")
    levels = Tr._search_levels(edges.shape[1])
    b, by = bound_ms(n * d * 4 + edges.numel() * 4 + n * d * got.element_size(),
                     n * d * levels)
    records.append(dict(
        name="bin_rows", route="cuda", source="transmogrifai_tpu_torch/csrc/bin_rows.cu",
        replaces="transmogrifai_tpu/ops/trees.py:84", max_abs_err=float(err),
        ms=timer(lambda: Tr.bin_rows(X, edges)),
        plain_ms=timer(lambda: Tr.bin_rows_plain(X, edges)),
        bound_ms=b, bound_by=by,
        library_ms=timer(lambda: torch.searchsorted(edges, XT, side="left"))))

    # K-B ensemble_walk
    F, leaves = Tr.ensemble_walk(Xb, tree, depth, "sum", eta, 0.0, return_leaves=True)
    F0, leaves0 = Tr.ensemble_walk_plain(Xb, tree, depth, "sum", eta, 0.0, return_leaves=True)
    torch.cuda.synchronize()
    check(torch.equal(leaves, leaves0), "ensemble_walk leaves differ from plain")
    torch.testing.assert_close(F, F0, atol=1e-5, rtol=1e-5)
    steps = walk_steps(tree, leaves, depth)
    pool_bytes = T * P * (4 * 4 + 4 * c)
    b, by = bound_ms(n * d * Xb.element_size() + pool_bytes + n * c * 4,
                     2 * steps + n * T * c)
    records.append(dict(
        name="ensemble_walk", route="cuda",
        source="transmogrifai_tpu_torch/csrc/ensemble_walk.cu",
        replaces="transmogrifai_tpu/ops/trees.py:665", max_abs_err=float((F - F0).abs().max()),
        ms=timer(lambda: Tr.ensemble_walk(Xb, tree, depth, "sum", eta, 0.0)),
        plain_ms=timer(lambda: Tr.ensemble_walk_plain(Xb, tree, depth, "sum", eta, 0.0)),
        bound_ms=b, bound_by=by, library_ms=None, node_steps=steps))
    del F0, leaves0

    # K-C fill_indicator
    got = V.fill_indicator(values, mask, fills, track)
    want = V.fill_indicator_plain(values, mask, fills, track)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "fill_indicator differs from plain")
    b, by = bound_ms(k * n * 5 + k * 4 + n * W * 4, n * W)
    records.append(dict(
        name="fill_indicator", route="triton",
        source="transmogrifai_tpu_torch/ops/triton_vectorize.py",
        replaces="transmogrifai_tpu/impl/feature/vectorizers.py:108",
        max_abs_err=float((got - want).abs().max()),
        ms=timer(lambda: V.fill_indicator(values, mask, fills, track)),
        plain_ms=timer(lambda: V.fill_indicator_plain(values, mask, fills, track)),
        bound_ms=b, bound_by=by, library_ms=None))

    # K-D one_hot_codes
    got, want = V.one_hot_codes(codes, widths), V.one_hot_codes_plain(codes, widths)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "one_hot_codes differs from plain")
    Wd = sum(widths)
    b, by = bound_ms(codes.numel() * 4 + 2 * Wd * 4 + n * Wd * 4, n * Wd)
    codes_l = [codes[j].long() for j in range(len(widths))]

    def library_one_hot():
        return torch.cat([torch.nn.functional.one_hot(cj, w)
                          for cj, w in zip(codes_l, widths)], dim=1)

    records.append(dict(
        name="one_hot_codes", route="triton",
        source="transmogrifai_tpu_torch/ops/triton_vectorize.py",
        replaces="transmogrifai_tpu/impl/feature/vectorizers.py:403",
        max_abs_err=float((got - want).abs().max()),
        ms=timer(lambda: V.one_hot_codes(codes, widths)),
        plain_ms=timer(lambda: V.one_hot_codes_plain(codes, widths)),
        bound_ms=b, bound_by=by, library_ms=timer(library_one_hot)))
    log("kernels", rows=n, shapes={"X": [n, d], "edges": list(edges.shape),
                                   "pool": [T, P, c], "fill_values": [k, n],
                                   "one_hot_widths": widths},
        records=records)
    return records


def serve_phase(torch, model, cols, reps, seed, kernels):
    """The main path: request batches through ``BatchScoreFunction``, a few
    records through ``ScoreFunction``, and the big batch through
    ``OpWorkflowModel.score``; returns each kernel's launches in it."""
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch import fixtures as FX

    name = model.result_features[0].name
    batch_fn = P.BatchScoreFunction(model)
    row_fn = P.ScoreFunction(model)
    recs = FX.records(titanic_columns(max(BATCH_SIZES), seed + 1))
    rows = len(next(iter(cols.values())))
    for fn in kernels:
        fn.launches = 0
    p50 = {}
    for size in BATCH_SIZES:
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            out = batch_fn(recs[:size])
            times.append((time.perf_counter() - t) * 1e3)
            check(len(out) == size, f"{len(out)} answers for {size} records")
            _, prob, _ = FX.prediction_arrays(out, name)
            check(np.isfinite(prob).all() and np.allclose(prob.sum(1), 1.0), "bad probabilities")
        p50[size] = statistics.median(times)
    singles = [row_fn(r) for r in recs[:4]]
    t = time.perf_counter()
    scored = model.score(cols)
    wall = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in kernels}
    pc = scored[name]
    check(pc.probability.shape == (rows, 2) and np.isfinite(pc.probability).all(),
          "bad scores of the big batch")
    check(np.isfinite(pc.raw_prediction).all(), "non-finite margins")
    for a, b in zip(singles, batch_fn(recs[:4])):
        check(abs(a[name]["probability_1"] - b[name]["probability_1"]) <= FX.PROB_ATOL,
              "ScoreFunction and BatchScoreFunction disagree")
    log("serve", p50_ms_by_batch=p50, rows=rows, score_s=wall,
        rows_per_s=rows / wall, launches=launches)
    return launches


def breakdown_phase(torch, model, cols):
    """Where the big batch's time goes: the reader and each DAG layer on
    the host clock (synchronized), and the device's busy time over one
    whole ``score`` by the profiler (``None`` when it records no device
    activity)."""
    from torch.profiler import ProfilerActivity, profile

    from transmogrifai_tpu_torch.readers.base import CustomReader
    from transmogrifai_tpu_torch.workflow import dag

    steps = {}
    t = time.perf_counter()
    ds = CustomReader(cols).generate_dataset(model.raw_features)
    steps["reader"] = time.perf_counter() - t
    for i, layer in enumerate(model.dag):
        t = time.perf_counter()
        ds = dag._apply_layer_transforms(ds, layer)
        torch.cuda.synchronize()
        steps[f"layer{i}:" + "+".join(sorted({type(s).__name__ for s in layer}))] = \
            time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.score(cols)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    busy_s = busy_us / 1e6 if busy_us > 0 else None
    log("breakdown", rows=len(ds), host_clock_s=steps, profiled_score_s=wall,
        device_busy_s=busy_s, device_idle_share=None if busy_s is None else 1 - busy_s / wall)


def train_reference_phase(torch, titanic, FX, dev="cuda"):
    """The full-width Titanic XGB train on the 891-row frame, held to the
    committed fixture; returns nothing, raises on a failed check."""
    import tempfile

    import transmogrifai_tpu_torch as P

    t = time.perf_counter()
    model, wf = titanic.train_titanic(device=dev, model_types=["OpXGBoostClassifier"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with open(FX.TITANIC_XGB + "/op_model.json") as fh:
        fx = json.load(fh)["stages"][-1]["state"]
    fsum = fx["summary"]["__jsonable__"]["data"]
    summ = model.stages[-1].summary
    check(summ.best_grid == fsum["bestGrid"] and summ.best_grid["min_child_weight"] == 1.0,
          f"winner {summ.best_grid} differs from the fixture's {fsum['bestGrid']}")
    gaps = []
    for mine, ref in zip(summ.validation_results, fsum["validationResults"]):
        check(mine["grid"] == ref["grid"], "candidate order differs from the fixture's")
        gaps.append(max(abs(a - b) for a, b in zip(mine["foldMetrics"], ref["foldMetrics"])))
    # refit trees structurally equal to the fixture's (printed, not checked)
    with np.load(FX.TITANIC_XGB + "/op_model_arrays.npz") as z:
        ref_arrays = {k: z[fx["model_params"]["__dict__"][k]["__array__"]]
                      for k in ("split_feat", "split_bin", "left", "right")}
    params = model.stages[-1].model_params
    same = np.all([(ref_arrays[k] == params[k]).all(axis=1) for k in ref_arrays], axis=0)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = P.load_model(tmp, device=dev)
        req = FX.load_columns(FX.TITANIC_XGB + "/requests.npz")
        pred, prob, raw, Xb, F = FX.port_answers(loaded, req)
    exp = FX.load_expected()
    off = np.abs(np.asarray(exp["F"], np.float64)[:, 0]) >= FX.BOUNDARY
    log("train_reference", rows=891, wall_s=wall, best_grid=summ.best_grid,
        fold_aupr={str(r["grid"]["min_child_weight"]): r["foldMetrics"]
                   for r in summ.validation_results},
        fixture_fold_aupr={str(r["grid"]["min_child_weight"]): r["foldMetrics"]
                           for r in fsum["validationResults"]},
        fold_aupr_max_gap=max(gaps), tolerance=TRAIN_AUPR_TOL,
        refit_trees_equal_to_fixture=f"{int(same.sum())}/{len(same)}",
        requests_vs_expected={
            "prediction_mismatches_off_boundary": int(np.sum(pred[off] != exp["prediction"][off])),
            "probability_max_abs_err": float(np.max(np.abs(prob - exp["probability"]))),
            "margin_max_abs_err": float(np.max(np.abs(F - exp["F"]))),
            "Xb_mismatches": int(np.sum(Xb != exp["Xb"]))},
        timings_s=wf.train_timings)
    check(max(gaps) <= TRAIN_AUPR_TOL,
          f"fold AuPR {max(gaps)} from the fixture's, above {TRAIN_AUPR_TOL}")


class SweepCalls:
    """Records each fused sweep call's plan, folds and metrics while on
    (``SweepPlan.run`` wrapped, restored on exit)."""

    def __init__(self):
        from transmogrifai_tpu_torch.impl import sweep_fragments as SF

        self.SF, self.calls = SF, []

    def __enter__(self):
        run = self.run = self.SF.SweepPlan.run

        def recording_run(plan, train_w, val_mask, timings=None):
            out = run(plan, train_w, val_mask, timings)
            self.calls.append((plan, train_w, val_mask, out))
            return out

        self.SF.SweepPlan.run = recording_run
        return self

    def __exit__(self, *exc):
        self.SF.SweepPlan.run = self.run


def sweep_reference_phase(torch, titanic, FX, dev="cuda"):
    """The full-width stock train on the 891-row frame, held to the
    committed stock fixture; raises on a failed check."""
    import tempfile

    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.ops import trees as Tr

    with SweepCalls() as rec:
        t = time.perf_counter()
        model, wf = titanic.train_titanic(device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    summ = model.stages[-1].summary
    gaps = FX.check_stock_train(model, xgb_tol=TRAIN_AUPR_TOL)
    ref = FX.load_sweep()
    kb, kf = Tr.rng_keys(42)
    boot = Tr.bootstrap_weights(kb, 891, 50, device=dev).cpu().numpy()
    masks = Tr.feature_masks(kf, 10, 50, np.sqrt(10) / 10, dev).cpu().numpy()
    check(np.array_equal(boot, ref["bootstrap"]), "bootstrap draws differ from the fixture's")
    check(np.array_equal(masks, ref["feature_masks"]), "feature masks differ from the fixture's")
    mine = np.stack([out for *_, out in rec.calls])
    check(mine.shape == ref["metrics"].shape, f"sweep metrics {mine.shape}")
    fams = {"lr": slice(0, 8), "rf": slice(8, 26), "xgb": slice(26, 28)}
    metric_gaps = {f: dict(zip(("AuROC", "AuPR", "Error", "Precision", "Recall", "F1"),
                               np.abs(mine[:, :, sl] - ref["metrics"][:, :, sl])
                               .max(axis=(0, 1, 2)).tolist())) for f, sl in fams.items()}
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = P.load_model(tmp, device=dev)
        req = FX.load_columns(FX.TITANIC_STOCK + "/requests.npz")
        name = loaded.result_features[0].name
        pred, prob, raw = FX.prediction_arrays(P.BatchScoreFunction(loaded)(FX.records(req)),
                                               name)
    answers = FX.compare(FX.load_expected(FX.TITANIC_STOCK + "/expected.npz"), pred, prob, raw)
    log("sweep_reference", rows=891, wall_s=wall, best=summ.best_model_name,
        best_grid=summ.best_grid, fold_aupr_max_gap_by_family=gaps,
        tolerances={"lr": FX.LR_AUPR_TOL, "rf": FX.RF_AUPR_TOL, "xgb": TRAIN_AUPR_TOL},
        sweep_calls=len(rec.calls), metric_max_gap_by_family=metric_gaps,
        draws_equal=True, requests_vs_expected=answers, timings_s=wf.train_timings)


def train_phase(torch, titanic, rows, seed, kernels, dev="cuda"):
    """The main path of training at ``rows`` rows: launch counts reset just
    before and read just after; then a profiled second run.  Returns (each
    kernel's launches, the trained model, the first sweep call)."""
    from torch.profiler import ProfilerActivity, profile

    cols = titanic.titanic_data(rows, seed)
    for fn in kernels:
        fn.launches = 0
    with SweepCalls() as rec:
        t = time.perf_counter()
        model, wf = titanic.train_titanic(cols, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in kernels}
    summ = model.stages[-1].summary
    folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
    check(len(summ.validation_results) == 28, "the stock space has 28 candidates")
    check(all(np.isfinite(folds)) and min(folds) > 0.5, f"bad fold metrics {folds}")
    check(summ.holdout_evaluation["AuPR"] > 0.5, "bad holdout AuPR")
    timings = dict(wf.train_timings)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        titanic.train_titanic(cols, device=dev)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    busy_s = busy_us / 1e6 if busy_us > 0 else None
    by_kernel = sorted(((e.key, getattr(e, "self_device_time_total", 0) / 1e6, e.count)
                        for e in prof.key_averages()
                        if getattr(e, "self_device_time_total", 0) > 0),
                       key=lambda r: -r[1])[:12]
    plan = rec.calls[0][0]
    log("train", rows=rows, wall_s=wall, launches=launches, host_clock_s=timings,
        best=summ.best_model_name, best_grid=summ.best_grid,
        fold_aupr_by_family={f: [r["foldMetrics"] for r in summ.validation_results
                                 if r["modelName"] == f]
                             for f in ("OpLogisticRegression", "OpXGBoostClassifier")},
        holdout_aupr=summ.holdout_evaluation["AuPR"], sweep_spec=repr(plan.spec),
        sweep_rows=int(plan.X.shape[0]), sweep_features=int(plan.X.shape[1]),
        profiled_train_s=prof_wall, device_busy_s=busy_s,
        device_idle_share=None if busy_s is None else 1 - busy_s / prof_wall,
        device_s_by_kernel=by_kernel)
    return launches, model, rec.calls[0][:3]


def train_kernel_phase(torch, model, timer, dev="cuda"):
    """K-E ... K-H against their plain versions at the train path's shapes:
    the inputs of the deepest level of the second round of one sweep fold
    (T = 2 trees: min_child_weight 1 and 10) on the trained model's feature
    matrix.  The first round's gradients (margins 0) are two dyadic values,
    which every order sums exactly; the second round's are not."""
    from transmogrifai_tpu_torch.ops import trees as Tr

    dev = torch.device(dev)
    sel = model.stages[-1]
    X = model.train_data[sel.inputs[-1].name].tensor(dev)
    y = torch.from_numpy(model.train_data[sel.inputs[0].name].values.astype(np.float32)).to(dev)
    depth, B, T = 10, 32, 2
    Xb, _ = Tr.quantize(X, B)
    n, d = Xb.shape
    n_tr = 2 * n // 3  # one fold's training rows; the rest only route
    w = torch.zeros((T, n), device=dev)
    w[:, :n_tr] = 1.0
    frontier = Tr.frontier_cap(n, depth, 1.0, h_max=0.25, max_frontier=256,
                               total_weight=float(n_tr))
    exact = Tr.frontier_is_exact(n, depth, 1.0, 0.25, frontier, total_weight=float(n_tr))
    params = torch.tensor([[1.0, 0.8, 1.0, 0.0], [1.0, 0.8, 10.0, 0.0]], device=dev)
    fm = torch.ones((T, d), device=dev)
    eta = torch.full((T,), 0.02, device=dev)
    F = torch.zeros((T, n), device=dev)
    ghw = torch.empty((T, n, 2), device=dev)
    P_ = Tr._pool_size(depth, frontier)
    nodes = torch.empty((T, P_, 4), dtype=torch.int32, device=dev)
    leaf = torch.empty((T, P_), device=dev)

    def grow():
        """One round's tree through K-E, K-F, K-G; the deepest level's
        arguments of each, and the rows' nodes."""
        row_slot = torch.zeros((T, n), dtype=torch.int32, device=dev)
        row_node = torch.zeros_like(row_slot)
        n_active = torch.ones((T,), dtype=torch.int32, device=dev)
        ids, hist, pp, pl = row_slot, None, None, None
        for t, (m, sb, nf, nc, cap) in enumerate(Tr.level_schedule(depth, frontier, exact)):
            e_args = (Xb, ghw, ids, m, B) + ((hist, pp, pl) if t else ())
            hist = Tr.level_hist(*e_args)
            f_args = (hist, fm, params, n_active, nodes, leaf, sb, nf, nc, cap, t == 0)
            split, pp, pl, n_active = Tr.split_scan(*f_args)
            g_args = (Xb, row_slot, row_node, split, pl, nf)
            row_slot, row_node, ids = Tr.route_rows(*g_args)
        return e_args, f_args, g_args, hist, nc, row_node

    Tr.boost_step(F, y, w, eta, ghw=ghw)
    *_, row_node = grow()
    Tr.boost_step(F, y, w, eta, leaf, row_node, ghw)  # the second round's gradients
    scaled = ghw * 1024.0
    non_dyadic = float((scaled != torch.round(scaled)).float().mean())
    check(non_dyadic > 0.25, f"second-round gradients mostly dyadic ({non_dyadic})")
    e_args, f_args, g_args, hist, nc, row_node = grow()
    torch.cuda.synchronize()
    records = []
    m_deep = e_args[3]

    # K-E level_hist: the fixed-point sums make it bit-equal to its plain
    # version and to itself, on integer-valued and on the second round's
    # real gradients
    ghw_int = torch.round(ghw * 64.0)
    int_args = (Xb, ghw_int) + e_args[2:]
    check(torch.equal(Tr.level_hist(*int_args), Tr.level_hist_plain(*int_args)),
          "level_hist differs from plain on integer-valued gradients")
    got, want = Tr.level_hist(*e_args), Tr.level_hist_plain(*e_args)
    check(torch.equal(got, Tr.level_hist(*e_args)), "level_hist does not repeat bit for bit")
    check(torch.equal(got, want), "level_hist differs from plain")
    err_e = float((got - want).abs().max())
    pairs = m_deep // 2
    idx = (e_args[2].long() * B)[:, None, :] + Xb.long().T[None]
    dead = (e_args[2] < 0)[:, None, :].expand(T, d, n)
    seg_n = pairs * B + 1
    offs = (torch.arange(T * d, device=dev) * seg_n).view(T, d, 1)
    idx = torch.where(dead, pairs * B, idx) + offs
    idx = idx.reshape(-1)
    src = ghw[:, None].expand(T, d, n, 2).reshape(-1, 2).contiguous()
    zeros = torch.zeros((T * d * seg_n, 2), device=dev)
    hist_bytes = T * m_deep * 2 * d * B * 4
    # Xb once, g, h and the pair id per (tree, row), the parent histograms,
    # the pairs' parent and flag, the level's histograms written once
    b, by = bound_ms(n * d + T * n * 12 + e_args[5].numel() * 4 + T * pairs * 8 + hist_bytes,
                     T * n * d * 2)
    records.append(dict(
        name="level_hist", route="cuda", source="transmogrifai_tpu_torch/csrc/level_hist.cu",
        replaces="transmogrifai_tpu/ops/trees.py:327", max_abs_err=err_e,
        ms=timer(lambda: Tr.level_hist_launch(*e_args)),
        plain_ms=timer(lambda: Tr.level_hist_plain(*e_args)),
        bound_ms=b, bound_by=by,
        library_ms=timer(lambda: torch.index_add(zeros, 0, idx, src))))

    # K-F split_scan: one histogram for both, every output bit-equal
    outs = []
    for fn in (Tr.split_scan, Tr.split_scan_plain):
        nd, lf = f_args[4].clone(), f_args[5].clone()
        outs.append((nd, lf) + tuple(fn(*f_args[:4], nd, lf, *f_args[6:])))
    check(all(torch.equal(a, b) for a, b in zip(*outs)), "split_scan differs from plain")
    # the histograms read once, the slot records and split records written,
    # the child block's records and leaves and the next pairs written; about
    # 14 operations per candidate split (prefix sums, gain, masks, argmax)
    b, by = bound_ms(hist_bytes + T * m_deep * (16 + 16) + T * nc * (16 + 4) + T * nc * 4,
                     T * m_deep * d * B * 14)
    records.append(dict(
        name="split_scan", route="cuda", source="transmogrifai_tpu_torch/csrc/split_scan.cu",
        replaces="transmogrifai_tpu/ops/trees.py:449", max_abs_err=0.0,
        ms=timer(lambda: Tr.split_scan(*f_args)),
        plain_ms=timer(lambda: Tr.split_scan_plain(*f_args[:4], f_args[4].clone(),
                                                   f_args[5].clone(), *f_args[6:])),
        bound_ms=b, bound_by=by, library_ms=None))

    # K-G route_rows: the same records for both, bit-equal
    got, want = Tr.route_rows(*g_args), Tr.route_rows_plain(*g_args)
    check(all(torch.equal(a, b) for a, b in zip(got, want)), "route_rows differs from plain")
    # per (tree, row): slot and node read, one bin read, slot, node and pair
    # id written; the split records and pair flags read once
    b, by = bound_ms(T * n * (4 + 4 + 1 + 4 + 4 + 4) + T * m_deep * 16 + T * pairs * 4,
                     T * n * 4)
    records.append(dict(
        name="route_rows", route="cuda", source="transmogrifai_tpu_torch/csrc/route_rows.cu",
        replaces="transmogrifai_tpu/ops/trees.py:524", max_abs_err=0.0,
        ms=timer(lambda: Tr.route_rows(*g_args)),
        plain_ms=timer(lambda: Tr.route_rows_plain(*g_args)),
        bound_ms=b, bound_by=by, library_ms=None))

    # K-H boost_step: the next round's step on this round's tree
    F1, F2 = F.clone(), F.clone()
    g1, g2 = torch.empty_like(ghw), torch.empty_like(ghw)
    Tr.boost_step(F1, y, w, eta, leaf, row_node, g1)
    Tr.boost_step_plain(F2, y, w, eta, leaf, row_node, g2)
    check(torch.equal(F1, F2), "boost_step margins differ from plain")
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=2.5e-7)
    err_h = float((g1 - g2).abs().max())
    # per (tree, row): F read and written, w and the row's node read, one
    # leaf gathered, g and h written; y once; about 12 operations
    b, by = bound_ms(T * n * (4 + 4 + 4 + 4 + 4 + 8) + n * 4, T * n * 12)
    records.append(dict(
        name="boost_step", route="triton", source="transmogrifai_tpu_torch/ops/triton_boost.py",
        replaces="transmogrifai_tpu/ops/trees.py:1117", max_abs_err=err_h,
        ms=timer(lambda: Tr.boost_step(F1, y, w, eta, leaf, row_node, g1)),
        plain_ms=timer(lambda: Tr.boost_step_plain(F2, y, w, eta, leaf, row_node, g2)),
        bound_ms=b, bound_by=by, library_ms=None))
    # the wrapper's range check waits for the card: its time, apart
    check_ms = timer(lambda: Tr.level_hist(*e_args))
    log("train_kernels", rows=n, shapes={"Xb": [n, d], "ghw": [T, n, 2],
                                         "hist": list(hist.shape), "pool": [T, P_],
                                         "frontier": frontier, "exact_cap": exact},
        round=2, non_dyadic_share=non_dyadic, level_hist_with_range_check_ms=check_ms,
        records=records)
    return records


def stats_kernel_phase(torch, model, timer, dev="cuda"):
    """K-I and K-J against their plain versions at the train path's shapes:
    the sanity checker's inputs on the ``--train-rows`` data (its 100k-row
    sample of the combined vector, standardized for K-I; the categorical
    groups' indicator columns and the label classes for K-J)."""
    from transmogrifai_tpu_torch.ops import stats as K

    dev = torch.device(dev)
    sc = next(s for s in model.stages if type(s).__name__ == "SanityCheckerModel")
    X = model.train_data[sc.inputs[1].name].tensor(dev)
    meta = model.train_data[sc.inputs[1].name].metadata
    y = np.asarray(model.train_data[sc.inputs[0].name].values, np.float64)
    n_all = X.shape[0]
    idx = np.random.default_rng(42).choice(n_all, size=min(n_all, 100_000), replace=False)
    X = X.index_select(0, torch.as_tensor(idx, device=dev))
    y = y[idx]
    n, d = X.shape
    X64 = X.double()
    Z = ((X64 - X64.mean(0)) / torch.sqrt(torch.clamp(X64.var(0), min=1e-300))).float()
    cols = [i for i, cm in enumerate(meta.columns) if cm.feature_group() is not None]
    Xc = X[:, cols].contiguous()
    classes = np.unique(y)
    cls = torch.from_numpy(np.searchsorted(classes, y).astype(np.int32)).to(dev)
    c, dc = len(classes), len(cols)
    records = []

    # K-I corr_gram: float32 sums in another order than cuBLAS's
    got, want = K.corr_gram(Z), K.corr_gram_plain(Z)
    check(torch.equal(got, K.corr_gram(Z)), "corr_gram does not repeat bit for bit")
    finite = torch.isfinite(want)
    check(torch.equal(finite, torch.isfinite(got)), "corr_gram differs from plain in NaN/inf")
    err_i = float((got - want)[finite].abs().max())
    check(err_i <= STATS_GRAM_ATOL, f"corr_gram {err_i} from plain, above {STATS_GRAM_ATOL}")
    # Z read once, the d x d matrix written once; n d^2 multiply-adds
    b, by = bound_ms(n * d * 4 + d * d * 4, 2 * n * d * d)
    records.append(dict(
        name="corr_gram", route="cuda", source="transmogrifai_tpu_torch/csrc/col_stats.cu",
        replaces="transmogrifai_tpu/utils/stats.py:47", max_abs_err=err_i,
        ms=timer(lambda: K.corr_gram(Z)), plain_ms=timer(lambda: K.corr_gram_plain(Z)),
        bound_ms=b, bound_by=by, library_ms=timer(lambda: torch.mm(Z.T, Z))))

    # K-J contingency_counts: integer counts, bit-equal
    got, want = K.contingency_counts(Xc, cls, c), K.contingency_counts_plain(Xc, cls, c)
    check(torch.equal(got, want), "contingency_counts differs from plain")
    zeros = torch.zeros((c, dc), device=dev)
    cls_l = cls.long()
    # the columns and classes read once, the counts written once; one add
    # per (row, column)
    b, by = bound_ms(n * dc * 4 + n * 4 + dc * c * 4, n * dc)
    records.append(dict(
        name="contingency_counts", route="cuda",
        source="transmogrifai_tpu_torch/csrc/col_stats.cu",
        replaces="transmogrifai_tpu/utils/stats.py:137",
        max_abs_err=float((got - want).abs().max()),
        ms=timer(lambda: K.contingency_counts(Xc, cls, c)),
        plain_ms=timer(lambda: K.contingency_counts_plain(Xc, cls, c)),
        bound_ms=b, bound_by=by, library_ms=timer(lambda: torch.index_add(zeros, 0, cls_l, Xc))))
    log("stats_kernels", rows=n, shapes={"Z": [n, d], "indicators": [n, dc], "classes": c},
        records=records)
    return records


def sweep_kernel_phase(torch, call, timer):
    """K-K, K-L and K-M against their plain versions on the first sweep call
    of the ``--train-rows`` train: its feature matrix, folds and spec."""
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import sweep as SW
    from transmogrifai_tpu_torch.ops import trees as Tr

    plan, train_w, val_mask = call
    X, y, xbs, blob = plan.X, plan.y, plan.xbs, plan.blob
    dev = X.device
    tw = torch.as_tensor(np.asarray(train_w, np.float32), device=dev).contiguous()
    vm = torch.as_tensor(np.asarray(val_mask, np.float32), device=dev)
    n, d = X.shape
    F = tw.shape[0]
    frags = {f[0]: f for f in plan.spec[1]}
    records = []

    # K-K fista_grad: the gradients at the sweep's fitted coefficients
    _, cis, max_iter, fit_icpt, off_l1, off_l2 = frags["fista"]
    G = len(cis)
    l1, l2 = blob[off_l1:off_l1 + G], blob[off_l2:off_l2 + G]
    fit = L.fit_logistic_grid_folds_fista(X, y, tw, l1, l2, max_iter=max_iter,
                                          fit_intercept=fit_icpt)
    C = F * G
    z = torch.cat([fit.coef, fit.intercept], -1).reshape(C, d + 1).contiguous()
    X1 = torch.cat([X, torch.ones((n, 1), device=dev)], 1).contiguous()
    p = d + 1
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
    l2v = torch.as_tensor(np.tile(l2, F), device=dev)[:, None].repeat(1, p).contiguous()
    l2v[:, -1] = 0.0
    wsum = torch.clamp_min(tw.sum(1), 1e-12)[fold.long()].contiguous()
    args = (X1, y, tw, fold, z, l2v, wsum)
    got, want = L.fista_grad(*args), L.fista_grad_plain(*args)
    check(torch.equal(got, L.fista_grad(*args)), "fista_grad does not repeat bit for bit")
    scale = float(want.abs().max())
    err_k = float((got - want).abs().max())
    check(err_k <= FISTA_GRAD_RTOL * scale,
          f"fista_grad {err_k} from plain, above {FISTA_GRAD_RTOL} x {scale}")
    wc = tw[fold.long()]
    # X1, each fold's weights and y read once, z / l2v / wsum read and the
    # gradients written; per (fit, row) the margin and the accumulation
    # (4 p operations) and the sigmoid and residual (about 20)
    b, by = bound_ms((n * p + F * n + n) * 4 + C * (3 * p + 1) * 4, C * n * (4 * p + 20))
    records.append(dict(
        name="fista_grad", route="cuda", source="transmogrifai_tpu_torch/csrc/fista.cu",
        replaces="transmogrifai_tpu/ops/linear.py:105", max_abs_err=err_k,
        ms=timer(lambda: L.fista_grad(*args)), plain_ms=timer(lambda: L.fista_grad_plain(*args)),
        bound_ms=b, bound_by=by,
        library_ms=timer(lambda: torch.matmul(wc * (torch.sigmoid(torch.matmul(X1, z.T)).T - y),
                                              X1) / wsum[:, None] + l2v * z)))

    # K-L binary_metrics: the sweep's 28 score rows, sorted once
    scores = SW._all_scores(plan.spec, X, xbs, y, tw, np.asarray(blob, np.float32))
    R = scores.shape[0] * scores.shape[1]
    ss, order = M.sort_scores(scores, vm)
    strict = torch.as_tensor(plan.spec[2], dtype=torch.int32, device=dev)
    margs = (ss, order, y, vm, strict, scores.shape[1])
    got, want = M.binary_metrics(*margs), M.binary_metrics_plain(*margs)
    check(torch.equal(got, want), "binary_metrics differs from plain")
    # the sorted scores and permutation, y and the masks read once, six
    # floats a row written; about 12 operations an element in two passes
    b, by = bound_ms(R * n * (4 + 8) + n * 4 + F * n * 4 + R * 6 * 4, R * n * 12)
    sort_ms = timer(lambda: M.sort_scores(scores, vm))
    records.append(dict(
        name="binary_metrics", route="cuda",
        source="transmogrifai_tpu_torch/csrc/binary_metrics.cu",
        replaces="transmogrifai_tpu/ops/metrics.py:57", max_abs_err=0.0,
        ms=timer(lambda: M.binary_metrics(*margs)),
        plain_ms=timer(lambda: M.binary_metrics_plain(*margs)),
        bound_ms=b, bound_by=by, library_ms=None))

    # K-M forest_leaf_mean: the deepest forest group's leaves
    group = max(frags["forest"][2], key=lambda g: g[1])
    leaf, row_node = SW.grow_forest_group(group, xbs, y, tw, np.asarray(blob, np.float32))
    Gg, T, P_ = leaf.shape
    got, want = Tr.forest_leaf_mean(leaf, row_node), Tr.forest_leaf_mean_plain(leaf, row_node)
    check(torch.equal(got, want), "forest_leaf_mean differs from plain")
    rn_long = row_node.long()
    # the rows' leaves read once, the pools read once, the means written
    b, by = bound_ms(Gg * T * n * 4 + Gg * T * P_ * 4 + Gg * n * 4, Gg * T * n)
    records.append(dict(
        name="forest_leaf_mean", route="triton", source="transmogrifai_tpu_torch/ops/triton_forest.py",
        replaces="transmogrifai_tpu/ops/sweep.py:253", max_abs_err=0.0,
        ms=timer(lambda: Tr.forest_leaf_mean(leaf, row_node)),
        plain_ms=timer(lambda: Tr.forest_leaf_mean_plain(leaf, row_node)),
        bound_ms=b, bound_by=by, library_ms=timer(lambda: leaf.gather(2, rn_long).mean(1))))
    log("sweep_kernels", rows=n, shapes={"X1": [n, p], "fits": C, "score_rows": R,
                                         "forest_group": [Gg, T, P_], "depth": group[1]},
        fista_grad_scale=scale, sort_ms=sort_ms, records=records)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--train-rows", type=int, default=1 << 18)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch import fixtures as FX
    from transmogrifai_tpu_torch.ops import cuda_build
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import stats as K
    from transmogrifai_tpu_torch.ops import trees as Tr
    from transmogrifai_tpu_torch.ops import vectorize as V

    from transmogrifai_tpu_torch.apps import titanic

    kernels = (Tr.bin_rows, Tr.ensemble_walk, V.fill_indicator, V.one_hot_codes)
    train_kernels = (Tr.bin_rows, Tr.level_hist, Tr.split_scan, Tr.route_rows,
                     Tr.boost_step, K.corr_gram, K.contingency_counts, L.fista_grad,
                     M.binary_metrics, Tr.forest_leaf_mean)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # 1. device + build ------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_s = cuda_build.build()
    dev = torch.device("cuda")
    one = torch.ones((2, 8), device=dev)
    V.fill_indicator(one, one > 0, torch.ones(2, device=dev), True)
    V.one_hot_codes(torch.zeros((1, 8), dtype=torch.int32, device=dev), [3])
    Tr.boost_step(one, one[0], one, one[:, 0], ghw=torch.empty((2, 8, 2), device=dev))
    Tr.forest_leaf_mean(one[None], torch.zeros((1, 2, 8), dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    log("device", nvidia_smi=smi, name=kind, torch=torch.__version__,
        cuda=torch.version.cuda, build_s=time.perf_counter() - t0, nvcc_s=nvcc_s,
        ptxas={k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln]
               for k, v in cuda_build.BUILD_LOG.items()})

    model = P.load_model(FX.TITANIC_XGB)
    cols = titanic_columns(args.rows, args.seed)

    # 2. kernels against their plain versions ---------------------------------
    timer = Timer(torch, args.reps)
    records = kernel_phase(torch, model, cols, timer)

    # 3. reference: the JAX package's answers for the fixture's requests -----
    req = FX.load_columns(FX.TITANIC_XGB + "/requests.npz")
    pred, prob, raw, Xb, F = FX.port_answers(model, req)
    gaps = FX.compare(FX.load_expected(), pred, prob, raw, Xb=Xb, F=F)
    log("reference", rows=len(pred), **gaps)

    # 4. serve: the main path -------------------------------------------------
    launches = serve_phase(torch, model, cols, args.reps, args.seed, kernels)
    missing = [k for k, v in launches.items() if v <= 0]
    check(not missing, f"kernels not launched on the main path: {missing}")
    breakdown_phase(torch, model, cols)
    del cols

    # 6-11. training: the fixtures' trains, the main path at scale, kernels
    train_reference_phase(torch, titanic, FX)
    sweep_reference_phase(torch, titanic, FX)
    train_launches, trained, call = train_phase(torch, titanic, args.train_rows, args.seed,
                                                train_kernels)
    missing = [k for k, v in train_launches.items() if v <= 0]
    check(not missing, f"kernels not launched on the train path: {missing}")
    train_records = train_kernel_phase(torch, trained, timer)
    train_records += stats_kernel_phase(torch, trained, timer)
    train_records += sweep_kernel_phase(torch, call, timer)

    for r in records:
        r["launches"] = launches[r["name"]]
    for r in train_records:
        r["launches"] = train_launches[r["name"]]
    records += train_records
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
