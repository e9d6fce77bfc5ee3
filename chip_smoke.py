"""Chip smoke test of the PyTorch/CUDA port: serve a Titanic model on the GPU.

Run from the repository root on a host with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--rows 1048576] [--reps 20]

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
               busy time and idle share.

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
    inputs cold)."""

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch import fixtures as FX
    from transmogrifai_tpu_torch.ops import cuda_build
    from transmogrifai_tpu_torch.ops import trees as Tr
    from transmogrifai_tpu_torch.ops import vectorize as V

    kernels = (Tr.bin_rows, Tr.ensemble_walk, V.fill_indicator, V.one_hot_codes)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # 1. device + build ------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_s = cuda_build.build()
    dev = torch.device("cuda")
    one = torch.ones((2, 8), device=dev)
    V.fill_indicator(one, one > 0, torch.ones(2, device=dev), True)
    V.one_hot_codes(torch.zeros((1, 8), dtype=torch.int32, device=dev), [3])
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

    for r in records:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
