"""Time K-U's gradient mode with its float64 accumulators in shared memory and
in device memory, at the main paths' networks, against its plain version.

``csrc/mlp.cu``'s ``mlp_plan`` keeps a fit's accumulators in shared memory
only while two blocks still fit an SM; this script measures both places
(the plan forced through ``ops/mlp._PLANS``) so that the rule can be checked
on the card.  Usage, from the repository root on a host with a CUDA card::

    python3 transmogrifai_tpu_torch/tools/mlp_accumulators.py [--reps 20]

Prints one JSON line a network and a last one with all of them: the plan
(tile rows, accumulators in shared memory), the median of ``--reps``
CUDA-event runs (L2 flushed) in ms and the relative error to the plain
version for each place, and the forward mode's time.  Inputs are made from a
seed with numpy.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

NETWORKS = (("titanic", (21, 10, 2), 1 << 18, 3), ("letters", (32, 128, 64, 26), 58983, 3),
            ("embed", (410, 128, 64, 32, 2), 1 << 17, 1), ("bow", (2110, 10, 2), 1 << 17, 1))


def timed(torch, fn, reps, flush):
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


def main(reps: int) -> dict:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))))
    import numpy as np
    import torch

    from transmogrifai_tpu_torch.ops import mlp as M

    if not torch.cuda.is_available():
        raise SystemExit("mlp_accumulators: no CUDA device")
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    for name, layers, n, F in NETWORKS:
        k = layers[-1]
        X = t((rng.normal(size=(n, layers[0])) * 2).astype(np.float32))
        y = t(rng.integers(0, k, n).astype(np.float32))
        w = t(rng.integers(0, 3, (F, n)).astype(np.float32))
        fold = torch.arange(F, dtype=torch.int32, device=dev)
        wsum = torch.clamp_min(w.sum(1), 1e-12).contiguous()
        flat = t((rng.normal(size=(F, M.param_count(layers))) * 0.1).astype(np.float32))
        args = (X, y, w, fold, wsum, flat, layers)
        want = M.mlp_grad_plain(*args)
        M.mlp_grad(*args)
        key = (True, tuple(layers))
        R, smem_acc = M._PLANS[key]
        row = {"plan": [R, smem_acc]}
        for place, acc in (("smem_acc", 1), ("device_acc", 0)):   # shared memory may not fit

            M._PLANS[key] = (R, acc)
            try:
                got = M.mlp_grad(*args)
            except M.cuda_build.KernelError:
                continue
            row[place] = {"ms": timed(torch, lambda: M.mlp_grad(*args), reps, flush),
                          "rel_err": float((got - want).abs().max() / want.abs().max())}
        M._PLANS[key] = (R, smem_acc)
        row["forward_ms"] = timed(torch, lambda: M.mlp_forward(X, flat, layers), reps, flush)
        out[name] = row
        print(json.dumps({name: row}), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    print(json.dumps(main(ap.parse_args().reps)), flush=True)
