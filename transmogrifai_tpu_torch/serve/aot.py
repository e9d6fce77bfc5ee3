"""Per-bucket CUDA graphs: the device-resident serving feed.

The port's counterpart of ``transmogrifai_tpu/serve/aot.py``, whose
``BucketScorer`` lowers the fused transform sub-DAG of a model once per
(shape bucket, device) from ``workflow/stream.build_plan`` and compiles it
ahead of time (``compile_bucket`` :189, ``_score_bucket`` :249).  Here the
same plan's per-chunk program (``stream.program_for``) is captured once per
(shape bucket, replica) as one ``torch.cuda.CUDAGraph``:

- **plan**: built once per (model, result names) and memoized
  (``_PLAN_MEMO``); fewer than two fusable stages raise
  :class:`AotUnsupported`, and the replica serves through
  ``BatchScoreFunction`` on the same card (recorded as ``aot_unsupported``:
  a route, not a fallback from a kernel);
- **capture**: for each bucket, largest first, static device inputs shaped
  by ``stream.chunk_args(..., C=bucket)`` are allocated, the program runs
  once eagerly on the replica's stream (Triton's compile, the ``.so`` load
  and the allocator settle), then ``program(static)`` is captured into one
  graph in the replica's memory pool, on its stream, with
  ``capture_error_mode="thread_local"`` so that another replica scoring on
  the card cannot break it.  A host layer that is a single-output predictor
  with a ``predict_program`` whose vector input is a plan terminal joins the
  same graph (K-AF, ``ops/linear.predict_head``), as the JAX package keeps
  that matrix on its device through ``devcache.seed`` (:285-287);
- **score**: the records' arguments go through pinned staging into the
  bucket's static inputs (``non_blocking``), the graph replays, the
  terminals and head outputs are copied into pinned host buffers, one
  stream sync; the remaining host layers run in DAG order on the replica's
  stream (a predictor head through its ``predict_program`` on K-AF, the tree
  families through ``transform_dataset``: K-A, K-B) and the outputs follow
  ``BatchScoreFunction``'s contract element for element.  The graph's
  outputs are copied before the entry's lock is released, since the next
  replay overwrites them;
- **memo**: entries are keyed (plan key, bucket, device, slot) and counted
  by the scorers holding them, so a second deploy of the same model object
  (a rolling swap, a rebuilt slot) reuses the graphs; an entry and its pool
  are released when its last scorer is (``BucketScorer.release``, after the
  outgoing replica's drain).  ``warm_stats()`` counts ``memo`` and
  ``capture`` (on the CPU, ``eager``): a CUDA graph has no serialized form,
  and the kernels' one compiled artifact, the ``.so``, is cached by
  ``ops/cuda_build.py``, so there is no ``hit``.

On the CPU the same class runs the padded program eagerly, with no graph.
A capture or kernel failure raises: the deploy fails and the active version
keeps serving.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..columns import NumericColumn, PredictionColumn, VectorColumn
from ..local.scoring import BatchScoreFunction, _emit
from ..obs import trace
from ..workflow import stream
from .registry import bucket_for

__all__ = ["AotUnsupported", "BucketScorer", "head_program", "warm_stats",
           "reset_warm_stats"]


class AotUnsupported(RuntimeError):
    """The model's scoring DAG has no fusable sub-DAG worth a bucket graph."""


def head_program(t: Any) -> Optional[Any]:
    """The ``X -> (pred, raw | None, prob | None)`` closure of a prediction
    head stage (K-AF), or None when the stage is not a single-output
    predictor or its family has no device program (the tree families raise
    NotImplementedError)."""
    cls = getattr(t, "predictor_class", None)
    if cls is None or getattr(t, "n_outputs", 0) != 1:
        return None
    try:
        return cls.predict_program(t.model_params)
    except NotImplementedError:
        return None


_MEMO_MAX = 128
_MEMO_LOCK = threading.Lock()
#: bucket entries keyed (plan key, bucket, device, slot), each with the count
#: of scorers holding it
_MEMO: Dict[tuple, "_Bucket"] = {}
#: one stream plan per (model, result names); the value pins the model so its
#: id cannot be reused while the key lives
_PLAN_MEMO: "OrderedDict[tuple, tuple]" = OrderedDict()
_WARM_STATS = {"memo": 0, "capture": 0, "eager": 0}


def _note_warm(source: str) -> str:
    with _MEMO_LOCK:
        _WARM_STATS[source] += 1
    return source


def warm_stats() -> dict:
    """Copy of the cumulative {source: count} tally of bucket warms: ``memo``
    (an entry reused), ``capture`` (a graph captured on the card), ``eager``
    (the CPU's eager warm run)."""
    with _MEMO_LOCK:
        return dict(_WARM_STATS)


def reset_warm_stats() -> None:
    with _MEMO_LOCK:
        for k in _WARM_STATS:
            _WARM_STATS[k] = 0


def _plan_for(model: Any, ingest: BatchScoreFunction, result_names: Sequence[str]):
    key = (id(model), tuple(result_names))
    with _MEMO_LOCK:
        hit = _PLAN_MEMO.get(key)
        if hit is not None:
            _PLAN_MEMO.move_to_end(key)
            return key, hit[0]
    plan = stream.build_plan(ingest.records_to_dataset([{}]), model.dag,
                             live=set(result_names))
    with _MEMO_LOCK:
        hit = _PLAN_MEMO.setdefault(key, (plan, model))
        while len(_PLAN_MEMO) > _MEMO_MAX:
            _PLAN_MEMO.popitem(last=False)
    return key, hit[0]


def _flatten(outs: Dict[str, Any]) -> List[Tuple[tuple, torch.Tensor]]:
    """The program's outputs as ((name, part), tensor) pairs; a numeric
    terminal is its values and mask, an absent head output is left out."""
    flat = []
    for name, o in outs.items():
        if isinstance(o, tuple):
            flat += [((name, i), t) for i, t in enumerate(o) if t is not None]
        else:
            flat.append(((name, None), o))
    return flat


class _Bucket:
    """One bucket's warmed program: on the card its CUDA graph, static
    inputs, pinned staging and pinned outputs; on the CPU nothing but the
    mark that it ran.  ``lock`` serializes the scorers sharing it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.refs = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static: Dict[str, Any] = {}
        self.staging: Dict[str, Any] = {}
        self.outs: List[Tuple[tuple, torch.Tensor]] = []
        self.host: List[torch.Tensor] = []
        self.capture_s = 0.0


def _drop(held: List[tuple]) -> None:
    """Let go of the memo entries under ``held``: an entry no scorer holds
    leaves the memo, and its graph and pool go with it."""
    with _MEMO_LOCK:
        for key in held:
            ent = _MEMO.get(key)
            if ent is not None:
                ent.refs -= 1
                if ent.refs <= 0:
                    del _MEMO[key]
        held.clear()


def _map_args(args: Dict[str, Any], fn) -> Dict[str, Any]:
    return {k: ([fn(t) for t in v] if isinstance(v, list) else fn(v)) for k, v in args.items()}


def _leaves(args: Dict[str, Any]):
    """The tensors of an argument dict in its (plan-fixed) order."""
    for v in args.values():
        yield from (v if isinstance(v, list) else [v])


class BucketScorer:
    """records -> score dicts through per-bucket CUDA graphs on one replica.

    Drop-in for ``BatchScoreFunction`` (the same output contract element for
    element); ``warm()`` captures every bucket ahead of traffic.  ``slot``
    names the replica: one graph per (bucket, replica)."""

    def __init__(self, model: Any, buckets: Sequence[int], device: Any, slot: int = 0,
                 stream_: Optional[torch.cuda.Stream] = None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slot = int(slot)
        self.buckets = sorted(int(b) for b in buckets)
        self._ingest = BatchScoreFunction(model)
        self._result_names = [f.name for f in model.result_features]
        self._plan_key, plan = _plan_for(model, self._ingest, self._result_names)
        if plan is None:
            raise AotUnsupported("fewer than two stream-fusable stages in the scoring DAG")
        self._plan = plan
        self._program = stream.program_for(plan)
        vectors = {e.out_name for e in plan.stages if e.terminal and e.out_kind == "vector"}
        #: heads captured with the plan: uid -> (stage, program, input name)
        self._graph_heads: Dict[str, Tuple[Any, Any, str]] = {}
        for layer in plan.host_layers:
            for t in layer:
                prog = head_program(t) if t.inputs and t.inputs[-1].name in vectors else None
                if prog is not None:
                    self._graph_heads[t.uid] = (t, prog, t.inputs[-1].name)
        #: heads run eagerly after the graph: uid -> program, or False (none)
        self._eager_heads: Dict[str, Any] = {}
        self.stream = stream_ if stream_ is not None else (
            torch.cuda.Stream(self.device) if self.cuda else None)
        self._pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self._entries: Dict[int, _Bucket] = {}
        #: the memo keys this scorer holds, let go by ``release`` or, for a
        #: scorer dropped without one, when it is collected
        self._held: List[tuple] = []
        weakref.finalize(self, _drop, self._held)
        #: seconds each bucket's capture took
        self.capture_s: Dict[int, float] = {}
        self.replays = 0

    @property
    def graph_heads(self) -> List[str]:
        return [type(t).__name__ for t, _, _ in self._graph_heads.values()]

    # ---- capture / warm ----------------------------------------------------
    def _stream_ctx(self):
        return torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext()

    def _run(self, args: Dict[str, Any]) -> Dict[str, Any]:
        """The plan's program, then the captured heads on its terminals."""
        outs = self._program(args)
        for uid, (_, prog, name) in self._graph_heads.items():
            outs["head:" + uid] = prog(outs[name])
        return outs

    def _template(self, bucket: int) -> Dict[str, Any]:
        ds = self._ingest.records_to_dataset([{} for _ in range(bucket)])
        return stream.chunk_args(self._plan, ds, 0, bucket, bucket)[0]

    def _build(self, bucket: int) -> _Bucket:
        ent = _Bucket()
        args = self._template(bucket)
        if not self.cuda:
            self._run(args)
            return ent
        t0 = time.perf_counter()
        with torch.cuda.stream(self.stream):
            ent.static = _map_args(args, lambda t: t.to(self.device))
            self._run(ent.static)  # compiles, loads and settles before capture
        self.stream.synchronize()
        ent.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(ent.graph, pool=self._pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outs = self._run(ent.static)
        except Exception as e:
            notes = "; ".join(getattr(e, "__notes__", []))
            raise RuntimeError(f"bucket {bucket} of the scoring plan could not be captured "
                               f"in a CUDA graph on {self.device}"
                               f"{' (' + notes + ')' if notes else ''}: {e}") from e
        ent.outs = _flatten(outs)
        ent.staging = _map_args(args, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                            pin_memory=True))
        ent.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for _, t in ent.outs]
        ent.capture_s = time.perf_counter() - t0
        return ent

    def compile_bucket(self, bucket: int) -> str:
        """Ensure this scorer holds the bucket's entry; returns its source
        (``memo``, ``capture`` or, on the CPU, ``eager``)."""
        if bucket in self._entries:
            return _note_warm("memo")
        key = (self._plan_key, bucket, str(self.device), self.slot)
        with _MEMO_LOCK:
            ent = _MEMO.get(key)
            if ent is not None:
                ent.refs += 1
                self._held.append(key)
        if ent is not None:
            self._entries[bucket] = ent
            return _note_warm("memo")
        with trace.span("serve.aot.capture", bucket=bucket, device=str(self.device)):
            built = self._build(bucket)
        with _MEMO_LOCK:
            ent = _MEMO.setdefault(key, built)
            ent.refs += 1
            self._held.append(key)
        self._entries[bucket] = ent
        self.capture_s[bucket] = built.capture_s
        return _note_warm("capture" if self.cuda else "eager")

    def warm(self, score: bool = True) -> None:
        """Capture every bucket, largest first, then one end-to-end null
        score of the largest bucket (the host layers' heads and tables)."""
        for b in reversed(self.buckets):
            self.compile_bucket(b)
        if score:
            with trace.span("serve.aot.warm_score", bucket=self.buckets[-1],
                            device=str(self.device)):
                self([{} for _ in range(self.buckets[-1])])

    def graph_bytes(self) -> Dict[str, Optional[int]]:
        """The card memory the bucket graphs hold: the segments of this
        scorer's private pool (None where the allocator's snapshot does not
        name the pool) and the static inputs."""
        static = sum(t.nbytes for ent in self._entries.values() for t in _leaves(ent.static))
        pool = None
        if self.cuda:
            for seg in torch.cuda.memory_snapshot():
                pid = seg.get("segment_pool_id")
                if pid is not None and tuple(pid) == tuple(self._pool):
                    pool = (pool or 0) + int(seg["total_size"])
        return {"pool": pool, "static": static}

    def release(self) -> None:
        """Let go of this scorer's entries (after its replica's drain)."""
        _drop(self._held)
        self._entries = {}

    # ---- scoring -----------------------------------------------------------
    def _inputs(self, records: Sequence[Dict[str, Any]], bucket: int):
        """The records padded to ``bucket`` with null records: their
        dataset and the plan's argument dict."""
        ds = self._ingest.records_to_dataset(
            list(records) + [{} for _ in range(bucket - len(records))])
        return ds, stream.chunk_args(self._plan, ds, 0, bucket, bucket)[0]

    def device_outputs(self, records: Sequence[Dict[str, Any]], bucket: int,
                       eager: bool = False) -> Dict[tuple, np.ndarray]:
        """The bucket's terminals and captured heads for ``records`` as host
        arrays keyed (name, part): through the bucket's graph, or with
        ``eager`` the same program launched op by op on the replica's stream
        (what the graph is held to)."""
        return self._outputs(self._inputs(records, bucket)[1], bucket, eager)

    def _outputs(self, args: Dict[str, Any], bucket: int, eager: bool = False
                 ) -> Dict[tuple, np.ndarray]:
        ent = self._entries.get(bucket)
        if ent is None:
            self.compile_bucket(bucket)
            ent = self._entries[bucket]
        if not self.cuda or eager:
            with self._stream_ctx():
                outs = _flatten(self._run(_map_args(args, lambda t: t.to(self.device))))
                return {k: t.cpu().numpy() for k, t in outs}
        with ent.lock:
            with torch.cuda.stream(self.stream):
                for src, stage, static in zip(_leaves(args), _leaves(ent.staging),
                                              _leaves(ent.static)):
                    stage.copy_(src)
                    static.copy_(stage, non_blocking=True)
                ent.graph.replay()
                for host, (_, dev) in zip(ent.host, ent.outs):
                    host.copy_(dev, non_blocking=True)
            self.stream.synchronize()
            self.replays += 1
            return {k: h.numpy().copy() for (k, _), h in zip(ent.outs, ent.host)}

    def _eager_head(self, t: Any, ds: Any) -> Optional[PredictionColumn]:
        """A predictor head after the graph, through its ``predict_program``
        on this replica's device; None for the families without one."""
        prog = self._eager_heads.get(t.uid)
        if prog is None:
            prog = self._eager_heads[t.uid] = head_program(t) or False
        if prog is False:
            return None
        pred, raw, prob = prog(ds[t.inputs[-1].name].tensor(self.device))
        return PredictionColumn(T.Prediction, pred.cpu().numpy(),
                                None if raw is None else raw.cpu().numpy(),
                                None if prob is None else prob.cpu().numpy())

    def _score_bucket(self, records: List[Dict[str, Any]], bucket: int) -> List[Dict[str, Any]]:
        n = len(records)
        ds, args = self._inputs(records, bucket)
        got = self._outputs(args, bucket)
        new_cols: Dict[str, Any] = {}
        for e in self._plan.stages:
            if not e.terminal:
                continue
            if e.out_kind == "numeric":
                new_cols[e.out_name] = NumericColumn(e.ftype, got[(e.out_name, 0)],
                                                     got[(e.out_name, 1)])
            else:
                new_cols[e.out_name] = VectorColumn(
                    T.OPVector, torch.from_numpy(got[(e.out_name, None)]), e.metadata)
        ds = ds.with_columns(new_cols)
        with self._stream_ctx():
            for layer in self._plan.host_layers:
                host_new: Dict[str, Any] = {}
                for t in layer:
                    out_feats = t.get_outputs()
                    if t.uid in self._graph_heads:
                        h = "head:" + t.uid
                        col = PredictionColumn(T.Prediction, got[(h, 0)], got.get((h, 1)),
                                               got.get((h, 2)))
                    else:
                        col = self._eager_head(t, ds)
                        if col is None:
                            col = t.transform_dataset(ds)
                    summary = getattr(t, "summary", None)
                    if isinstance(col, PredictionColumn) and summary is not None:
                        col.metadata = {"model_selector_summary": summary.to_json()}
                    if t.n_outputs == 1:
                        host_new[out_feats[0].name] = col
                    else:
                        for f, c in zip(out_feats, col):
                            host_new[f.name] = c
                ds = ds.with_columns(host_new)
        out_cols = [(nm, ds[nm]) for nm in self._result_names if nm in ds.columns]
        return [{nm: _emit(col.to_scalar(i)) for nm, col in out_cols} for i in range(n)]

    def __call__(self, records: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        records = list(records)
        cap = self.buckets[-1]
        out: List[Dict[str, Any]] = []
        for lo in range(0, len(records), cap):
            part = records[lo:lo + cap]
            out.extend(self._score_bucket(part, bucket_for(len(part), self.buckets)))
        return out
