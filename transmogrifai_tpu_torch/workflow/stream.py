"""The streaming executor: a run of DAG layers in fixed-size row chunks.

The port's counterpart of ``transmogrifai_tpu/workflow/stream.py``.  Past
``workflow/dag.STREAM_ROWS`` rows the layer-by-layer transform would hold
every layer's full-width output on the device and copy it back to the host
between layers; here ``build_plan`` takes the fusable transform sub-DAG of a
run of layers (every stage with a ``torch_transform``, up to the first
stage that cannot fuse on each chain) and ``execute`` runs it chunk by
chunk (``CHUNK_ROWS`` rows): a stage's output consumed only by later stages
of the plan stays on the device for the chunk, and only *terminals* (read
by a host stage or live after the run) leave it.

A chunk is sliced and cast on the host, uploaded, run through the stages
and its terminals copied back (``non_blocking`` into preallocated pinned
outputs on a CUDA run), all on the caller's current stream, so device
inputs the caller is still writing are ordered before the run by the
stream itself.  The blocking upload of chunk k+1 waits for chunk k, so one
chunk's device work overlaps the next chunk's host slicing, no more.  A
prefetch thread with pinned staging and separate copy and compute streams
measured slower than this loop on the H100 (the host slicing is the
critical path; PERF.md), so the executor has none.  Eager launches take the
short tail chunk as it is, so there is no zero padding.  The vector
terminals a caller names (``handoff``: a training flush names every output
it produces, for the sanity checker and the selector's sweep read them
next) stay on the device, each as one tensor, while together they fit
``HANDOFF_BYTES``: no round trip through the host.  On the CPU the same
loop runs the plain versions.

The device memory a streamed run holds is one chunk's inputs,
intermediates and outputs plus the handoff matrices (at most
``HANDOFF_BYTES``), not the layers' full width.  The JAX package's poison,
quarantine and checkpoint hooks and its multi-device route (per-head
program, sharded scoring) are not ported.

The serving plane (``serve/aot.py``) takes the same plan's per-chunk program
(``program_for``) over arguments zero-padded to a shape bucket
(``chunk_args``) and captures it as one CUDA graph a bucket.

Chunk-safe ``torch_transform`` contract (as the JAX package's): a stage maps
input row i to output row i with no data-dependent shapes; its
``torch_host_prep`` works on row slices; its ``torch_out_metadata`` is
computed once per plan; the constants it reads are device tensors cached on
the stage (``impl/feature/_util.stage_constant``), never a copy from the host
a call.  A stage that cannot honour it sets ``torch_chunkable = False``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import types as T
from ..columns import Dataset, NumericColumn, ObjectColumn, VectorColumn
from ..impl.feature._util import stage_device

#: rows of a chunk (the JAX package's ``TMOG_TRANSFORM_CHUNK_ROWS`` default)
CHUNK_ROWS = 262_144
#: the most bytes of handoff matrices a streamed run keeps on the device
#: (``TMOG_STREAM_HANDOFF_BYTES``)
HANDOFF_BYTES = 2 << 30

_STATS_KEYS = ("streams", "chunks", "rows", "bytes_in", "bytes_out", "wall_s", "prep_s",
               "transfer_wait_s", "stages_fused", "stages_host", "layers", "terminals",
               "device_only", "handoffs", "handoff_bytes", "declined")
_stats: Dict[str, float] = {k: 0 for k in _STATS_KEYS}
_stats_lock = threading.Lock()


def reset_stream_stats() -> None:
    with _stats_lock:
        for k in _STATS_KEYS:
            _stats[k] = 0


def _inc(key: str, v: float = 1) -> None:
    with _stats_lock:
        _stats[key] += v


def stream_stats() -> Dict[str, Any]:
    """Counters since the last reset: streamed runs, chunks, rows, bytes up
    and back, wall seconds, the host's slicing seconds, the wait for the
    last copies back, stages streamed and left to the host, handoffs, and
    runs the planner declined."""
    with _stats_lock:
        out: Dict[str, Any] = dict(_stats)
    wall = out["wall_s"]
    out["transform_rows_per_sec"] = out["rows"] / wall if wall > 0 else 0.0
    return out


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------
class _ProxyCol:
    """Plan-time stand-in for a device-resident intermediate: carries only
    what ``torch_out_metadata`` implementations read (.metadata/.width/.ftype)."""

    def __init__(self, ftype, metadata=None, width=None):
        self.ftype = ftype
        self.metadata = metadata
        self.width = width


@dataclass
class _StreamStage:
    stage: Any
    prep: bool                                  # per-chunk torch_host_prep
    arg_specs: Tuple[Tuple[str, str], ...]      # (kind, column name)
    out_name: str
    out_kind: str                               # "numeric" | "vector"
    ftype: Any
    metadata: Any                               # VectorMetadata (vector outputs)
    terminal: bool = True


@dataclass
class StreamPlan:
    stages: List[_StreamStage]
    host_layers: List[List[Any]]                # per input layer, the unfused rest
    base_numeric: List[str]
    base_vector: List[str]
    handoff: Set[str] = field(default_factory=set)

    @property
    def n_stream(self) -> int:
        return len(self.stages)


def _try_plan_stage(t, ds: Dataset, internal: Dict[str, str],
                    proxies: Dict[str, Any]) -> Optional[_StreamStage]:
    """One stage's slot in the streamed program, or None (a host stage).

    Fusable: a ``torch_transform``, one output, and every input a base
    numeric or vector column of ``ds`` or the output of an earlier fused
    stage.  A ``torch_host_prep`` stage fuses only when all its inputs are
    base columns (host prep needs host data)."""
    if not (hasattr(t, "torch_transform") and getattr(t, "n_outputs", 0) == 1):
        return None
    if not getattr(t, "torch_chunkable", True):
        return None
    names = [f.name for f in t.inputs]
    if hasattr(t, "torch_host_prep"):
        if any(nm in internal for nm in names):
            return None
        cols = [ds.columns.get(nm) for nm in names]
        if any(c is None for c in cols):
            return None
        ready = getattr(t, "torch_host_ready", None)
        if ready is not None and not ready(cols):
            return None
        prep, specs, in_cols = True, [], cols
    else:
        prep, specs, in_cols = False, [], []
        for nm in names:
            if nm in internal:
                if internal[nm] == "numeric":
                    specs += [("inv", nm), ("inm", nm)]
                else:
                    specs.append(("iv", nm))
                in_cols.append(proxies[nm])
            else:
                c = ds.columns.get(nm)
                if isinstance(c, NumericColumn):
                    specs += [("nv", nm), ("nm", nm)]
                elif isinstance(c, VectorColumn):
                    specs.append(("bv", nm))
                else:
                    return None
                in_cols.append(c)
    out_feat = t.get_outputs()[0]
    kind = "numeric" if getattr(t, "torch_output", "vector") == "numeric" else "vector"
    vm = None
    if kind == "vector":
        try:
            vm = t.torch_out_metadata(in_cols)   # once a plan, not a chunk
        except Exception:
            return None  # a proxy lacks what this stage needs: the host path
    return _StreamStage(stage=t, prep=prep, arg_specs=tuple(specs), out_name=out_feat.name,
                        out_kind=kind, ftype=out_feat.ftype, metadata=vm)


def build_plan(ds: Dataset, layers: Sequence[Sequence[Any]], live: Optional[Set[str]] = None,
               handoff: Optional[Set[str]] = None) -> Optional[StreamPlan]:
    """Plan a run of DAG layers as one streamed program.

    ``live``: the column names needed after these layers (None keeps every
    output); a fused output read only inside the plan and not live never
    leaves the device.  ``handoff``: names whose matrices stay on the
    device for the stages that read them next.  Returns None when fewer than two stages fuse (no
    cross-stage win: the caller takes the layer path)."""
    internal: Dict[str, str] = {}
    proxies: Dict[str, Any] = {}
    stages: List[_StreamStage] = []
    host_layers: List[List[Any]] = []
    base_numeric: List[str] = []
    base_vector: List[str] = []
    seen: Set[str] = set()
    for layer in layers:
        host_this: List[Any] = []
        for t in layer:
            entry = _try_plan_stage(t, ds, internal, proxies)
            if entry is None:
                host_this.append(t)
                continue
            stages.append(entry)
            internal[entry.out_name] = entry.out_kind
            if entry.out_kind == "numeric":
                proxies[entry.out_name] = _ProxyCol(entry.ftype)
            else:
                vm = entry.metadata
                proxies[entry.out_name] = _ProxyCol(
                    T.OPVector, metadata=vm, width=len(vm.columns) if vm is not None else None)
            for kind, nm in entry.arg_specs:
                if kind in ("nv", "nm") and nm not in seen:
                    seen.add(nm)
                    base_numeric.append(nm)
                elif kind == "bv" and nm not in seen:
                    seen.add(nm)
                    base_vector.append(nm)
        host_layers.append(host_this)
    if len(stages) < 2:
        return None
    host_inputs = {f.name for lay in host_layers for t in lay for f in t.inputs}
    for e in stages:
        e.terminal = e.out_name in host_inputs or live is None or e.out_name in live
    hand = set(handoff or ()) & {e.out_name for e in stages if e.terminal}
    return StreamPlan(stages=stages, host_layers=host_layers, base_numeric=base_numeric,
                      base_vector=base_vector, handoff=hand)


# ---------------------------------------------------------------------------
# The per-chunk program and its arguments
# ---------------------------------------------------------------------------
def program_for(plan: StreamPlan):
    """The per-chunk program: every stage's ``torch_transform`` in plan
    order, intermediates kept in a dict of device tensors, the terminals
    returned (name -> tensor, or (values, mask) for numeric outputs).  Its
    argument is the dict :func:`chunk_args` builds; the serving plane
    (``serve/aot.py``) captures it per shape bucket."""
    stages = list(plan.stages)

    def program(args: Dict[str, Any]) -> Dict[str, Any]:
        env: Dict[str, Any] = {}
        outs: Dict[str, Any] = {}
        for si, e in enumerate(stages):
            if e.prep:
                call = list(args[f"p{si}"])
            else:
                call = []
                for kind, nm in e.arg_specs:
                    if kind == "iv":
                        call.append(env[nm])
                    elif kind == "inv":
                        call.append(env[nm][0])
                    elif kind == "inm":
                        call.append(env[nm][1])
                    else:
                        call.append(args[f"{kind}:{nm}"])
            try:
                res = e.stage.torch_transform(*call)
            except Exception as err:  # name the stage (a bucket capture's error)
                err.add_note(f"in stage {type(e.stage).__name__} ({e.stage.uid})")
                raise
            env[e.out_name] = res
            if e.terminal:
                outs[e.out_name] = res
        return outs

    return program


def _slice_col(col, lo: int, hi: int):
    if isinstance(col, NumericColumn):
        return NumericColumn(col.ftype, col.values[lo:hi], col.mask[lo:hi])
    if isinstance(col, VectorColumn):
        return VectorColumn(col.ftype, col.values[lo:hi], col.metadata)
    if isinstance(col, ObjectColumn):
        return ObjectColumn(col.ftype, col.values[lo:hi])
    raise TypeError(f"cannot slice column {type(col).__name__} for streaming")


def _host_tensor(a: Any) -> Any:
    """A host array (or CPU tensor) as a contiguous CPU tensor; a device
    tensor passes through."""
    if isinstance(a, torch.Tensor):
        return a if a.device.type != "cpu" else a.contiguous()
    return torch.from_numpy(np.ascontiguousarray(a))


def _host_chunk_args(plan: StreamPlan, ds: Dataset, lo: int, hi: int
                     ) -> Tuple[Dict[str, Any], float]:
    """Rows [lo, hi) of the plan's inputs as CPU tensors, and the bytes they
    hold; a base vector already on the device passes as a view of its
    rows."""
    rows = hi - lo
    args: Dict[str, Any] = {}
    nbytes = 0.0
    for nm in plan.base_numeric:
        col = ds[nm]
        v = _host_tensor(np.asarray(col.values[lo:hi], np.float32))
        m = _host_tensor(np.asarray(col.mask[lo:hi], bool))
        args[f"nv:{nm}"], args[f"nm:{nm}"] = v, m
        nbytes += v.nbytes + m.nbytes
    for nm in plan.base_vector:
        v = _host_tensor(ds[nm].values[lo:hi])
        args[f"bv:{nm}"] = v
        nbytes += v.nbytes if v.device.type == "cpu" else 0
    for si, e in enumerate(plan.stages):
        if not e.prep:
            continue
        cols = [_slice_col(ds[f.name], lo, hi) for f in e.stage.inputs]
        preps = []
        for a in e.stage.torch_host_prep(cols):
            t = _host_tensor(a)
            if rows not in t.shape:
                raise ValueError(f"torch_host_prep of {e.stage} is not row-aligned "
                                 f"({tuple(t.shape)} for {rows} rows): not chunk-safe")
            preps.append(t)
            nbytes += t.nbytes if t.device.type == "cpu" else 0
        args[f"p{si}"] = preps
    return args, nbytes


def _pad0(t: torch.Tensor, pad: int, axis: int = 0) -> torch.Tensor:
    """Zero-pad ``t`` by ``pad`` rows along ``axis`` (a bool tensor pads
    False).  Padded rows are sliced off every output, so their values only
    need to be finite."""
    if not pad:
        return t
    shape = list(t.shape)
    shape[axis] = pad
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)], dim=axis)


def chunk_args(plan: StreamPlan, ds: Dataset, lo: int, hi: int, C: int
               ) -> Tuple[Dict[str, Any], float]:
    """Rows [lo, hi) of the plan's inputs zero-padded to ``C`` rows, as
    :func:`program_for`'s argument dict (the numeric masks pad False, a
    host prep's arrays along its ``torch_prep_row_axis``, 0 by default),
    and the bytes they hold: the serving plane's constant bucket shapes."""
    args, _ = _host_chunk_args(plan, ds, lo, hi)
    pad = C - (hi - lo)
    if pad < 0:
        raise ValueError(f"{hi - lo} rows do not fit a chunk of {C}")
    axis = {f"p{si}": getattr(e.stage, "torch_prep_row_axis", 0)
            for si, e in enumerate(plan.stages) if e.prep}
    out: Dict[str, Any] = {}
    for k, v in args.items():
        if isinstance(v, list):
            out[k] = [_pad0(t, pad, axis[k]) for t in v]
        else:
            out[k] = _pad0(v, pad)
    nbytes = sum(t.nbytes for v in out.values() for t in (v if isinstance(v, list) else [v])
                 if t.device.type == "cpu")
    return out, float(nbytes)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------
class _Outputs:
    """The terminals' preallocated outputs (pinned host memory on a CUDA
    run; the handoff matrices on the device) and the chunk copies into them."""

    def __init__(self, plan: StreamPlan, n: int, device: torch.device):
        self.plan, self.n, self.device = plan, n, device
        self.cuda = device.type == "cuda"
        self.vals: Dict[str, torch.Tensor] = {}
        self.masks: Dict[str, torch.Tensor] = {}
        self.on_device: Set[str] = set()
        self.device_bytes = 0

    def _alloc(self, name: str, shape, dtype, keep_on_device: bool) -> torch.Tensor:
        if keep_on_device:
            self.on_device.add(name)
            return torch.empty(shape, dtype=dtype, device=self.device)
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def put(self, name: str, kind: str, res: Any, lo: int, hi: int) -> int:
        """Copy one chunk's terminal into place; returns the bytes copied."""
        if kind == "numeric":
            v, m = res
            if name not in self.vals:
                self.vals[name] = self._alloc(name, (self.n,), torch.float32, False)
                self.masks[name] = self._alloc(name, (self.n,), torch.bool, False)
            self.vals[name][lo:hi].copy_(v.to(torch.float32), non_blocking=True)
            self.masks[name][lo:hi].copy_(m, non_blocking=True)
            return (hi - lo) * 5
        if name not in self.vals:
            width = int(res.shape[1])
            nbytes = self.n * width * 4
            keep = (self.cuda and name in self.plan.handoff
                    and self.device_bytes + nbytes <= HANDOFF_BYTES)
            self.device_bytes += nbytes if keep else 0
            self.vals[name] = self._alloc(name, (self.n, width), torch.float32, keep)
        self.vals[name][lo:hi].copy_(res, non_blocking=True)
        return 0 if name in self.on_device else (hi - lo) * int(res.shape[1]) * 4

    def columns(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for e in self.plan.stages:
            if not e.terminal:
                continue
            if e.out_kind == "numeric":
                out[e.out_name] = NumericColumn(e.ftype, self.vals[e.out_name].numpy(),
                                                self.masks[e.out_name].numpy())
            else:
                out[e.out_name] = VectorColumn(T.OPVector, self.vals[e.out_name], e.metadata)
        return out


def execute(plan: StreamPlan, ds: Dataset) -> Dict[str, Any]:
    """Stream ``ds`` through the plan, ``CHUNK_ROWS`` rows at a time, on the
    stages' device and the caller's current stream.  Returns the terminal
    columns (name -> Column)."""
    device = stage_device(plan.stages[0].stage)
    n = len(ds)
    C = max(1, int(CHUNK_ROWS))
    program = program_for(plan)
    outputs = _Outputs(plan, n, device)
    t_wall = time.perf_counter()
    bytes_in = bytes_out = 0.0
    for lo in range(0, n, C):
        hi = min(lo + C, n)
        t0 = time.perf_counter()
        args, nb = _host_chunk_args(plan, ds, lo, hi)
        _inc("prep_s", time.perf_counter() - t0)
        bytes_in += nb
        outs = program({k: ([t.to(device) for t in v] if isinstance(v, list) else v.to(device))
                        for k, v in args.items()})
        for e in plan.stages:
            if e.terminal:
                bytes_out += outputs.put(e.out_name, e.out_kind, outs[e.out_name], lo, hi)
        del args, outs   # the chunk's device memory goes back before the next
    if outputs.cuda:   # the last copies back land before the host reads them
        t0 = time.perf_counter()
        torch.cuda.current_stream(device).synchronize()
        _inc("transfer_wait_s", time.perf_counter() - t0)
    _inc("streams")
    _inc("chunks", -(-n // C))
    _inc("rows", n)
    _inc("bytes_in", bytes_in)
    _inc("bytes_out", bytes_out)
    terminals = sum(e.terminal for e in plan.stages)
    _inc("terminals", terminals)
    _inc("device_only", len(plan.stages) - terminals)
    hand = [nm for nm in plan.handoff if nm in outputs.on_device]
    _inc("handoffs", len(hand))
    _inc("handoff_bytes", float(sum(outputs.vals[nm].nbytes for nm in hand)))
    _inc("wall_s", time.perf_counter() - t_wall)
    return outputs.columns()


def apply_streamed(ds: Dataset, layers: Sequence[Sequence[Any]],
                   live: Optional[Set[str]] = None,
                   handoff: Optional[Set[str]] = None) -> Optional[Dataset]:
    """Apply a run of transformer layers through the streaming executor.

    Returns the transformed Dataset, or None when the planner declines
    (empty data, or fewer than two fusable stages): the caller takes the
    layer path.  The unfused stages run after the stream in their original
    layer order; the streamed outputs they read are terminals, materialized
    by then."""
    n = len(ds)
    if n == 0:
        return None
    plan = build_plan(ds, layers, live=live, handoff=handoff)
    if plan is None:
        _inc("declined")
        return None
    _inc("stages_fused", plan.n_stream)
    _inc("stages_host", sum(len(lay) for lay in plan.host_layers))
    _inc("layers", len(layers))
    ds = ds.with_columns(execute(plan, ds))
    for layer in plan.host_layers:
        if not layer:
            continue
        new: Dict[str, Any] = {}
        for t in layer:
            col = t.transform_dataset(ds)
            out_feats = t.get_outputs()
            if t.n_outputs == 1:
                new[out_feats[0].name] = col
            else:
                for f, c in zip(out_feats, col):
                    new[f.name] = c
        ds = ds.with_columns(new)
    return ds
