"""Dynamic micro-batcher: requests -> padded shape-bucket batches -> replicas.

The port's copy of ``transmogrifai_tpu/serve/batcher.py`` for the default
tenant.  Admission is bounded end to end: at most ``queue_size`` requests
may be outstanding (admitted, not yet resolved) anywhere in the batcher,
and overflow is shed at once with ``ShedError`` (HTTP 429), never a hang
and never a silent drop.  One collector thread gathers up to ``max_batch``
requests, or what arrives within ``max_wait_ms`` of the first, pads the
batch with null records to its power-of-two bucket, and routes it to the
replica slot with the least outstanding work (queued batches plus in-flight
scoring).  Each slot has one worker thread, so one replica never scores two
batches at once, while the slots score in parallel, each on its own stream.

Failures are classified.  A system fault (an injected transient fault, an
I/O or memory error, a kernel or CUDA error on the card) counts against the
slot's circuit breaker and the batch goes to the per-record row path
(``ScoreFunction``, on the replica's card).
Any other batch failure is taken for a data fault: the batch is bisected to
isolate the offending rows, which fail alone with a ``DataFault`` (HTTP
422), while their batchmates keep their scores.  With every circuit open,
batches are served on the row path (``degraded_batches``).

Rolling hot-swap handshake: a worker takes its slot's current replica,
enters the replica's in-flight guard, then checks that the slot still holds
that replica (a swap that won the race sends it back to fetch again).  Once
the guard holds, the registry's drain of that slot cannot complete before
the batch resolves, so after ``deploy`` returns no request is answered by
the old version.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..obs import registry as obs_registry
from ..obs import trace
from ..ops.cuda_build import KernelError
from ..resilience import inject as _inject
from ..resilience import quarantine as _quar
from ..resilience import retry as _retry
from ..resilience.quarantine import DataFault
from . import contract as _contract
from .metrics import ServeMetrics
from .registry import DEFAULT_TENANT, ModelRegistry, _check_tenant, bucket_for
from .supervisor import ReplicaSupervisor

_rscope = obs_registry.scope("resilience")

#: exception classes that mean the machine failed, not the data: the
#: reference's four, a kernel of the port that failed to build or launch,
#: and torch's device errors (out of memory; a CUDA error, which torch
#: raises as ``AcceleratorError`` where it has it); injected faults carry a
#: ``transient`` attribute and are system faults too
_SYSTEM_FAULTS = (ConnectionError, TimeoutError, OSError, MemoryError, KernelError,
                  torch.OutOfMemoryError) + tuple(
                      c for c in (getattr(torch, "AcceleratorError", None),) if c is not None)


def _is_system_fault(e: BaseException) -> bool:
    if isinstance(e, DataFault):
        return False
    if getattr(e, "transient", None) is not None:
        return True
    # torch before ``AcceleratorError`` raises a CUDA error (a failed launch
    # or graph replay) as a RuntimeError that says so
    return isinstance(e, _SYSTEM_FAULTS) or (
        isinstance(e, RuntimeError) and "CUDA error" in str(e))


def _poisoned(entry, record: Dict[str, Any], kind: str) -> Dict[str, Any]:
    """One chaos-poisoned copy of ``record``: garbage planted in a numeric
    field the model reads (the contract's first), so extraction cannot
    ignore it."""
    contract = getattr(entry, "contract", None)
    names = contract.numeric_field_names if contract is not None else []
    if names:
        name = names[0]
    elif record:
        name = next(iter(record))
    else:
        name = "__poison__"
    out = dict(record)
    out[name] = _inject.garbage_value(kind)
    return out


class ShedError(RuntimeError):
    """Admission queue full: the request is rejected (HTTP 429)."""

    status = 429


class Scored(NamedTuple):
    """What a request's future resolves to."""

    version: str
    output: Dict[str, Any]


class _Pending(NamedTuple):
    record: Dict[str, Any]
    future: Future
    enqueued_at: float


class MicroBatcher:
    """Bounded-queue micro-batcher over a ``ModelRegistry``'s replica slots."""

    def __init__(self, registry: ModelRegistry, max_batch: int = 64, max_wait_ms: float = 2.0,
                 queue_size: int = 1024, metrics: Optional[ServeMetrics] = None):
        if max_batch > registry.buckets[-1]:
            raise ValueError(f"max_batch {max_batch} exceeds the registry's "
                             f"largest bucket {registry.buckets[-1]}")
        self.registry = registry
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        # one shared sink: the explicit one, else the registry's, and the
        # registry wired to it so its swap counter lands in the same place
        self.metrics = metrics or registry.metrics or ServeMetrics()
        if registry.metrics is None:
            registry.metrics = self.metrics
        # the bound is on OUTSTANDING requests (admitted, future unresolved),
        # so work cannot pile up on the slot queues behind a bounded inlet
        self._capacity = int(queue_size)
        self._admit_lock = threading.Lock()
        self._outstanding = 0
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self.metrics.add_gauge("queue_depth", self._queue.qsize)
        self.metrics.add_gauge("outstanding", lambda: self._outstanding)
        self._slot_queues: List["queue.Queue"] = [queue.Queue()
                                                  for _ in range(registry.n_replicas)]
        self.supervisor = ReplicaSupervisor(registry, metrics=self.metrics)
        registry.supervisor = self.supervisor
        self._running = False
        self._collector: Optional[threading.Thread] = None
        self._workers: List[threading.Thread] = []

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._running:
            return self
        self._running = True
        self._collector = threading.Thread(target=self._loop, name="serve-collector",
                                           daemon=True)
        self._collector.start()
        self._workers = [threading.Thread(target=self._worker, args=(i,),
                                          name=f"serve-replica-{i}", daemon=True)
                         for i in range(len(self._slot_queues))]
        for w in self._workers:
            w.start()
        self.supervisor.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        self._running = False
        self.supervisor.stop()
        if self._collector is not None:
            self._collector.join(timeout_s)
            self._collector = None
        for q in self._slot_queues:
            q.put(None)  # wake each worker so it sees _running is False
        for w in self._workers:
            w.join(timeout_s)
        self._workers = []
        # fail whatever is still queued rather than leave callers hanging
        leftovers: List[_Pending] = []
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for q in self._slot_queues:
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    leftovers.extend(item)
        for pending in leftovers:
            pending.future.set_exception(RuntimeError("server shutting down"))

    # ---- admission ---------------------------------------------------------
    def submit(self, record: Dict[str, Any], tenant: str = DEFAULT_TENANT) -> "Future[Scored]":
        """Enqueue one record; sheds with ``ShedError`` when the bound is
        reached, raises :class:`DataFault` when the record breaks the active
        model's input contract (the per-record half of validation; the
        sweep over the assembled batch runs in ``_dispatch``)."""
        _check_tenant(tenant)
        self.metrics.inc("requests")
        contract = self._active_contract()
        if contract is not None:
            try:
                contract.check_record(record)
            except DataFault as fault:
                self._note_data_fault(record, fault)
                raise
        with self._admit_lock:
            if self._outstanding >= self._capacity:
                self.metrics.inc("shed")
                raise ShedError(f"admission queue full ({self._capacity} outstanding); "
                                "retry later")
            self._outstanding += 1
        future: "Future[Scored]" = Future()
        future.add_done_callback(lambda _f: self._release_admission())
        self._queue.put(_Pending(record, future, time.monotonic()))
        return future

    def _release_admission(self) -> None:
        with self._admit_lock:
            self._outstanding -= 1

    def _active_contract(self):
        """The active model's InputContract, or None (validation off, no
        model deployed, or none derived)."""
        if not _contract.validation_enabled():
            return None
        try:
            return getattr(self.registry.active(), "contract", None)
        except LookupError:
            return None

    def _note_data_fault(self, record, fault: DataFault) -> None:
        """Count and dead-letter one rejected record; the breaker, the
        supervisor and the error counter are left alone (a poison record is
        the client's fault, not the replica's)."""
        self.metrics.inc("data_faults")
        self.metrics.inc("quarantined")
        _rscope.inc("data_faults")
        _quar.store().put("serve", fault.reason, index=fault.index, field=fault.field,
                          record=record, detail=fault.detail)

    def score(self, record: Dict[str, Any], timeout_s: Optional[float] = 30.0) -> Dict[str, Any]:
        """Submit and wait: the blocking single-record call."""
        return self.submit(record).result(timeout_s).output

    # ---- collect + route ---------------------------------------------------
    def _loop(self) -> None:
        while self._running:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._slot_queues[self._pick_slot()].put(batch)

    def _pick_slot(self) -> int:
        """Least outstanding work (queued batches plus in-flight scoring)
        among the routable slots; with every circuit open the least loaded
        slot still wins, and dispatch serves its batch on the row path."""
        sup = self.supervisor
        n = len(self._slot_queues)
        all_down = not any(sup.routable(i) for i in range(n))
        best, best_load = 0, None
        for i in range(n):
            if not all_down and not sup.routable(i):
                continue
            load = self._slot_queues[i].qsize() + self.registry.slot_inflight(i)
            if best_load is None or load < best_load:
                best, best_load = i, load
        return best

    # ---- per-replica dispatch ----------------------------------------------
    def _worker(self, slot: int) -> None:
        q = self._slot_queues[slot]
        while True:
            batch = q.get()
            if batch is None:  # stop() sentinel
                break
            self._dispatch(slot, batch)

    def _acquire_replica(self, slot: int):
        """Enter the slot's replica's in-flight guard, swap-safely."""
        while True:
            rep = self.registry.replica(slot)
            if rep is None:
                return None, None
            ctx = rep.in_flight()
            ctx.__enter__()
            if self.registry.replica(slot) is rep:
                return rep, ctx
            ctx.__exit__(None, None, None)  # a rolling swap won the race

    def _dispatch(self, slot: int, batch: List[_Pending]) -> None:
        rep, ctx = self._acquire_replica(slot)
        if rep is None:
            try:
                self.registry.active()
                err: Exception = RuntimeError(f"replica slot {slot} is empty")
            except LookupError as e:
                err = e
            for p in batch:
                p.future.set_exception(err)
            self.metrics.inc("errors", len(batch))
            return
        entry = rep.owner
        sup = self.supervisor
        # data-plane pre-pass: chaos poison, then the batch validation
        if _inject.active():
            for idx, kind in _inject.poison_plan("serve.score", len(batch), key=slot):
                batch[idx] = batch[idx]._replace(
                    record=_poisoned(entry, batch[idx].record, kind))
        quarantined = 0
        contract = getattr(entry, "contract", None)
        if contract is not None and _contract.validation_enabled():
            pre = contract.check_batch([p.record for p in batch], len(batch))
            clean: List[_Pending] = []
            for p, fault in zip(batch, pre):
                if fault is None:
                    clean.append(p)
                else:
                    self._note_data_fault(p.record, fault)
                    p.future.set_exception(fault)
                    quarantined += 1
        else:
            clean = batch
        if not clean:
            ctx.__exit__(None, None, None)
            return
        n = len(clean)
        bucket = bucket_for(n, entry.buckets)
        records = [p.record for p in clean] + [{} for _ in range(bucket - n)]
        brk = sup.breaker(slot)
        t0 = time.monotonic()
        try:
            with trace.span("serve.batch", records=n, bucket=bucket, version=entry.version,
                            replica=rep.id):
                if not brk.available and not brk.try_trial():
                    # circuit open and no trial due: leave the replica alone
                    # and serve on the row path
                    self.metrics.inc("degraded_batches")
                    outputs = self._fallback(entry, clean)
                else:
                    try:
                        outputs = _retry.with_retry("serve.score", rep.score, records)[:n]
                        sup.note_success(slot)
                    except Exception as e:  # noqa: BLE001 — classified below
                        if _is_system_fault(e):
                            sup.note_failure(slot, e)
                            outputs = self._fallback(entry, clean)
                        else:
                            # a data-shaped failure: bisect to the rows at fault
                            outputs = self._bisect(rep, entry, clean)
                            if outputs is None:
                                # every row failed, or a system fault broke the
                                # bisection: the model or the machine is sick
                                sup.note_failure(slot, e)
                                outputs = self._fallback(entry, clean)
                            else:
                                sup.note_success(slot)
        finally:
            ctx.__exit__(None, None, None)
        self.metrics.observe_batch((time.monotonic() - t0) * 1000.0, n, bucket,
                                   replica=rep.slot, device=str(rep.device))
        done = time.monotonic()
        for p, out in zip(clean, outputs):
            if isinstance(out, DataFault):
                self._note_data_fault(p.record, out)
                p.future.set_exception(out)
            elif isinstance(out, Exception):
                self.metrics.inc("errors")
                p.future.set_exception(out)
            else:
                self.metrics.observe_request((done - p.enqueued_at) * 1000.0, replica=rep.slot)
                trace.complete("serve.request", p.enqueued_at, done, bucket=bucket)
                p.future.set_result(Scored(entry.version, out))

    def _bisect(self, rep, entry, items: List[_Pending]) -> Optional[List[Any]]:
        """Halve a failed batch recursively to isolate the rows at fault: a
        clean half keeps its scores, a failing single row becomes a
        :class:`DataFault`.  None when every row fails or a system fault
        interrupts (the machine or the model is at fault)."""
        outputs: List[Any] = [None] * len(items)

        def attempt(idxs: List[int]) -> List[Any]:
            recs = [items[i].record for i in idxs]
            b = bucket_for(len(idxs), entry.buckets)
            return rep.score(recs + [{} for _ in range(b - len(idxs))])[:len(idxs)]

        def go(idxs: List[int]) -> None:
            _rscope.inc("bisect_probes")
            try:
                outs = attempt(idxs)
            except Exception as e:  # noqa: BLE001 — classified here
                if _is_system_fault(e):
                    raise
                if len(idxs) == 1:
                    outputs[idxs[0]] = DataFault("score_failure", index=idxs[0],
                                                 detail=repr(e)[:160])
                    return
                mid = len(idxs) // 2
                go(idxs[:mid])
                go(idxs[mid:])
                return
            for i, o in zip(idxs, outs):
                outputs[i] = o

        try:
            go(list(range(len(items))))
        except Exception:  # noqa: BLE001 — a system fault mid-bisection
            return None
        if all(isinstance(o, DataFault) for o in outputs):
            return None
        return outputs

    def _fallback(self, entry, batch: List[_Pending]) -> List[Any]:
        """The batch path failed or its circuit is open: the row path, one
        record at a time on the model's card."""
        self.metrics.inc("fallback_batches")
        outputs: List[Any] = []
        for p in batch:
            try:
                outputs.append(entry.row(p.record))
                self.metrics.inc("fallback_records")
            except Exception as e:  # noqa: BLE001 — the poisonous record fails alone
                outputs.append(e)
        return outputs
