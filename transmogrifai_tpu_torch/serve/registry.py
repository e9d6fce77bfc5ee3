"""Versioned model registry: replica slots with rolling hot swap.

The port's copy of ``transmogrifai_tpu/serve/registry.py`` for the default
tenant.  Deploy discipline: **load -> warm -> swap -> drain**, per replica:

1. *load*: the candidate ``OpWorkflowModel`` becomes a ``ServingModel``
   holding N :class:`Replica` s (N from ``TMOG_SERVE_REPLICAS`` through
   ``parallel/mesh.serve_devices``, default one per card), each with its own
   ``torch.cuda.Stream`` and its per-bucket CUDA graphs
   (``serve/aot.BucketScorer``);
2. *warm*: every replica captures every shape bucket before the model takes
   traffic, so no request pays a first launch's compile or a capture;
3. *swap*: the slots are swapped one at a time, each a single reference
   assignment under the registry lock, so the other slots keep serving;
4. *drain*: after each slot swap the deploy blocks until the outgoing
   replica's in-flight batches complete, then releases its graphs and
   pool; when ``deploy`` returns, no stale-version response can be produced
   for a later submission.

A failed warm-up (a capture or kernel failure included) aborts the deploy
and leaves every active replica untouched.  Every replica of a model sits
on the model's device: a replica on another card raises
``NotImplementedError`` (multi-GPU, ROADMAP Queue 1 item 7).  Named tenants,
their LRU activation tier and ``serve/placement.py`` are not ported: the
tenant APIs raise ``NotImplementedError`` (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..local.scoring import BatchScoreFunction, ScoreFunction
from ..obs import registry as obs_registry
from ..obs import trace
from ..resilience import inject as _inject
from .metrics import ServeMetrics

DEFAULT_MAX_BATCH = 64

#: the single-model API's tenant name, the only one the port serves
DEFAULT_TENANT = "default"

_TENANTS = ("named tenants, their LRU activation tier and placement are not ported: "
            "ROADMAP Queue 1 item 3 (placement prices tenants with the cost model, item 8)")


def shape_buckets(max_batch: int) -> List[int]:
    """Power-of-two padding targets up to (and including) ``max_batch``."""
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return buckets


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (callers never exceed the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _device(d) -> torch.device:
    """``d`` as a device with its index (``cuda`` is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _check_tenant(tenant: str) -> None:
    if tenant != DEFAULT_TENANT:
        raise NotImplementedError(f"tenant {tenant!r}: {_TENANTS}")


class Replica:
    """One per-slot copy of a deployed version: its stream, its bucket graphs
    (when the DAG has a fusable sub-DAG), its in-flight count."""

    def __init__(self, owner: "ServingModel", slot: int, device: torch.device):
        self.owner = owner
        self.slot = slot
        self.device = device
        self.scorer = None
        self.warmed = False
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._cond = threading.Condition()
        self._inflight = 0
        from .aot import AotUnsupported, BucketScorer

        try:
            self.scorer = BucketScorer(owner.model, owner.buckets, device, slot, self.stream)
        except AotUnsupported as e:
            obs_registry.record_fallback("serve", "aot_unsupported", version=owner.version,
                                         slot=slot, error=str(e))

    @property
    def id(self) -> str:
        return f"{self.owner.version}/{self.slot}"

    def _stream_ctx(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    def score(self, records):
        """Bucket-padded records -> outputs, on this replica's card and
        stream.  The bucket graphs serve while the owner's ``batch`` callable
        is the pristine default; a replaced ``entry.batch`` (tests,
        instrumentation) takes every call."""
        _inject.maybe_fail("serve.score", key=self.slot)
        owner = self.owner
        if self.scorer is not None and owner.batch is owner._default_batch:
            return self.scorer(records)
        with self._stream_ctx():
            return owner.batch(records)

    def warm(self) -> None:
        """Capture every bucket (or, without a plan, score every bucket on
        the generic path once) on this replica's card."""
        _inject.maybe_fail("serve.warm", key=self.slot)
        if self.scorer is not None:
            self.scorer.warm()
        else:
            with self._stream_ctx():
                for b in self.owner.buckets:
                    self.owner.batch([{} for _ in range(b)])
        self.warmed = True

    def release(self) -> None:
        """Let go of the bucket graphs (after the drain)."""
        if self.scorer is not None:
            self.scorer.release()

    @contextlib.contextmanager
    def in_flight(self):
        with self._cond:
            self._inflight += 1
        try:
            yield self
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def drain(self, timeout_s: Optional[float] = 30.0) -> bool:
        """Block until no batch is scoring on this replica; True if drained."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cond:
            while self._inflight > 0:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True


class ServingModel:
    """One deployed model version: N replicas and the generic scorer
    (``batch``) that a replica without a plan serves through."""

    def __init__(self, version: str, model, buckets: Sequence[int],
                 devices: Optional[Sequence] = None):
        self.version = version
        self.model = model
        self.batch = BatchScoreFunction(model)
        self._default_batch = self.batch
        self.row = ScoreFunction(model)
        # the per-version input contract, derived once at deploy time; a
        # model it cannot be derived from still serves (nothing to enforce)
        try:
            from .contract import InputContract

            self.contract = InputContract.from_model(model)
        except Exception as e:  # noqa: BLE001 — serving beats validating
            self.contract = None
            obs_registry.record_fallback("serve", "contract_derivation_failed",
                                         version=version, error=repr(e))
        self.buckets = list(buckets)
        if devices is None:
            from ..parallel.mesh import serve_devices

            devices = serve_devices()
        self.devices = [_device(d) for d in devices]
        for d in self.devices:
            if d != model.device:
                raise NotImplementedError(
                    f"a replica on {d} for a model on {model.device}: every replica sits on "
                    "the model's device until multi-GPU serving (ROADMAP Queue 1 item 7)")
        self.replicas = [Replica(self, i, d) for i, d in enumerate(self.devices)]
        self.deployed_at_ms: Optional[int] = None
        self.warmed = False

    def warmup(self) -> None:
        """Warm every replica, one after another: the replicas of a card
        capture into its one allocator."""
        with trace.span("serve.warmup", version=self.version, buckets=len(self.buckets),
                        replicas=len(self.replicas)):
            try:
                for r in self.replicas:
                    r.warm()
            except BaseException:
                self.release()
                raise
        self.warmed = True

    def release(self) -> None:
        for r in self.replicas:
            r.release()

    @property
    def inflight(self) -> int:
        return sum(r.inflight for r in self.replicas)

    def drain(self, timeout_s: Optional[float] = 30.0) -> bool:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        for r in self.replicas:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            if not r.drain(remaining):
                return False
        return True


class ModelRegistry:
    """Versioned models behind N fixed replica slots (rolling hot swap)."""

    def __init__(self, max_batch: int = DEFAULT_MAX_BATCH,
                 metrics: Optional[ServeMetrics] = None, replicas: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        self.buckets = shape_buckets(max_batch)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._active: Optional[ServingModel] = None
        self._history: List[str] = []
        if devices is None:
            from ..parallel.mesh import serve_devices

            devices = serve_devices(replicas)
        self.devices = [_device(d) for d in devices]
        self._slots: List[Optional[Replica]] = [None] * len(self.devices)
        #: the ReplicaSupervisor watching these slots, wired by the batcher
        self.supervisor = None

    @property
    def n_replicas(self) -> int:
        return len(self._slots)

    def replica(self, slot: int) -> Optional[Replica]:
        """Current occupant of one slot (None before the first deploy)."""
        with self._lock:
            return self._slots[slot]

    def slots(self) -> List[Optional[Replica]]:
        with self._lock:
            return list(self._slots)

    def slot_inflight(self, slot: int) -> int:
        """Outstanding scoring on one slot: the batcher's routing signal."""
        rep = self.replica(slot)
        return 0 if rep is None else rep.inflight

    def deploy(self, model, version: Optional[str] = None, warm: bool = True,
               drain_timeout_s: Optional[float] = 30.0,
               tenant: str = DEFAULT_TENANT) -> ServingModel:
        """load -> warm -> rolling per-slot swap and drain; returns the active
        version.  Every slot keeps its replica until its warmed replacement
        is installed; each outgoing replica releases its graphs once
        drained."""
        _check_tenant(tenant)
        with self._lock:
            version = version or f"v{len(self._history) + 1}"
            if version in self._history:
                raise ValueError(f"Version {version!r} already deployed")
        entry = ServingModel(version, model, self.buckets, devices=self.devices)
        if warm:
            entry.warmup()  # raises -> deploy aborted, active slots untouched
        with trace.span("serve.swap", version=version, replicas=len(entry.replicas)):
            with self._lock:
                first = self._active is None
                if first:
                    self._slots = list(entry.replicas)
                old, self._active = self._active, entry
                entry.deployed_at_ms = int(time.time() * 1000)
                self._history.append(version)
            if self.metrics is not None:
                self.metrics.inc("swaps")
            if not first:
                for i, rep in enumerate(entry.replicas):
                    with self._lock:
                        old_rep, self._slots[i] = self._slots[i], rep
                    if old_rep is not None:
                        with trace.span("serve.drain", replica=old_rep.id):
                            if old_rep.drain(drain_timeout_s):
                                old_rep.release()
        if old is not None:
            old.drain(drain_timeout_s)
        return entry

    # ---- the tenant API of the JAX package (not ported) ---------------------
    def ensure_active(self, tenant: str = DEFAULT_TENANT) -> ServingModel:
        _check_tenant(tenant)
        return self.active()

    def evict_tenant(self, name: str, drain_timeout_s: Optional[float] = 30.0) -> bool:
        raise NotImplementedError(f"evict_tenant({name!r}): {_TENANTS}")

    def rebuild_slot(self, slot: int) -> Optional[Replica]:
        """Self-healing: replace one slot's replica with a freshly built and
        warmed copy of the active version (same model, same card; its bucket
        graphs come from the memo).  Returns the installed replica, or None
        when nothing is deployed; a failed warm raises and leaves the slot
        as it was.  The dead occupant is not drained (its batches already
        failed); it lets go of its graphs when nothing is in flight."""
        with self._lock:
            entry = self._active
        if entry is None:
            return None
        with trace.span("serve.rebuild", slot=slot, version=entry.version):
            rep = Replica(entry, slot, self.devices[slot])
            rep.warm()
        with self._lock:
            if self._active is not entry:
                rep.release()  # a deploy raced the rebuild: its fresh slots win
                return self._slots[slot]
            old, self._slots[slot] = self._slots[slot], rep
            entry.replicas[slot] = rep
        if old is not None and old is not rep and old.inflight == 0:
            old.release()
        if self.metrics is not None:
            self.metrics.inc("replica_rebuilds")
        return rep

    def active(self) -> ServingModel:
        with self._lock:
            if self._active is None:
                raise LookupError("No model deployed; call registry.deploy first")
            return self._active

    def active_version(self) -> Optional[str]:
        with self._lock:
            return None if self._active is None else self._active.version

    def versions(self) -> List[str]:
        with self._lock:
            return list(self._history)

    def info(self) -> Dict[str, object]:
        with self._lock:
            slots = list(self._slots)
            active = self._active
        sup = self.supervisor
        return {
            "active": None if active is None else active.version,
            "warmed": bool(active and active.warmed),
            "deployed_at_ms": None if active is None else active.deployed_at_ms,
            "versions": list(self._history),
            "buckets": list(self.buckets),
            "contract": (None if active is None or active.contract is None
                         else {"fields": len(active.contract.fields)}),
            "replicas": len(slots),
            "replica_info": [
                None if r is None else {
                    "id": r.id, "slot": r.slot, "device": str(r.device),
                    "aot": r.scorer is not None, "inflight": r.inflight}
                for r in slots],
            "health": None if sup is None else sup.health(),
            "slo": None if sup is None or sup.slo is None else sup.slo.status(),
        }
