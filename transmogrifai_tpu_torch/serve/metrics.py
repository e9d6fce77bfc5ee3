"""Serving metrics: latency histograms, counters and gauges.

The port's copy of ``transmogrifai_tpu/serve/metrics.py`` for the default
tenant.  Exported as the JSON payload of the server's ``GET /metrics`` and,
merged across live instances, as ``obs.snapshot()["serve"]`` (the provider
registered below), which ``GET /metrics?format=prometheus`` renders.  All
mutators take one lock; a snapshot is a consistent point-in-time copy.  The
per-tenant blocks and the drift sketches (``continual/``) are not ported
(ROADMAP Queue 1 items 3 and 8).
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, Optional

from ..obs import registry as obs_registry
from ..obs.registry import LogHistogram as LatencyHistogram

__all__ = ["LatencyHistogram", "ServeMetrics", "prometheus_replica_text"]

#: live ServeMetrics instances, merged by the "serve" snapshot provider; weak
#: so a torn-down batcher's metrics do not outlive it in snapshots
_instances: "weakref.WeakSet[ServeMetrics]" = weakref.WeakSet()

#: the counters every snapshot carries, merged across instances
COUNTERS = ("requests", "responses", "shed", "errors", "data_faults", "quarantined",
            "fallback_records", "fallback_batches", "degraded_batches", "replica_failures",
            "replica_rebuilds", "batches", "occupancy_sum", "padded_rows", "swaps")


def _replica_block(device: str = "") -> Dict[str, Any]:
    return {"device": device, "batches": 0, "records": 0, "responses": 0, "padded_rows": 0,
            "request_latency": LatencyHistogram(), "batch_latency": LatencyHistogram()}


class ServeMetrics:
    """Counters and histograms of the serving plane.

    ``requests`` counts admission attempts, ``shed`` the rejected ones
    (bounded-queue overflow), ``responses`` the completed scores,
    ``fallback_records`` the records that went to the per-record row path,
    ``errors`` the requests that failed outright, ``data_faults`` and
    ``quarantined`` the records rejected for their data (HTTP 422).  Batch
    side: ``batches``, per-bucket dispatch counts, occupancy (real records a
    dispatched batch) and padded rows.  Self-healing: ``degraded_batches``
    (served on the row path while a slot's circuit was open),
    ``replica_failures`` and ``replica_rebuilds``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        for k in COUNTERS:
            setattr(self, k, 0)
        self.bucket_counts: Dict[int, int] = {}
        self.request_latency = LatencyHistogram()
        self.batch_latency = LatencyHistogram()
        #: per-replica-slot breakdowns beside the merged totals
        self.replica_stats: Dict[int, Dict[str, Any]] = {}
        #: gauges polled at snapshot time (the live queue depth)
        self._gauges: Dict[str, Callable[[], Any]] = {}
        _instances.add(self)

    def _replica(self, slot: int, device: str = "") -> Dict[str, Any]:
        """Per-slot accumulator (callers hold ``self._lock``)."""
        st = self.replica_stats.get(slot)
        if st is None:
            st = self.replica_stats[slot] = _replica_block(device)
        elif device and not st["device"]:
            st["device"] = device
        return st

    # ---- mutators ----------------------------------------------------------
    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    def observe_request(self, ms: float, replica: Optional[int] = None) -> None:
        with self._lock:
            self.responses += 1
            self.request_latency.record(ms)
            if replica is not None:
                st = self._replica(replica)
                st["responses"] += 1
                st["request_latency"].record(ms)

    def observe_batch(self, ms: float, n_records: int, bucket: int,
                      replica: Optional[int] = None, device: str = "") -> None:
        with self._lock:
            self.batches += 1
            self.occupancy_sum += n_records
            self.padded_rows += bucket - n_records
            self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1
            self.batch_latency.record(ms)
            if replica is not None:
                st = self._replica(replica, device)
                st["batches"] += 1
                st["records"] += n_records
                st["padded_rows"] += bucket - n_records
                st["batch_latency"].record(ms)

    def add_gauge(self, name: str, fn: Callable[[], Any]) -> None:
        with self._lock:
            self._gauges[name] = fn

    # ---- export ------------------------------------------------------------
    def _merge_into(self, acc: Dict[str, Any]) -> None:
        """Fold this instance into a cross-instance accumulator."""
        with self._lock:
            for k in COUNTERS:
                acc[k] += getattr(self, k)
            for b, c in self.bucket_counts.items():
                acc["bucket_counts"][b] = acc["bucket_counts"].get(b, 0) + c
            acc["request_latency"].merge(self.request_latency)
            acc["batch_latency"].merge(self.batch_latency)
            for slot, st in self.replica_stats.items():
                dst = acc["replicas"].setdefault(slot, _replica_block(st["device"]))
                for k in ("batches", "records", "responses", "padded_rows"):
                    dst[k] += st[k]
                dst["request_latency"].merge(st["request_latency"])
                dst["batch_latency"].merge(st["batch_latency"])

    def slo_sample(self) -> Dict[str, Any]:
        """The cumulative counters the SLO monitor differences at its
        window (:class:`~transmogrifai_tpu_torch.obs.slo.SLOMonitor`)."""
        with self._lock:
            return {"requests": self.requests, "responses": self.responses,
                    "errors": self.errors, "shed": self.shed,
                    "latency_counts": list(self.request_latency.counts),
                    "latency_n": self.request_latency.n,
                    "latency_sum_ms": self.request_latency.sum_ms,
                    "latency_max_ms": self.request_latency.max_ms}

    def snapshot(self) -> Dict[str, Any]:
        acc = _empty()
        self._merge_into(acc)
        out = _finish(acc)
        with self._lock:
            gauges = dict(self._gauges)
        for name, fn in gauges.items():
            try:
                out[name] = fn()
            except Exception:
                out[name] = None
        return out


def _empty() -> Dict[str, Any]:
    acc: Dict[str, Any] = {k: 0 for k in COUNTERS}
    acc.update(bucket_counts={}, request_latency=LatencyHistogram(),
               batch_latency=LatencyHistogram(), replicas={})
    return acc


def _finish(acc: Dict[str, Any]) -> Dict[str, Any]:
    occ = acc.pop("occupancy_sum")
    acc["batch_occupancy_mean"] = occ / acc["batches"] if acc["batches"] else 0.0
    acc["bucket_counts"] = {str(k): v for k, v in sorted(acc["bucket_counts"].items())}
    acc["request_latency"] = acc["request_latency"].to_json()
    acc["batch_latency"] = acc["batch_latency"].to_json()
    acc["replicas"] = {
        str(slot): {**{k: v for k, v in st.items()
                       if k not in ("request_latency", "batch_latency")},
                    "request_latency": st["request_latency"].to_json(),
                    "batch_latency": st["batch_latency"].to_json()}
        for slot, st in sorted(acc["replicas"].items())}
    return acc


def merged_snapshot() -> Dict[str, Any]:
    """``ServeMetrics.snapshot()``'s shape summed over every live instance
    (gauges are per instance and left out): ``obs.snapshot()["serve"]``."""
    acc = _empty()
    n = 0
    for m in list(_instances):
        m._merge_into(acc)
        n += 1
    out = _finish(acc)
    out["instances"] = n
    return out


def prometheus_replica_text(snapshot: Dict[str, Any]) -> str:
    """Labelled per-replica lines (``{replica=...,device=...}``) for the
    Prometheus export, whose generic flattener is label-free; "" when no
    per-replica traffic was recorded."""
    lines = []
    for slot, st in sorted(snapshot.get("replicas", {}).items()):
        labels = f'{{replica="{slot}",device="{st.get("device", "")}"}}'
        for k in ("batches", "records", "responses", "padded_rows"):
            if k in st:
                lines.append(f"tmog_serve_replica_{k}{labels} {st[k]}")
        for hist in ("request_latency", "batch_latency"):
            hj = st.get(hist) or {}
            for q in ("count", "mean_ms", "p50_ms", "p99_ms"):
                v = hj.get(q)
                if isinstance(v, (int, float)):
                    lines.append(f"tmog_serve_replica_{hist}_{q}{labels} {v}")
    return "\n".join(lines) + ("\n" if lines else "")


obs_registry.register_provider("serve", merged_snapshot)
