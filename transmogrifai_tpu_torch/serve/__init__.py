"""serve: online scoring on the card, micro-batched into shape buckets.

The port's copy of ``transmogrifai_tpu/serve/`` on one card, for the default
tenant.  Concurrent requests are micro-batched into padded power-of-two
shape buckets and routed to the least loaded of N replicas
(``TMOG_SERVE_REPLICAS``, default one per card), each scoring on its own
CUDA stream.  Models hot-swap through a versioned registry (load -> warm ->
swap -> drain, rolling per replica, so capacity never drops to zero); every
(bucket, replica) score program is captured at warm-up as one CUDA graph,
with the linear families' prediction heads on K-AF; overload sheds (a
bounded queue and HTTP 429) rather than degrading everyone's latency.

Layering::

    server.py      HTTP front end (stdlib ThreadingHTTPServer), shedding
    batcher.py     bounded admission -> padded bucket batches ->
                   least-outstanding-work replica routing
    contract.py    per-model input contracts: admission and batch
                   validation, poison rows quarantined per row (422)
    registry.py    versioned models, N replica slots, rolling hot swap
    supervisor.py  per-slot circuit breakers and the probe / rebuild daemon
    aot.py         per-(bucket, replica) CUDA graphs over the streaming
                   planner's program, the heads captured with it
    metrics.py     latency histograms and counters (merged and per replica)

Entry points: this module's classes.  ``ModelRegistry()`` places replicas
on the CUDA cards and raises without one; the CPU route is asked for by
name (``ModelRegistry(devices=[torch.device("cpu")])``) and runs the
kernels' plain versions.  Named tenants and their placement, the compile
cache, the runner's ``Serve`` run type and the console script are not
ported (ROADMAP Queue 1 items 2 and 3).
"""
from ..resilience.quarantine import DataFault
from .batcher import MicroBatcher, Scored, ShedError
from .contract import InputContract, validation_enabled
from .metrics import LatencyHistogram, ServeMetrics, prometheus_replica_text
from .registry import (DEFAULT_TENANT, ModelRegistry, Replica, ServingModel, bucket_for,
                       shape_buckets)
from .server import ModelServer
from .supervisor import ReplicaSupervisor

__all__ = [
    "DEFAULT_TENANT", "DataFault", "InputContract", "LatencyHistogram",
    "MicroBatcher", "ModelRegistry", "ModelServer", "Replica", "ReplicaSupervisor",
    "Scored", "ServeMetrics", "ServingModel", "ShedError", "bucket_for",
    "prometheus_replica_text", "shape_buckets", "validation_enabled",
]
