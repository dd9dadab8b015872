"""Continuous-batching serving over a paged KV cache (port of
``tensorflowonspark_tpu.serving``): the scheduler, cache-manager and
model-runner split, the engine and the page-pool ledger; drain and
migration between engines; disaggregated prefill/decode with the handoff
wire codec; the fleet router over local and HTTP replicas; the SLO-driven
autoscaler; and speculative decoding with a draft model.

The HTTP plane (``train.metrics.MetricsServer``) serves it: ``POST
/v1/generate``, ``POST /v1/migrate`` and ``GET /v1/serving``.
"""

from tensorflowonspark_tpu_torch.serving.autoscaler import (
    AutoscalePolicy, Autoscaler,
)
from tensorflowonspark_tpu_torch.serving.cache import (
    CacheFull, PagePool, prefix_keys,
)
from tensorflowonspark_tpu_torch.serving.engine import (
    QueueFull, RequestHandle, ServingEngine, StreamConsumer,
)
from tensorflowonspark_tpu_torch.serving.fleet import (
    EngineUnavailable, LocalEngine, RemoteEngine, ServingFleet,
    heartbeat_stats_fn,
)
from tensorflowonspark_tpu_torch.serving.runner import (
    HANDOFF_WIRE_VERSION, ModelRunner, decode_handoff, encode_handoff,
)
from tensorflowonspark_tpu_torch.serving.scheduler import (
    CANCELLED, FAILED, FINISHED, PREEMPTED, PREFILL, QUEUED, RUNNING,
    Request, Scheduler,
)

__all__ = [
    "CacheFull", "PagePool", "prefix_keys", "QueueFull", "RequestHandle",
    "ServingEngine", "StreamConsumer",
    "ServingFleet", "LocalEngine", "RemoteEngine", "EngineUnavailable",
    "heartbeat_stats_fn",
    "Autoscaler", "AutoscalePolicy",
    "ModelRunner", "Scheduler", "Request",
    "HANDOFF_WIRE_VERSION", "encode_handoff", "decode_handoff",
    "QUEUED", "PREFILL", "RUNNING", "PREEMPTED", "FINISHED", "CANCELLED",
    "FAILED",
]
