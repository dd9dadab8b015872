"""Continuous-batching serving over a paged KV cache (port of
``tensorflowonspark_tpu.serving``): the scheduler, cache-manager and
model-runner split, the engine, and the page-pool ledger."""

from tensorflowonspark_tpu_torch.serving.cache import (
    CacheFull, PagePool, prefix_keys,
)
from tensorflowonspark_tpu_torch.serving.engine import (
    QueueFull, RequestHandle, ServingEngine, StreamConsumer,
)
from tensorflowonspark_tpu_torch.serving.runner import ModelRunner
from tensorflowonspark_tpu_torch.serving.scheduler import (
    CANCELLED, FAILED, FINISHED, PREEMPTED, PREFILL, QUEUED, RUNNING,
    Request, Scheduler,
)

__all__ = [
    "CANCELLED", "CacheFull", "FAILED", "FINISHED", "ModelRunner",
    "PREEMPTED", "PREFILL", "PagePool", "QUEUED", "QueueFull", "RUNNING",
    "Request", "RequestHandle", "Scheduler", "ServingEngine",
    "StreamConsumer", "prefix_keys",
]
