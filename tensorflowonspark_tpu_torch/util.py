"""Host utilities of the port (its copy of ``queue_put_bounded`` from
``tensorflowonspark_tpu/util.py``)."""

import queue as _queue_mod


def queue_put_bounded(q, item, stopped, always=False, timeout=0.2,
                      stopped_tries=25):
    """Producer-side queue put that gives up when the consumer went away.

    Returns True once ``item`` is enqueued. Ordinary items stop retrying as
    soon as ``stopped()``; ``always`` items (end sentinels, producer
    exceptions) must reach a merely slow consumer, so they keep retrying
    while live and get ``stopped_tries`` more attempts after stop: a
    consumer that vanished with a full queue must not pin the producer
    thread here forever. Used by ``train.prefetch.DevicePrefetch``.
    """
    tries = 0
    while True:
        try:
            q.put(item, timeout=timeout)
            return True
        except _queue_mod.Full:
            if not stopped():
                continue
            if not always:
                return False
            tries += 1
            if tries >= stopped_tries:
                return False
