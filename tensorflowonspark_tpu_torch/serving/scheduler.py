"""Request lifecycle + admission scheduling (pure Python).

States::

    QUEUED ──admit──> PREFILL ──first token──> RUNNING ──eos/budget──> FINISHED
       │                 │                        │
       └────cancel───────┴────────cancel──────────┴──> CANCELLED
                         └────────error───────────┴──> FAILED

Admission is **priority-class ordered**: the candidate is the
highest-``priority`` waiting request, FIFO within a class. Within that
choice admission stays page-reservation gated: the candidate is admitted
only when a decode slot is free AND the :class:`PagePool` can cover its
full ``ceil((prompt + max_new) / page_size)`` reservation — cache-full
backpressure is head-of-line blocking *within the best class* by design
(predictable latency ordering; a small request never starves a bigger
same-class request that arrived first, and a lower class never overtakes
a blocked higher one). Every terminal transition releases the
reservation exactly once; ``release()`` is the single choke point, so the
accounting invariant "no pages in use once all requests are terminal" is
structural.

Prefix sharing and preemption, which the JAX scheduler also carries, wait
for their own slice (ROADMAP A7b).
"""

import itertools
import threading
import time
import uuid

from tensorflowonspark_tpu_torch.serving.cache import CacheFull

QUEUED = "QUEUED"
PREFILL = "PREFILL"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
CANCELLED = "CANCELLED"
FAILED = "FAILED"

TERMINAL = (FINISHED, CANCELLED, FAILED)

_ids = itertools.count(1)


class Request:
    """One generation request's bookkeeping (engine-internal; user code
    holds the :class:`~tensorflowonspark_tpu_torch.serving.engine.RequestHandle`
    instead)."""

    __slots__ = (
        "id", "trace", "prompt", "max_new_tokens", "temperature",
        "top_k", "top_p", "eos_token", "priority", "state", "pages",
        "slot", "generated", "error",
        "prefill_pos", "prefill_cache", "prefill_alloc",
        "t_submit", "t_first", "t_done", "handle",
    )

    def __init__(self, prompt, max_new_tokens, temperature=0.0,
                 eos_token=None, top_k=0, top_p=0.0, priority=0,
                 trace=None):
        self.id = next(_ids)
        # Per-request trace id, echoed on the HTTP stream's terminal line.
        # A caller-supplied trace id is ADOPTED, not replaced: a request
        # arriving over HTTP keeps the trace its client sent.
        self.trace = trace or uuid.uuid4().hex[:12]
        self.prompt = prompt                      # 1-D int32 np array
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token = None if eos_token is None else int(eos_token)
        # Priority class (higher = more urgent, default 0): orders
        # admission across classes.
        self.priority = int(priority)
        self.state = QUEUED
        self.pages = []
        self.slot = None
        self.generated = []
        self.error = None
        self.prefill_pos = 0       # prompt tokens already prefilled
        self.prefill_cache = None  # private contiguous cache during PREFILL
        self.prefill_alloc = 0
        self.t_submit = time.perf_counter()
        self.t_first = None
        self.t_done = None
        self.handle = None

    @property
    def prompt_len(self):
        return int(self.prompt.shape[0])

    @property
    def total_len(self):
        return self.prompt_len + self.max_new_tokens

    @property
    def cache_len(self):
        """Tokens currently IN the paged cache: the prompt plus every
        generated token except the newest (which is the next step's
        input — its K/V is written by the step that consumes it)."""
        if not self.generated:
            return self.prompt_len
        return self.prompt_len + len(self.generated) - 1

    @property
    def remaining(self):
        return self.max_new_tokens - len(self.generated)


class Scheduler:
    """Priority-class admission + slot/page bookkeeping over a
    :class:`PagePool` (FIFO within a class)."""

    def __init__(self, pool, max_slots):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.pool = pool
        self.max_slots = int(max_slots)
        self.slots = [None] * self.max_slots
        # Admission order is (priority desc, id asc) — a plain list
        # scanned per admission (bounded by the engine's max_queue).
        self.waiting = []
        self._lock = threading.Lock()

    def _required(self, req):
        return self.pool.required(req.total_len)

    # -- queue ---------------------------------------------------------------

    def submit(self, req):
        """Validate and enqueue. Raises :class:`~tensorflowonspark_tpu_torch.
        serving.cache.CacheFull` (a ValueError) for a request whose
        reservation exceeds the whole pool — it can NEVER run, and
        queueing it would deadlock the FIFO."""
        need = self._required(req)
        if need > self.pool.capacity:
            raise CacheFull(
                "request needs {} pages but the pool's capacity is {} "
                "({} pages of {} slots; page 0 is reserved) — it can "
                "never be admitted".format(
                    need, self.pool.capacity, self.pool.num_pages,
                    self.pool.page_size))
        with self._lock:
            self.waiting.append(req)

    def drop_queued(self, req):
        """Remove a still-QUEUED request (cancellation before admission)."""
        with self._lock:
            try:
                self.waiting.remove(req)
                return True
            except ValueError:
                return False

    # -- admission -----------------------------------------------------------

    def next_admission(self):
        """Admit the best waiting request (priority desc, arrival asc)
        when a slot is free and its full page reservation fits — else
        None (backpressure). On success the request holds its pages and
        slot and is in PREFILL state."""
        with self._lock:
            req = None
            for r in self.waiting:
                if req is None or (r.priority, -r.id) > (req.priority,
                                                         -req.id):
                    req = r
            if req is None:
                return None
            free_slot = next(
                (i for i, s in enumerate(self.slots) if s is None), None)
            if free_slot is None:
                return None
            pages = self.pool.alloc(self._required(req))
            if pages is None:
                return None
            self.waiting.remove(req)
            req.pages = pages
            req.slot = free_slot
            req.state = PREFILL
            self.slots[free_slot] = req
            return req

    # -- release -------------------------------------------------------------

    def release(self, req, state):
        """Move ``req`` to the terminal ``state`` and return its resources
        — the single choke point every terminal path goes through, so
        pages can never leak or double-free."""
        with self._lock:
            if req.state in TERMINAL:
                return False
            if req.pages:
                self.pool.free(req.pages)
                req.pages = []
            if req.slot is not None and self.slots[req.slot] is req:
                self.slots[req.slot] = None
            req.slot = None
            req.prefill_cache = None
            req.state = state
            req.t_done = time.perf_counter()
            return True

    # -- views ---------------------------------------------------------------

    def active(self):
        with self._lock:
            return [r for r in self.slots if r is not None]

    def queued(self):
        with self._lock:
            return len(self.waiting)

    def has_work(self):
        with self._lock:
            return bool(self.waiting) or any(
                s is not None for s in self.slots)

    def stats(self):
        with self._lock:
            by_priority = {}
            for r in self.waiting:
                by_priority[r.priority] = by_priority.get(r.priority,
                                                          0) + 1
            return {
                "queued": len(self.waiting),
                # Starvation visibility: depth per priority class.
                "queued_by_priority": dict(sorted(by_priority.items())),
                "active": sum(1 for s in self.slots if s is not None),
                "slots": self.max_slots,
                **self.pool.stats(),
            }
