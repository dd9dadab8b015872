"""Request lifecycle + admission scheduling (pure Python).

States::

    QUEUED ──admit──> PREFILL ──first token──> RUNNING ──eos/budget──> FINISHED
       │                 │                        │
       │                 ├──────preempt───────────┤──> PREEMPTED ──admit──> ...
       └────cancel───────┴────────cancel──────────┴──> CANCELLED
                         └────────error───────────┴──> FAILED

Admission is **priority-class ordered**: the candidate is the
highest-``priority`` waiting request, FIFO within a class (a preempted
request keeps its original arrival id, so it resumes ahead of later
arrivals of its class). Within that choice admission stays
page-reservation gated: the candidate is admitted only when a decode slot
is free AND the :class:`PagePool` can cover its full ``ceil((prompt +
max_new + reserve_slack) / page_size)`` reservation — cache-full
backpressure is head-of-line blocking *within the best class* by design
(a small request never starves a bigger same-class request that arrived
first, and a lower class never overtakes a blocked higher one). With
``prefix_share`` the reservation goes through ``PagePool.admit``: the
prompt's full-page chain keys match against the prefix index, matched
pages are RETAINED (refcount bump) instead of allocated, and the engine
skips their prefill; a whole-prompt match additionally swaps the last
matched page for a fresh private one (copy-on-write — the tail token's
K/V write must not touch a page other holders read).

**Preemption**: when the best waiting request is blocked and a strictly
lower-priority request is active, the engine picks the victim
(:meth:`Scheduler.preemption_victim` — lowest priority, then newest) and
releases it with ``state=PREEMPTED``: its pages/slot return to the pool
and the request re-enters the waiting queue, to be restored later by page
swap-in or prefill replay. Every terminal transition *and* every
preemption releases the reservation exactly once; ``release()`` is the
single choke point (it also drops an unconsumed COW source reference), so
the accounting invariant "no pages in use once all requests are
terminal" is structural.
"""

import itertools
import threading
import time
import uuid

import numpy as np

from tensorflowonspark_tpu_torch.serving import cache as cache_mod
from tensorflowonspark_tpu_torch.serving.cache import CacheFull

QUEUED = "QUEUED"
PREFILL = "PREFILL"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"
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
        "prefill_pos", "prefill_cache", "prefill_alloc", "prefill_started",
        "prefill_start", "prefix_keys", "shared_pages", "prefix_len",
        "cow_src",
        "preempt_count", "t_preempt", "swap_pages", "swap_count",
        "replay",
        "t_submit", "t_admit", "t_first", "t_done", "cancel_requested",
        "handle",
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
        # admission across classes and marks the request preemptable by
        # any strictly higher class.
        self.priority = int(priority)
        self.state = QUEUED
        self.pages = []
        self.slot = None
        self.generated = []
        self.error = None
        self.prefill_pos = 0       # prompt tokens already prefilled
        self.prefill_cache = None  # private contiguous cache during PREFILL
        self.prefill_alloc = 0
        self.prefill_started = None  # perf_counter stamp of the prefill
        self.prefill_start = 0     # first position the scatter writes
        self.prefix_keys = []      # chain keys of the prompt's full pages
        self.shared_pages = 0      # leading pages RETAINED, not allocated
        self.prefix_len = 0        # prompt tokens whose prefill is skipped
        self.cow_src = None        # shared page to copy before the tail
        self.preempt_count = 0     # times this request was preempted
        self.t_preempt = None      # perf_counter stamp of the last one
        self.swap_pages = None     # host copy of cached pages (swap mode)
        self.swap_count = 0        # pages the host copy covers
        self.replay = None         # prompt+generated replay (recompute)
        self.t_submit = time.perf_counter()
        self.t_admit = None
        self.t_first = None
        self.t_done = None
        # Set by a cancel; the only cancel signal a request carries while
        # it is between engines (no scheduler holds it then).
        self.cancel_requested = False
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

    def replay_tokens(self):
        """The prefill stream that rebuilds this request's cache after a
        recompute-mode preemption: the prompt plus every generated token
        except the newest (the next decode input, same rule as
        :attr:`cache_len`)."""
        if not self.generated:
            return self.prompt
        return np.concatenate([
            self.prompt,
            np.asarray(self.generated[:-1], np.int32)]).astype(np.int32)


class Scheduler:
    """Priority-class admission + slot/page bookkeeping over a
    :class:`PagePool` (FIFO within a class; see the module docstring for
    the cross-class and preemption rules)."""

    def __init__(self, pool, max_slots, reserve_slack=0,
                 prefix_share=False):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.pool = pool
        self.max_slots = int(max_slots)
        # Copy-on-write prefix sharing: admission matches the prompt's
        # full-page chain keys against the pool's prefix index and
        # RETAINS matched pages instead of allocating fresh ones.
        self.prefix_share = bool(prefix_share)
        # Extra tokens reserved per request beyond prompt + max_new: a
        # decode call runs every row the full ``decode_horizon`` steps (a
        # row that finishes mid-call writes up to horizon-1 junk slots
        # past its budget), so the reservation must cover the overshoot.
        self.reserve_slack = int(reserve_slack)
        self.slots = [None] * self.max_slots
        # Admission order is (priority desc, id asc) — a plain list
        # scanned per admission (bounded by the engine's max_queue).
        self.waiting = []
        self.preemptions = 0       # lifetime preempt releases
        self._lock = threading.Lock()

    def _required(self, req):
        return self.pool.required(req.total_len + self.reserve_slack)

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
        if self.prefix_share and not req.prefix_keys:
            # Chain keys computed once per request; admission walks them
            # on every attempt and the engine registers the request's own
            # pages with them after its scatter.
            req.prefix_keys = cache_mod.prefix_keys(
                req.prompt, self.pool.page_size)
        with self._lock:
            self.waiting.append(req)

    def drop_queued(self, req):
        """Remove a waiting request (cancellation before admission, or of
        a preempted request awaiting re-admission)."""
        with self._lock:
            try:
                self.waiting.remove(req)
                return True
            except ValueError:
                return False

    # -- admission -----------------------------------------------------------

    def _best_waiting_locked(self):
        best = None
        for r in self.waiting:
            if best is None or (r.priority, -r.id) > (best.priority,
                                                      -best.id):
                best = r
        return best

    def best_waiting(self):
        """The request admission would pick next (highest priority,
        oldest within the class) — the engine's preemption trigger
        compares its class against the active set. None when idle."""
        with self._lock:
            return self._best_waiting_locked()

    def next_admission(self):
        """Admit the best waiting request (priority desc, arrival asc)
        when a slot is free and its full page reservation fits — else
        None (backpressure; the engine may preempt and retry). On success
        the request holds its pages and slot and is in PREFILL state. A
        swap-mode preempted request allocates PRIVATE pages (its host
        copy is restored into them — sharing would write a page other
        holders read); a recompute-mode one goes through the prefix-matched
        path minus the COW demotion (a resumed request never needs the
        prompt's last-token logits, so a whole-prompt match just
        gathers)."""
        with self._lock:
            req = self._best_waiting_locked()
            if req is None:
                return None
            free_slot = next(
                (i for i, s in enumerate(self.slots) if s is None), None)
            if free_slot is None:
                return None
            need = self._required(req)
            # "No COW demotion on resume" holds only for a victim that
            # had sampled something: its pending input is its newest
            # generated token. A preemptee with no generated tokens still
            # needs the prompt's last-token logits for its FIRST sample,
            # so it re-admits with fresh-request semantics.
            resuming = req.state == PREEMPTED and bool(req.generated)
            if self.prefix_share and req.swap_pages is None:
                got = self.pool.admit(
                    req.prefix_keys, need,
                    prompt_len=None if resuming else req.prompt_len)
                if got is None:
                    return None
                pages, matched, cow_src = got
                req.shared_pages = matched
                req.cow_src = cow_src
                # Prefill-skip extent: every token the retained pages
                # (plus the COW copy) already hold. The COW case skips
                # all but the prompt's LAST token — it re-runs for its
                # logits and its K/V lands in the private copy.
                if cow_src is not None:
                    req.prefix_len = req.prompt_len - 1
                else:
                    req.prefix_len = matched * self.pool.page_size
            else:
                pages = self.pool.alloc(need)
                if pages is None:
                    return None
            self.waiting.remove(req)
            req.pages = pages
            req.slot = free_slot
            req.state = PREFILL
            req.t_admit = time.perf_counter()
            self.slots[free_slot] = req
            return req

    # -- preemption ----------------------------------------------------------

    def preemption_victim(self, priority):
        """The active request a ``priority``-class admission may evict:
        strictly lower priority, lowest class first, newest (largest
        arrival id) within the class — the cheapest work to throw away.
        None when every active request is at or above ``priority``."""
        with self._lock:
            victim = None
            for r in self.slots:
                if r is None or r.priority >= priority:
                    continue
                if victim is None or (r.priority, -r.id) < (
                        victim.priority, -victim.id):
                    victim = r
            return victim

    # -- release -------------------------------------------------------------

    def release(self, req, state):
        """Move ``req`` to ``state`` and return its resources — the single
        choke point every terminal path AND every preemption goes
        through, so pages can never leak or double-free.
        ``state=PREEMPTED`` re-enqueues the request (original arrival id —
        it resumes ahead of later same-class arrivals) instead of
        finishing it; everything else is terminal."""
        with self._lock:
            if req.state in TERMINAL or req.state == state:
                return False
            if req.pages:
                self.pool.free(req.pages)
                req.pages = []
            if req.cow_src is not None:
                # The request died before its COW copy consumed the
                # retained source page — drop that reference too, or a
                # cancelled sharer would pin it forever.
                self.pool.free([req.cow_src])
                req.cow_src = None
            if req.slot is not None and self.slots[req.slot] is req:
                self.slots[req.slot] = None
            req.slot = None
            req.prefill_cache = None
            # Prefill/sharing progress never survives a release: a
            # resumed request re-earns it at its next admission.
            req.prefill_pos = 0
            req.prefill_start = 0
            req.prefill_alloc = 0
            req.prefill_started = None
            req.shared_pages = 0
            req.prefix_len = 0
            req.replay = None
            req.state = state
            if state == PREEMPTED:
                req.t_preempt = time.perf_counter()
                req.preempt_count += 1
                self.preemptions += 1
                self.waiting.append(req)
            else:
                # Terminal: the host-side swap copy (if any) dies with
                # the request — a victim cancelled mid-swap frees
                # everything it holds, device AND host.
                req.swap_pages = None
                req.swap_count = 0
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

    def preempted_waiting(self):
        """Preempted requests awaiting re-admission (queue residents)."""
        with self._lock:
            return sum(1 for r in self.waiting if r.state == PREEMPTED)

    def stats(self):
        with self._lock:
            by_priority = {}
            preempted = 0
            for r in self.waiting:
                by_priority[r.priority] = by_priority.get(r.priority,
                                                          0) + 1
                if r.state == PREEMPTED:
                    preempted += 1
            return {
                "queued": len(self.waiting),
                # Starvation visibility: depth per priority class.
                "queued_by_priority": dict(sorted(by_priority.items())),
                "preempted_waiting": preempted,
                "preemptions": self.preemptions,
                "active": sum(1 for s in self.slots if s is not None),
                "slots": self.max_slots,
                **self.pool.stats(),
            }
