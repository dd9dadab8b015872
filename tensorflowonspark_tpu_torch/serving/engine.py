"""Continuous-batching serving engine (port of ``serving/engine.py``).

One :meth:`ServingEngine.step` is the whole scheduling policy:

1. **cancellations** — flagged requests release pages/slots immediately;
2. **admit + prefill** — when no prefill is in flight, the best waiting
   request is admitted if a slot AND its full page reservation are
   available (cache-full backpressure: it stays queued). Its prompt
   prefills through a private contiguous cache ONE CHUNK per step, so a
   long prompt stalls the decode batch by at most one chunk per step. The
   finished prefill scatters into pool pages, its first token samples
   from the last-position logits, and the request joins the decode batch;
3. **decode** — one call over all slots: every RUNNING row advances the
   full ``decode_horizon`` tokens, each step through the paged-attention
   kernel (a row that exhausts its budget or hits eos mid-call decodes
   junk into the ``horizon - 1`` slack slots its reservation includes —
   cheaper than throttling the whole batch to the smallest remaining
   budget); rows that finish free their pages and slot the moment the
   call returns, and their post-terminal tokens are dropped. With a draft
   model attached (``speculative_tokens=k``) an all-greedy batch runs a
   speculative round instead: the draft proposes ``k`` tokens a row, one
   batched target forward verifies them, and rejection is an extent
   rollback; every emitted token is the target's own greedy choice, so
   the stream equals solo ``generate()``'s.

A blocked higher-priority admission may **preempt** a strictly
lower-priority resident (``preempt="swap"``: its pages go to host memory
and come back byte for byte; ``"recompute"``: they are dropped and
rebuilt by prefill replay). With ``prefix_share`` admission shares
already-resident full prompt pages (copy-on-write for a whole-prompt
match) and skips their prefill.

Tokens stream to per-request handles as they exist; TTFT and end-to-end
latency stay on the handles, in :meth:`ServingEngine.stats` and in the
``serve_ttft_seconds``/``serve_request_seconds`` histograms, whose
percentiles ride ``node_stats()`` heartbeats and whose buckets keep the
request's trace id as their exemplar. Each request's spans (``serve/
queue_wait``, ``serve/prefill``, ``serve/decode``, ``serve/preempt_wait``,
the ``serve/request`` envelope) carry its trace, so
``telemetry.attribution.request_profile`` splits its latency.

**Drain and migration**: :meth:`ServingEngine.begin_drain` closes
admission (``submit`` raises :class:`QueueFull`, failover material for a
fleet) while everything accepted keeps running;
:meth:`ServingEngine.migrate_requests` hands the residents to a peer — a
RUNNING request's pages travel as the swap copy, so its greedy stream
continues bitwise on the peer.

**Disaggregated prefill/decode**: a ``role="prefill"`` engine with a
``handoff_fn`` runs nothing but chunked prefill. Each request's finished
pages are extracted, wire-encoded (``runner.encode_handoff``) and handed
to a decode engine (:meth:`ServingEngine.inject_handoff`, in process or
behind ``POST /v1/migrate``) at the moment it would have joined the decode
batch, its first token already emitted. A refused or failed handoff
replays the request here from its host copy. ``role="decode"`` is routing
metadata for ``ServingFleet``.
"""

import collections
import logging
import queue as queue_mod
import threading
import time
import weakref

import numpy as np

from tensorflowonspark_tpu_torch import device_info, telemetry
from tensorflowonspark_tpu_torch.models import decoding
from tensorflowonspark_tpu_torch.serving import scheduler as sched_mod
from tensorflowonspark_tpu_torch.serving.cache import PagePool
from tensorflowonspark_tpu_torch.serving.runner import (
    HANDOFF_WIRE_VERSION, ModelRunner, decode_handoff, encode_handoff,
)
from tensorflowonspark_tpu_torch.serving.scheduler import (
    CANCELLED, FAILED, FINISHED, PREEMPTED, PREFILL, RUNNING, Request,
    Scheduler,
)

logger = logging.getLogger(__name__)

# Latency samples kept for the stats() percentiles.
_LATENCY_WINDOW = 1024


class QueueFull(RuntimeError):
    """The engine's admission queue is at ``max_queue`` (HTTP 429)."""


class StreamConsumer:
    """The consumer half of a token-stream handle: a producer (the engine
    loop, or a fleet reader thread) puts ``("token", id)`` / ``("error",
    msg)`` / ``("done", state)`` tuples on ``_events``;
    ``stream()``/``result()`` drain them. Shared by
    :class:`RequestHandle` and the fleet's ``RemoteHandle``, so local and
    routed requests keep one timeout/re-iteration contract."""

    def __init__(self):
        self._events = queue_mod.Queue()
        self._collected = []
        self._terminated = False

    def stream(self, timeout=60.0):
        """Yield token ids as they are generated; returns at the
        terminal event, raises RuntimeError on engine-side failure and
        queue.Empty when the engine stalls past ``timeout``. Re-iterable
        after the terminal event (returns immediately)."""
        while True:
            if self._terminated and self._events.empty():
                return
            kind, val = self._events.get(timeout=timeout)
            if kind == "token":
                self._collected.append(val)
                yield val
            elif kind == "error":
                self._terminated = True
                raise RuntimeError(val)
            else:  # done
                self._terminated = True
                return

    def result(self, timeout=60.0):
        """Block until terminal; returns the generated token ids (the
        prompt is not echoed). A cancelled request returns the tokens
        it produced before cancellation."""
        for _ in self.stream(timeout=timeout):
            pass
        return list(self._collected)


class RequestHandle(StreamConsumer):
    """The caller's view of one submitted request: a stream of token ids
    ending in a terminal event. Thread-safe (the engine loop produces,
    any thread consumes)."""

    def __init__(self, engine, req):
        super().__init__()
        self._engine = engine
        self._req = req

    @property
    def id(self):
        return self._req.id

    @property
    def trace(self):
        return self._req.trace

    @property
    def state(self):
        return self._req.state

    @property
    def ttft(self):
        """Submit -> first token, seconds (None before the first)."""
        if self._req.t_first is None:
            return None
        return self._req.t_first - self._req.t_submit

    @property
    def e2e(self):
        """Submit -> terminal, seconds (None while in flight)."""
        if self._req.t_done is None:
            return None
        return self._req.t_done - self._req.t_submit

    def cancel(self):
        """Request cancellation; pages/slot are freed at the engine's
        next step boundary. Idempotent."""
        self._engine._cancel(self._req)


class _HandoffPending:
    """``handle._engine`` while a request is between engines: the source
    released it and the destination has not admitted it, so neither owns
    it. ``cancel()`` only flags the request; the transfer thread sees the
    flag before the hop and again at injection, and settles the cancel on
    whichever side the request is by then."""

    def _cancel(self, req):
        req.cancel_requested = True


_HANDOFF_PENDING = _HandoffPending()


# Live engines in this process. The serve_* gauges riding node_stats()
# heartbeats are process-global, so they aggregate across engines: an
# in-process fleet reports ONE occupancy plane, and one engine's close()
# never zeroes a still-serving sibling's numbers. Weak, so that an engine
# dropped without close() (a MetricsServer.set_engine swap) is collected.
_live_engines = weakref.WeakValueDictionary()
_live_lock = threading.Lock()


def _publish_gauges():
    """Aggregate the live engines' occupancy into the process gauges.
    Called per request transition (submit, admission, join, preempt,
    handoff, finish), never per decoded token; the remote fleet router
    ranks peers by exactly these gauges, so it is not rate-limited."""
    with _live_lock:
        engines = list(_live_engines.values())
    active = queued = preempted_q = 0
    totals = dict.fromkeys(
        ("pages_total", "slots", "pool_bytes", "in_use", "shared_pages",
         "refcount_total", "cow_copies_total", "preemptions",
         "spec_rounds", "spec_drafted", "spec_accepted",
         "handoffs_out", "handoffs_in", "handoff_fallbacks"), 0.0)
    for eng in engines:
        active += sum(1 for s in eng.scheduler.slots if s is not None)
        queued += eng.scheduler.queued()
        preempted_q += eng.scheduler.preempted_waiting()
        pool = eng.pool.stats()
        totals["pages_total"] += eng.pool.capacity
        totals["slots"] += eng.max_slots
        totals["pool_bytes"] += eng.pool.page_bytes * eng.pool.num_pages
        for key in ("in_use", "shared_pages", "refcount_total",
                    "cow_copies_total"):
            totals[key] += pool[key]
        totals["preemptions"] += eng.scheduler.preemptions
        for key in ("spec_rounds", "spec_drafted", "spec_accepted"):
            totals[key] += getattr(eng, key)
        totals["handoffs_out"] += eng.handoffs_out
        totals["handoffs_in"] += eng.handoffs_in
        totals["handoff_fallbacks"] += eng.handoff_fallbacks
    telemetry.set_gauge("serve_active_requests", float(active))
    telemetry.set_gauge("serve_queued_requests", float(queued))
    telemetry.set_gauge("serve_preempted_queued", float(preempted_q))
    for key in ("pages_total", "slots", "pool_bytes", "shared_pages",
                "refcount_total", "cow_copies_total", "preemptions",
                "handoffs_out", "handoffs_in", "handoff_fallbacks"):
        telemetry.set_gauge("serve_" + key, totals[key])
    telemetry.set_gauge("serve_pages_in_use", totals["in_use"])
    # Speculation: lifetime rounds and the acceptance rate (accepted over
    # proposed drafts), the dial that says whether a draft pays for itself.
    telemetry.set_gauge("serve_spec_rounds", totals["spec_rounds"])
    telemetry.set_gauge(
        "serve_spec_acceptance_rate",
        totals["spec_accepted"] / max(1.0, totals["spec_drafted"]))
    # The prefix index ships as a compact chain-key digest so a fleet
    # router in another process can affinity-route to this node
    # (fleet.RemoteEngine.match_tokens). The digest needs one page size to
    # mean anything; a process whose engines mix page sizes skips it.
    sharing = [eng for eng in engines if eng.scheduler.prefix_share]
    sizes = {eng.pool.page_size for eng in sharing}
    if len(sizes) == 1:
        digest = []
        for eng in sharing:
            digest.extend(eng.pool.index_digest())
        telemetry.set_gauge("serve_page_size", float(sizes.pop()))
        telemetry.set_node_extra("serve_prefix_digest",
                                 sorted(set(digest))[:512])


def _percentiles_ms(samples):
    if not samples:
        return {"p50": None, "p95": None, "p99": None}
    vals = np.asarray(samples, np.float64) * 1e3
    return {"p{}".format(q): float(np.percentile(vals, q))
            for q in (50, 95, 99)}


class ServingEngine:
    """Continuous-batching serving over a paged KV cache.

    ``model``: a port ``TransformerLM``; ``variables``: a ``state_dict``
    it adopts first (None: its own weights). ``device`` (default
    ``"cuda"``) is where the pool lives and the model runs — with no card
    present the engine raises unless ``device="cpu"`` is asked for.

    ``num_pages`` defaults to full occupancy with no backpressure (every
    slot serving a ``max_model_len`` request); the sizing rule is ``1 +
    sum_active ceil((prompt_i + max_new_i + decode_horizon - 1) /
    page_size)`` — minus whatever prefix sharing deduplicates.

    ``decode_horizon`` (default 8): decode steps per call, one host sync a
    call; every step still writes the pool in place and launches the
    paged-attention kernel. ``prefix_share`` (default True): admission
    retains already-resident pages holding an identical full-page prompt
    prefix instead of allocating, the matched prefix's prefill is skipped,
    and the last page copies on write when a whole prompt matched.
    ``preempt`` (default ``"swap"``): what a blocked higher-priority
    ``submit(priority=)`` does to a strictly lower-priority resident —
    ``"swap"`` copies its cached pages (int8 bytes and scales included) to
    host memory and restores them byte-exact at re-admission;
    ``"recompute"`` drops them and replays prompt + generated through the
    chunked prefill; ``"off"`` never evicts (priority still orders
    admission). Either resume keeps a greedy stream equal to the
    uninterrupted one (swap bitwise).

    ``kv_cache_dtype="int8"`` stores the pool quantized (per-token f32
    scales beside it); prefill stays full precision and the kernel
    dequantizes in registers.

    ``draft_model``/``draft_variables`` with ``speculative_tokens=k`` turn
    greedy decode into speculative rounds: the draft proposes ``k`` tokens
    a row from its own fixed-page pool (``runner.decode`` at horizon k),
    the target verifies all of them in ONE forward through its paged pool
    (``runner.verify``: the k + 1 tokens' K/V written in place, then the
    paged-attention kernel over the ``max_slots x (k + 1)`` query rows),
    and every emitted token is the target's own greedy argmax, so a stream
    equals solo ``generate()``'s at any acceptance rate. Rejected tokens
    roll back by extent: their K/V stays in the row's pages, unread. The
    reservation slack is ``max(decode_horizon - 1, k)``. The draft's vocab
    must be the target's and its context must cover ``max_model_len``;
    rounds run only while every RUNNING row is greedy (one sampled row
    falls the batch back to normal decode, and the drafts catch up by
    replay afterwards). The registry's draft geometry is
    ``models.factory.get_model("gpt2-draft")``.

    ``role`` (``"both"``, ``"prefill"`` or ``"decode"``) and ``handoff_fn``
    disaggregate prefill from decode: a ``"prefill"`` engine with a
    ``handoff_fn(req, payload) -> bool`` hands each finished prefill's pages
    to a decode engine instead of decoding (``ServingFleet`` installs one
    that routes to its least-loaded decode engine); ``"decode"`` marks an
    engine the fleet routes fresh prompts away from. Roles specialize, they
    do not disable: a decode engine still accepts prompts (failover), and a
    prefill engine decodes a request whose handoff was refused.
    """

    def __init__(self, model, variables=None, *, max_slots=8, page_size=128,
                 num_pages=None, max_model_len=None, prefill_chunk=512,
                 prefill_floor=128, decode_horizon=8, max_queue=256,
                 rng_seed=0, prefix_share=True, kv_cache_dtype="",
                 preempt="swap", draft_model=None, draft_variables=None,
                 speculative_tokens=0, role="both", handoff_fn=None,
                 device="cuda"):
        role = str(role or "both")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                "role must be 'both', 'prefill' or 'decode', got "
                "{!r}".format(role))
        self.role = role
        self.handoff_fn = handoff_fn
        preempt = str(preempt or "off")
        if preempt not in ("swap", "recompute", "off"):
            raise ValueError(
                "preempt must be 'swap', 'recompute' or 'off', got "
                "{!r}".format(preempt))
        self.preempt = preempt
        self.decode_horizon = max(1, int(decode_horizon))
        self.speculative_tokens = max(0, int(speculative_tokens))
        if self.speculative_tokens and draft_model is None:
            raise ValueError(
                "speculative_tokens > 0 requires a draft_model")
        if draft_model is not None and draft_variables is None:
            raise ValueError("draft_model requires draft_variables")
        # A decode call runs every row the full horizon, so a row ending
        # mid-call writes up to horizon - 1 junk slots past its budget; a
        # verify writes k positions past the row's extent. The reservation
        # (and the table row) covers the larger: the same junk-past-budget
        # slots, so the max, not the sum.
        slack = max(self.decode_horizon - 1, self.speculative_tokens)
        self.device = device_info.resolve_device(device)
        model.to(self.device)
        cfg = model.cfg
        max_model_len = int(min(
            max_model_len or cfg.max_seq_len, cfg.max_seq_len))
        if self.speculative_tokens:
            dcfg = draft_model.cfg
            if int(dcfg.vocab_size) != int(cfg.vocab_size):
                raise ValueError(
                    "draft vocab ({}) must match the target's ({}) — "
                    "speculative acceptance compares token ids".format(
                        dcfg.vocab_size, cfg.vocab_size))
            if int(dcfg.max_seq_len) < max_model_len:
                raise ValueError(
                    "draft max_seq_len ({}) must cover max_model_len "
                    "({})".format(dcfg.max_seq_len, max_model_len))
        kv_cache_dtype = str(kv_cache_dtype or "")
        if kv_cache_dtype in ("fp", "auto"):
            kv_cache_dtype = ""
        if kv_cache_dtype not in ("", "int8"):
            raise ValueError(
                "kv_cache_dtype must be '', 'fp', 'auto' or 'int8', "
                "got {!r}".format(kv_cache_dtype))
        self.kv_cache_dtype = kv_cache_dtype
        if num_pages is None:
            num_pages = 1 + int(max_slots) * PagePool.pages_needed(
                max_model_len + slack, page_size)
        self.pool = PagePool(num_pages, page_size)
        self.scheduler = Scheduler(self.pool, max_slots,
                                   reserve_slack=slack,
                                   prefix_share=bool(prefix_share))
        self.runner = ModelRunner(
            model, variables, max_slots=max_slots, page_size=page_size,
            num_pages=num_pages, max_model_len=max_model_len,
            prefill_chunk=prefill_chunk, prefill_floor=prefill_floor,
            extra_table_tokens=slack, kv_quant=kv_cache_dtype,
            rng_seed=rng_seed)
        self.pool.page_bytes = self.runner.pool_bytes // num_pages
        self.draft_runner = None
        self._draft_table = None
        if self.speculative_tokens:
            # The draft's pool skips the allocator: slot s owns pages [1 +
            # s*tw, 1 + (s+1)*tw) for good (page 0 stays the trash page),
            # since draft extents mirror the target's and the target pool
            # already applies the backpressure.
            tw = self.runner.table_width
            draft_model.to(self.device)
            self.draft_runner = ModelRunner(
                draft_model, draft_variables, max_slots=max_slots,
                page_size=page_size, num_pages=1 + int(max_slots) * tw,
                max_model_len=max_model_len, prefill_chunk=prefill_chunk,
                prefill_floor=prefill_floor, extra_table_tokens=slack,
                kv_quant=kv_cache_dtype, rng_seed=rng_seed)
            self._draft_table = (
                1 + np.arange(int(max_slots))[:, None] * tw
                + np.arange(tw)[None, :]).astype(np.int32)
        self.vocab_size = int(cfg.vocab_size)
        self.num_layers = int(cfg.num_layers)
        self.max_slots = int(max_slots)
        self.max_model_len = max_model_len
        self.max_queue = int(max_queue)
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._prefill_req = None
        self._cancels = []
        self._toks = np.zeros((self.max_slots,), np.int32)
        self._lens = np.zeros((self.max_slots,), np.int32)
        self._temps = np.zeros((self.max_slots,), np.float32)
        self._top_ks = np.zeros((self.max_slots,), np.int32)
        self._top_ps = np.zeros((self.max_slots,), np.float32)
        self._table = np.zeros(
            (self.max_slots, self.runner.table_width), np.int32)
        # Per-slot draft freshness: False when the draft's pages do not
        # mirror the target's extent (a fresh join, a resume, or a normal
        # decode call that advanced the target alone); the next round
        # rebuilds them by replay before drafting.
        self._draft_ok = np.zeros((self.max_slots,), bool)
        self._host_rng = np.random.default_rng(int(rng_seed))
        self._thread = None
        self._stop = threading.Event()
        self.decode_steps = 0       # decode calls (horizon steps each)
        self.decode_tokens = 0      # tokens those calls emitted
        self.decode_seconds = 0.0   # host time of decode calls (synced)
        self.prefill_seconds = 0.0  # host time of prefill chunks
        self.prefix_hits = 0
        self.prefix_tokens_shared = 0   # prefill tokens skipped via sharing
        self.preempt_swaps = 0          # victims swapped to host memory
        self.preempt_recomputes = 0     # victims dropped for prefill replay
        self.spec_rounds = 0            # speculative rounds run
        self.spec_drafted = 0           # draft tokens proposed
        self.spec_accepted = 0          # draft tokens the target accepted
        self.requests_finished = 0
        self.requests_cancelled = 0
        self.requests_failed = 0
        self.tokens_generated = 0
        self.peak_active = 0
        self._ttft = collections.deque(maxlen=_LATENCY_WINDOW)
        self._e2e = collections.deque(maxlen=_LATENCY_WINDOW)
        # Drain: a draining engine refuses NEW admissions but keeps
        # stepping what it accepted. The ledger invariant once drained:
        # accepted + migrated_in == finished + cancelled + failed +
        # migrated_out.
        self.draining = False
        self.requests_accepted = 0
        self.migrated_out = 0
        self.migrated_in = 0
        # Disaggregation: page-migration hops out/in (each also counts in
        # migrated_out/migrated_in, so the invariant holds across
        # handoffs), colocated-replay fallbacks and payload bytes sent.
        # Requests between this engine and a peer belong to neither
        # scheduler; the idle and drained checks count them here.
        self.handoffs_out = 0
        self.handoffs_in = 0
        self.handoff_fallbacks = 0
        self.handoff_bytes = 0
        self._handoffs_inflight = 0
        with _live_lock:
            _live_engines[id(self)] = self
        self._registered = True
        _publish_gauges()

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens, temperature=0.0,
               eos_token=None, top_k=0, top_p=0.0, priority=0,
               _prefix_keys=None, _trace=None):
        """Queue one generation request; returns a :class:`RequestHandle`
        streaming its tokens. ``top_k``/``top_p`` filter temperature
        sampling per request (ignored for greedy rows); ``priority``
        (higher first) orders admission and lets the request preempt a
        strictly lower-priority resident (``preempt=`` mode).
        ``_prefix_keys`` (the fleet router) pre-sets the prompt's chain
        keys its affinity probe already hashed; ``_trace`` adopts an
        upstream trace id. Raises ValueError for a request that can never
        run and :class:`QueueFull` past ``max_queue`` or while
        draining."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + int(max_new_tokens) > self.max_model_len:
            raise ValueError(
                "prompt ({}) + max_new_tokens ({}) exceeds max_model_len "
                "({})".format(prompt.size, max_new_tokens,
                              self.max_model_len))
        if prompt.min() < 0 or prompt.max() >= self.vocab_size:
            raise ValueError("prompt token ids must be in [0, {})".format(
                self.vocab_size))
        top_k = int(top_k or 0)
        if top_k < 0:
            raise ValueError("top_k must be >= 0")
        if top_k >= self.vocab_size:
            top_k = 0  # no-op filter; canonicalize (decoding.generate)
        top_p = float(top_p or 0.0)
        if top_p and not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if top_p >= 1.0:
            top_p = 0.0  # the whole nucleus — a no-op filter
        req = Request(prompt, max_new_tokens, temperature=temperature,
                      eos_token=eos_token, top_k=top_k, top_p=top_p,
                      priority=priority, trace=_trace)
        if _prefix_keys is not None and self.scheduler.prefix_share:
            req.prefix_keys = list(_prefix_keys)
        handle = RequestHandle(self, req)
        req.handle = handle
        with self._work:
            if self.draining:
                # QueueFull is what the fleet router fails over on, so
                # traffic slides to the other engines unseen by callers.
                raise QueueFull("engine is draining")
            if self.scheduler.queued() >= self.max_queue:
                raise QueueFull(
                    "admission queue is full ({} requests)".format(
                        self.max_queue))
            self.scheduler.submit(req)  # may raise ValueError (never fits)
            self.requests_accepted += 1
            self._register()
            telemetry.inc("serve_requests_total")
            self._publish()
            self._work.notify_all()
        return handle

    def _register(self):
        """Count in the process gauges again: ``close()`` only stops the
        loop, and an engine taking new work (inline ``step()`` callers) is
        live. Flag-gated, so a steady submit never takes the registry
        lock."""
        if not self._registered:
            with _live_lock:
                _live_engines[id(self)] = self
            self._registered = True

    def _cancel(self, req):
        with self._work:
            if req.state in sched_mod.TERMINAL:
                return
            req.cancel_requested = True
            self._cancels.append(req)
            self._work.notify_all()

    # -- the scheduling step -------------------------------------------------

    def step(self):
        """One engine iteration: cancellations, prefill, one decode step.
        Returns True when any work was done."""
        with self._lock:
            did = self._process_cancels()
            did = self._prefill_phase() or did
            did = self._decode_once() or did
            return did

    def _prefill_phase(self):
        """While the decode batch is EMPTY, keep admitting and prefilling
        until the slots (or the pool) fill; once rows are decoding, at
        most one admission advances per step."""
        ramp = not any(r is not None and r.state == RUNNING
                       for r in self.scheduler.slots)
        did = False
        while True:
            stepped = self._advance_prefill()
            did = stepped or did
            if not stepped:
                return did
            if self._prefill_req is not None:
                # Mid-prompt: let decode run between chunks.
                return did
            if not ramp:
                return did

    def busy(self):
        """True while anything is queued, resident, waiting to be
        cancelled, or handed off with its outcome not yet known (a
        refused handoff comes back here)."""
        return bool(self.scheduler.has_work() or self._cancels
                    or self._handoffs_inflight)

    def run_until_idle(self, timeout=300.0):
        """Drive ``step()`` inline until no request is queued or active
        and no handoff is in flight."""
        deadline = time.monotonic() + timeout
        while self.busy():
            if not self.step():
                time.sleep(0.001)  # only a handoff thread is working
            if time.monotonic() > deadline:
                raise TimeoutError("serving engine did not drain in "
                                   "{}s".format(timeout))

    def _process_cancels(self):
        did = False
        while self._cancels:
            req = self._cancels.pop()
            if req.state in sched_mod.TERMINAL:
                continue
            if req.state in (sched_mod.QUEUED, PREEMPTED):
                # A preempted request lives in the waiting queue too; a
                # cancel mid-swap pulls it out before release drops its
                # host copy — nothing survives, device or host.
                self.scheduler.drop_queued(req)
            if req is self._prefill_req:
                self._prefill_req = None
            self._finish(req, CANCELLED)
            did = True
        return did

    def _advance_prefill(self):
        """Admit (when idle) and advance the in-flight prefill by one
        chunk; on the final chunk, scatter to pages and join the decode
        batch with the first sampled token. A blocked admission may
        preempt one victim per call; a preempted request re-admits here
        too — swap mode restores its host page copy and rejoins directly,
        recompute mode replays prompt + generated through the chunk flow
        below (no first token is re-sampled either way: the pending
        decode input is its newest generated token)."""
        if self._prefill_req is None:
            admitted = self.scheduler.next_admission()
            if admitted is None:
                return self._maybe_preempt()
            if admitted.preempt_count and admitted.t_preempt is not None:
                telemetry.record_span(
                    "serve/preempt_wait",
                    admitted.t_admit - admitted.t_preempt,
                    request=admitted.id, trace=admitted.trace)
            else:
                telemetry.record_span(
                    "serve/queue_wait",
                    admitted.t_admit - admitted.t_submit,
                    request=admitted.id, trace=admitted.trace)
            self._publish()
            if admitted.swap_pages is not None:
                self._swap_in(admitted)
                return True
            if admitted.generated and admitted.prefix_len >= \
                    admitted.cache_len:
                # Recompute resume whose whole cached extent re-matched
                # the prefix index: nothing to replay, rejoin directly.
                self._rejoin(admitted)
                return True
            self._prefill_req = admitted
        t0 = time.perf_counter()
        try:
            return self._prefill_chunk(self._prefill_req)
        finally:
            self.prefill_seconds += time.perf_counter() - t0

    def _prefill_chunk(self, req):
        runner = self.runner
        if req.prefill_cache is None and req.generated:
            # Recompute resume: the "prompt" this prefill rebuilds is
            # every token whose K/V the cache held at preemption.
            req.replay = req.replay_tokens()
        src = req.replay if req.replay is not None else req.prompt
        p = int(src.shape[0])
        if req.prefill_cache is None:
            req.prefill_alloc = runner.prefill_alloc(p)
            req.prefill_started = time.perf_counter()
            if req.cow_src is not None:
                # Copy-on-write, device half: the reservation's page
                # ``shared_pages`` is a fresh private page standing in for
                # the shared one the tail token overwrites — fill it with
                # that page's content, then drop the retained source
                # reference (kept alive across the admission->copy
                # window).
                runner.copy_pages([req.cow_src],
                                  [req.pages[req.shared_pages]])
                self.pool.free([req.cow_src])
                req.cow_src = None
            if req.prefix_len > 0:
                # Prefix sharing: the retained pages (and the COW copy)
                # already hold positions [0, prefix_len) — gather them
                # into the private cache and prefill only the tail.
                req.prefill_start = req.prefix_len
                req.prefill_pos = req.prefix_len
                req.prefill_cache = runner.gather_prefix(
                    req.pages, req.prefix_len, req.prefill_alloc)
                self.prefix_hits += 1
                self.prefix_tokens_shared += req.prefix_len
            else:
                req.prefill_start = 0
                req.prefill_cache = runner.new_prefill_cache(
                    req.prefill_alloc)
        alloc = req.prefill_alloc
        start = req.prefill_pos
        if req.prefill_start and start >= p - 1:
            # COW tail: re-run ONLY the prompt's last token (a whole-
            # prompt prefix match; everything else is pool-resident).
            chunk_len = 1
        else:
            chunk_len = min(alloc, runner.prefill_chunk)
            if start:
                # A shared-prefix tail starts mid-cache: the chunk must
                # fit the remaining allocation.
                chunk_len = min(chunk_len, alloc - start)
        tokens = np.zeros((1, chunk_len), np.int32)
        real = min(chunk_len, p - start)
        tokens[0, :real] = src[start:start + real]
        is_last = start + chunk_len >= p
        last_idx = (p - 1 - start) if is_last else 0
        t_chunk = time.perf_counter()
        req.prefill_cache, last_logits = runner.prefill_step(
            req.prefill_cache, tokens, last_idx, alloc)
        telemetry.record_span(
            "serve/prefill_chunk", time.perf_counter() - t_chunk,
            request=req.id, trace=req.trace,
            chunk=start // chunk_len, tokens=real)
        req.prefill_pos = start + chunk_len
        if not is_last:
            return True
        resuming = req.replay is not None
        # Prefill complete: first token from the prompt's last logits
        # (fresh requests only — a resume's pending input is its newest
        # generated token), K/V into this request's pages, join the
        # decode batch.
        if not resuming:
            first = self._sample_host(last_logits.cpu().numpy(),
                                      req.temperature, req.top_k, req.top_p)
        telemetry.record_span(
            "serve/prefill", time.perf_counter() - req.prefill_started,
            request=req.id, trace=req.trace, prompt=p, alloc=alloc,
            shared=req.prefill_start,
            chunks=-(-(p - req.prefill_start) // chunk_len))
        runner.scatter(req.prefill_cache, req.pages, p, alloc,
                       start=req.prefill_start)
        # Publish this prompt's own full pages in the prefix index so
        # later arrivals can share them (first writer wins). Pages filled
        # by DECODE tokens never register: a replay's keys still cover
        # only full PROMPT pages.
        for j in range(req.shared_pages, len(req.prefix_keys)):
            self.pool.register_prefix(req.prefix_keys[j], req.pages[j])
        req.prefill_cache = None
        req.replay = None
        self._prefill_req = None
        if resuming:
            self._rejoin(req)
            return True
        self._set_row(req)
        req.state = RUNNING
        req.t_first = time.perf_counter()
        self._ttft.append(req.t_first - req.t_submit)
        telemetry.observe("serve_ttft_seconds", req.t_first - req.t_submit,
                          exemplar={"trace": req.trace, "request": req.id})
        self._emit_token(req, first)
        if req.state == RUNNING:  # not finished by eos/budget already
            self._toks[req.slot] = req.generated[-1]
            self._lens[req.slot] = req.cache_len
            self._publish()
            if self.role == "prefill" and self.handoff_fn is not None \
                    and not req.cancel_requested:
                # The request is in the swap-preemptable state (the cache
                # holds the prompt, the pending input is the first token,
                # already emitted): hand its pages to the decode pool
                # instead of decoding here.
                self._begin_handoff(req)
        return True

    def _set_row(self, req):
        slot = req.slot
        row = np.zeros((self.runner.table_width,), np.int32)
        row[:len(req.pages)] = req.pages
        self._table[slot] = row
        self._temps[slot] = req.temperature
        self._top_ks[slot] = req.top_k
        self._top_ps[slot] = req.top_p

    # -- preemption ----------------------------------------------------------

    def _maybe_preempt(self):
        """One preemption attempt for the blocked best-waiting request:
        pick the victim (strictly lower priority; lowest class first,
        newest within it), swap its cached pages to host memory (or drop
        them for prefill replay) and release everything through the
        scheduler's choke point. One victim per engine step, so a
        multi-victim reservation converges while decode keeps running.
        Returns True when a victim was evicted."""
        if self.preempt == "off":
            return False
        best = self.scheduler.best_waiting()
        if best is None:
            return False
        victim = self.scheduler.preemption_victim(best.priority)
        if victim is None:
            return False
        swap = (self.preempt == "swap" and victim.state == RUNNING
                and bool(victim.generated))
        if swap:
            # Host copy of every page with real content — the cached
            # extent, int8 bytes and scales included — taken BEFORE
            # release, while the pages are still this request's.
            n = self.pool.required(victim.cache_len)
            victim.swap_pages = self.runner.extract_pages(victim.pages[:n])
            victim.swap_count = n
        if victim is self._prefill_req:
            self._prefill_req = None
        if not self.scheduler.release(victim, PREEMPTED):
            victim.swap_pages = None  # raced a terminal transition
            victim.swap_count = 0
            return False
        if swap:
            self.preempt_swaps += 1
        else:
            self.preempt_recomputes += 1
        self._clear_free_slots()
        telemetry.inc("serve_preemptions_total")
        telemetry.event(
            "serve/preempt", request=victim.id, trace=victim.trace,
            mode="swap" if swap else "recompute", priority=victim.priority,
            preemptor=best.id, tokens=len(victim.generated))
        self._publish()
        return True

    def _swap_in(self, req):
        """Swap-mode resume: restore the host page copy byte-exact into
        the fresh (private) reservation and rejoin the decode batch — no
        prefill, no re-sampled token."""
        self.runner.restore_pages(req.swap_pages,
                                  req.pages[:req.swap_count])
        req.swap_pages = None
        req.swap_count = 0
        # The restored leading pages hold the prompt's full pages byte for
        # byte: publish their chain keys (a no-op where the original
        # entries survive — first writer wins). Decode writes only
        # positions >= cache_len, past every full prompt page, so the
        # registered content stays immutable.
        # On a decode engine that never prefilled this prompt (a handoff
        # or a migration), later identical prompts now share these pages.
        if self.scheduler.prefix_share:
            for key, page in zip(req.prefix_keys, req.pages):
                self.pool.register_prefix(key, page)
        self._rejoin(req)

    def _rejoin(self, req):
        """Put a resumed request back in the decode batch: its cache again
        holds prompt + generated[:-1] and the pending input is its newest
        generated token — the state it was preempted in, so the continued
        greedy stream is the uninterrupted one."""
        self._set_row(req)
        req.state = RUNNING
        self._toks[req.slot] = req.generated[-1]
        self._lens[req.slot] = req.cache_len
        if req.t_preempt is not None:
            telemetry.observe("serve_preempt_resume_seconds",
                              time.perf_counter() - req.t_preempt,
                              exemplar={"trace": req.trace,
                                        "request": req.id})
        self._publish()

    # -- graceful drain ------------------------------------------------------

    def begin_drain(self):
        """Stop admitting new requests; everything already accepted keeps
        running (``submit`` raises :class:`QueueFull`, so a fleet router
        fails the traffic over). Idempotent. The engine is drained once
        :meth:`is_drained`: let decode finish, or hand the residents to a
        peer with :meth:`migrate_requests`."""
        with self._work:
            already = self.draining
            self.draining = True
            self._work.notify_all()
        if not already:
            telemetry.event("cluster/drain", engine=id(self) % 10000,
                            active=len(self.scheduler.active()),
                            queued=self.scheduler.queued())

    def end_drain(self):
        """Reopen admission (a cancelled scale-down)."""
        with self._work:
            self.draining = False
            self._work.notify_all()

    def is_drained(self):
        """True when a draining engine holds no work at all: nothing
        queued, resident, pending cancellation or in flight to a peer."""
        with self._lock:
            return self.draining and not self.busy()

    def migrate_requests(self, dest):
        """Hand every resident and queued request to ``dest`` instead of
        waiting for decode to finish — the fast half of a graceful drain.
        A RUNNING resident rides the preemption machinery: its cached
        pages are extracted to host memory, it is released as PREEMPTED,
        and ``dest``'s next admission restores the copy byte for byte
        into a private reservation and rejoins it, so its greedy stream
        continues bitwise. PREFILL residents and queued requests move with
        fresh-admission semantics (their prefill restarts on ``dest``).
        Requests with a cancellation pending stay for this engine's cancel
        processing. Handles are repointed, so ``handle.cancel()`` reaches
        the new owner. Returns the moved requests.

        ``dest`` must serve the same model; where its page size or KV
        dtype differ, a RUNNING resident falls back to recompute (pages
        dropped, prompt + generated re-prefilled on ``dest``)."""
        if dest is self:
            raise ValueError("cannot migrate an engine onto itself")
        same_pages = (dest.pool.page_size == self.pool.page_size
                      and dest.kv_cache_dtype == self.kv_cache_dtype)
        moved = []
        with self._lock:
            for req in list(self.scheduler.active()):
                if req.state not in (PREFILL, RUNNING) \
                        or req.cancel_requested:
                    continue
                if req is self._prefill_req:
                    self._prefill_req = None
                mode = "recompute"
                if same_pages and req.state == RUNNING and req.generated:
                    n = self.pool.required(req.cache_len)
                    req.swap_pages = self.runner.extract_pages(
                        req.pages[:n])
                    req.swap_count = n
                    mode = "swap"
                if not self.scheduler.release(req, PREEMPTED):
                    req.swap_pages = None
                    req.swap_count = 0
                    continue
                # release() re-enqueued it here; it belongs to dest now.
                self.scheduler.drop_queued(req)
                moved.append((req, mode))
            for req in list(self.scheduler.waiting):
                if req.cancel_requested:
                    continue
                if self.scheduler.drop_queued(req):
                    moved.append((req, "queued"))
            self._clear_free_slots()
        out = []
        for req, mode in moved:
            if dest.pool.page_size != self.pool.page_size:
                # Chain keys hash full pages: recompute them for dest's
                # geometry (its scheduler.submit refills them).
                req.prefix_keys = []
            with dest._work:
                dest.scheduler.submit(req)
                if req.handle is not None:
                    req.handle._engine = dest
                dest.migrated_in += 1
                dest._register()
                dest._work.notify_all()
            with self._lock:   # a handoff thread updates it too
                self.migrated_out += 1
            telemetry.inc("serve_migrations_total")
            telemetry.event("serve/migrate", request=req.id,
                            trace=req.trace, mode=mode,
                            tokens=len(req.generated))
            out.append(req)
        if out:
            self._publish()
            dest._publish()
        return out

    # -- disaggregated prefill/decode handoff --------------------------------

    def _handoff_meta(self, req):
        """The wire header of one handoff: what the decode engine needs to
        rebuild the request (sampling settings, the stream so far with the
        first token, page geometry for the mismatch check, chain keys so
        prefix sharing composes on the far side). Called after the
        PREEMPTED release, so ``t_preempt`` is stamped. ``perf_counter``
        stamps are process-local: the header ships AGES plus one wall
        stamp, and the far side rebases them into its own clock (transit
        included), so TTFT and end-to-end times stay true across the
        hop."""
        now = time.perf_counter()
        meta = {
            "version": HANDOFF_WIRE_VERSION,
            "request": req.id,
            "trace": req.trace,
            "prompt": np.asarray(req.prompt).reshape(-1).tolist(),
            "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature,
            "top_k": req.top_k,
            "top_p": req.top_p,
            "eos_token": req.eos_token,
            "priority": req.priority,
            "generated": [int(t) for t in req.generated],
            "page_size": self.pool.page_size,
            "kv_cache_dtype": self.kv_cache_dtype,
            "pages": int(req.swap_count),
            "prefix_keys": [k.hex() for k in (req.prefix_keys or [])],
            "preempt_count": req.preempt_count,
            "wall": time.time(),
            "age_submit": now - req.t_submit,
            "age_preempt": now - req.t_preempt,
        }
        if req.t_first is not None:
            meta["age_first"] = now - req.t_first
        return meta

    def _begin_handoff(self, req):
        """Start the hop for a just-joined request (under the engine lock):
        copy its pages to host memory, release it through the scheduler,
        encode the payload, and run the transfer on a daemon thread, so
        the next prompt's prefill never waits on the wire."""
        n = self.pool.required(req.cache_len)
        req.swap_pages = self.runner.extract_pages(req.pages[:n])
        req.swap_count = n
        if not self.scheduler.release(req, PREEMPTED):
            req.swap_pages = None   # raced a terminal transition
            req.swap_count = 0
            return
        # release() re-enqueued it here; it belongs to the decode pool now
        # (or comes back through _run_handoff's fallback).
        self.scheduler.drop_queued(req)
        self._clear_free_slots()
        payload = encode_handoff(self._handoff_meta(req), req.swap_pages)
        if req.handle is not None:
            req.handle._engine = _HANDOFF_PENDING
        self.handoff_bytes += len(payload)
        self._handoffs_inflight += 1
        telemetry.inc("serve_handoffs_total")
        telemetry.event("serve/handoff", request=req.id, trace=req.trace,
                        tokens=len(req.generated), pages=n,
                        bytes=len(payload))
        self._publish()
        threading.Thread(target=self._run_handoff, args=(req, payload),
                         name="serve-handoff", daemon=True).start()

    def _run_handoff(self, req, payload):
        """The hop, off the engine lock: ``handoff_fn(req, payload)``
        returns True when the destination admitted the request and took
        its handle. Refusal or failure falls back to colocated replay: the
        request is resubmitted HERE with its host copy intact, and the
        swap-in path rejoins it into this engine's own decode batch. A
        cancel that landed while it was in flight (the pending window)
        is settled here: nothing was delivered."""
        ok = False
        t0 = time.perf_counter()
        try:
            with telemetry.span(
                    "serve/kv_transfer", trace=req.trace, request=req.id,
                    bytes=len(payload), pages=req.swap_count,
                    tokens=len(req.generated)):
                if not req.cancel_requested:
                    ok = bool(self.handoff_fn(req, payload))
        except Exception:
            logger.warning("handoff of request %s failed; resuming "
                           "locally", req.id, exc_info=True)
            ok = False
        telemetry.observe("serve_kv_transfer_seconds",
                          time.perf_counter() - t0,
                          exemplar={"trace": req.trace, "request": req.id})
        with self._work:
            self._handoffs_inflight -= 1
            self._work.notify_all()
            if ok:
                # The decode engine owns it (handoff_fn repointed the
                # handle); the swap copy travelled in the payload.
                self.handoffs_out += 1
                self.migrated_out += 1
                telemetry.inc("serve_migrations_total")
                self._publish()
                return
            if req.state in sched_mod.TERMINAL:
                return
            if req.cancel_requested:
                # Cancelled in flight, never delivered: terminal here. The
                # scheduler released pages and slot at the handoff; only
                # the host copy and the stream remain.
                req.swap_pages = None
                req.swap_count = 0
                req.state = CANCELLED
                req.t_done = time.perf_counter()
                self.requests_cancelled += 1
                telemetry.inc("serve_cancelled_total")
                if req.handle is not None:
                    req.handle._engine = self
                    req.handle._events.put(("done", CANCELLED))
                self._publish()
                return
            self.handoff_fallbacks += 1
            telemetry.inc("serve_handoff_fallbacks_total")
            telemetry.event("serve/handoff_fallback", request=req.id,
                            trace=req.trace, tokens=len(req.generated))
            if req.handle is not None:
                req.handle._engine = self
            self.scheduler.submit(req)
            self._publish()

    def inject_handoff(self, payload, req=None):
        """Decode-side entry of a handoff: admit a prefill engine's
        :func:`~tensorflowonspark_tpu_torch.serving.runner.encode_handoff`
        payload into this engine. The payload is decoded HERE on every
        hop, in process too, so the codec's byte-exactness is exercised,
        never assumed. With ``req`` (a same-process hop) the original
        Request, and with it the caller's live handle, is adopted; without
        it (``POST /v1/migrate``) a new Request and handle are built and
        the shipped ages rebased into this process's clock. The next
        admission allocates private pages, restores the copy byte for byte
        and rejoins. Returns the handle. Raises :class:`QueueFull`
        (draining, queue cap) or ValueError (page size or KV dtype
        mismatch, cancelled in flight): the sender then replays the
        request itself."""
        meta, tree = decode_handoff(payload)
        if int(meta.get("version", 0)) != HANDOFF_WIRE_VERSION:
            raise ValueError("unknown handoff wire version: {!r}".format(
                meta.get("version")))
        if int(meta["page_size"]) != self.pool.page_size \
                or str(meta.get("kv_cache_dtype") or "") \
                != self.kv_cache_dtype:
            raise ValueError(
                "handoff geometry mismatch: sender page_size={} "
                "kv_cache_dtype={!r}, this engine page_size={} "
                "kv_cache_dtype={!r}".format(
                    meta["page_size"], meta.get("kv_cache_dtype") or "",
                    self.pool.page_size, self.kv_cache_dtype))
        prompt = np.asarray(meta["prompt"], np.int32).reshape(-1)
        if prompt.size + int(meta["max_new_tokens"]) > self.max_model_len:
            raise ValueError(
                "handoff exceeds max_model_len ({}): prompt {} + "
                "max_new_tokens {}".format(
                    self.max_model_len, prompt.size,
                    meta["max_new_tokens"]))
        if req is None:
            req = Request(prompt, int(meta["max_new_tokens"]),
                          temperature=float(meta.get("temperature", 0.0)),
                          eos_token=meta.get("eos_token"),
                          top_k=int(meta.get("top_k", 0)),
                          top_p=float(meta.get("top_p", 0.0)),
                          priority=int(meta.get("priority", 0)),
                          trace=meta.get("trace"))
            req.generated = [int(t) for t in meta.get("generated", [])]
            req.state = PREEMPTED
            req.preempt_count = max(1, int(meta.get("preempt_count", 1)))
            now = time.perf_counter()
            transit = max(0.0, time.time()
                          - float(meta.get("wall") or time.time()))
            req.t_submit = now - (float(meta.get("age_submit", 0.0))
                                  + transit)
            req.t_preempt = now - (float(meta.get("age_preempt", 0.0))
                                   + transit)
            if meta.get("age_first") is not None:
                req.t_first = now - (float(meta["age_first"]) + transit)
            req.handle = RequestHandle(self, req)
        if self.scheduler.prefix_share:
            req.prefix_keys = [bytes.fromhex(str(k)) for k in
                               (meta.get("prefix_keys") or [])]
        req.swap_pages = tree
        req.swap_count = int(meta["pages"])
        with self._work:
            if req.cancel_requested:
                raise ValueError("request was cancelled in flight")
            if self.draining:
                raise QueueFull("engine is draining")
            if self.scheduler.queued() >= self.max_queue:
                raise QueueFull(
                    "admission queue is full ({} requests)".format(
                        self.max_queue))
            self.scheduler.submit(req)
            if req.handle is not None:
                req.handle._engine = self
            self.migrated_in += 1
            self.handoffs_in += 1
            self._register()
            self._publish()
            self._work.notify_all()
        return req.handle

    # -- decode --------------------------------------------------------------

    def _decode_once(self):
        running = [r for r in self.scheduler.slots
                   if r is not None and r.state == RUNNING]
        if not running:
            return False
        if self.speculative_tokens and all(
                r.temperature <= 0.0 for r in running):
            return self._speculative_round(running)
        if self.speculative_tokens:
            # Mixed batch: normal decode advances the target alone, so
            # every running row's draft goes stale; replay rebuilds it when
            # the batch turns all-greedy again.
            for req in running:
                self._draft_ok[req.slot] = False
        # Always the full horizon: a row that finishes mid-call decodes
        # junk into its reserved slack instead of throttling every other
        # row to the smallest remaining budget.
        horizon = self.decode_horizon
        self.decode_steps += 1
        sampling = any(r.temperature > 0.0 for r in running)
        t0 = time.perf_counter()
        out = self.runner.decode(
            self._toks, self._table, self._lens, self._temps,
            self._top_ks, self._top_ps, horizon=horizon, sampling=sampling,
            filtered=sampling and any(
                r.temperature > 0.0 and (r.top_k or r.top_p)
                for r in running))
        # decode() returns host values, so the call has finished here.
        step_dur = time.perf_counter() - t0
        self.decode_seconds += step_dur
        telemetry.observe("serve_step_seconds", step_dur)
        telemetry.record_span("serve/decode_batch", step_dur,
                              slots=len(running), horizon=horizon)
        for req in running:
            row = out[req.slot]
            for j in range(horizon):
                self._emit_token(req, int(row[j]))
                self.decode_tokens += 1
                if req.state != RUNNING:
                    break
            if req.state == RUNNING:
                self._toks[req.slot] = req.generated[-1]
                self._lens[req.slot] = req.cache_len
        return True

    # -- speculative decoding ------------------------------------------------

    def _speculative_round(self, running):
        """One speculative round over an all-greedy batch: the draft
        proposes ``k`` tokens a row, the target verifies all of them in one
        forward, and each row emits its longest matched prefix plus the
        target's correction token. Every emitted token is the TARGET's
        greedy argmax, so the stream is solo ``generate()``'s whatever the
        draft proposed.

        On full acceptance only ``k`` tokens are emitted, not the bonus
        k+1-th the verify already names: it would advance the target's
        extent past the draft's (the draft never wrote that token's K/V).
        Capped at ``k``, both extents stay in lockstep: the k-th proposal
        becomes the next round's input, its K/V rewritten with the same
        values."""
        k = self.speculative_tokens
        t0 = time.perf_counter()
        for req in running:
            if not self._draft_ok[req.slot]:
                self._draft_prefill(req)
        t_draft = time.perf_counter()
        props = self.draft_runner.decode(
            self._toks, self._draft_table, self._lens, self._temps,
            self._top_ks, self._top_ps, horizon=k, sampling=False)
        telemetry.record_span(
            "serve/draft", time.perf_counter() - t_draft,
            slots=len(running), tokens=k)
        # Column 0 is each row's pending input (its newest token, K/V not
        # yet pooled: a decode step's contract), columns 1..k the
        # proposals; the verify writes all k+1 positions.
        verify_toks = np.zeros((self.max_slots, k + 1), np.int32)
        verify_toks[:, 0] = self._toks
        verify_toks[:, 1:] = props
        t_verify = time.perf_counter()
        greedy = self.runner.verify(verify_toks, self._table, self._lens)
        telemetry.record_span(
            "serve/verify", time.perf_counter() - t_verify,
            slots=len(running), tokens=k + 1)
        accepted, emitted = decoding.speculative_lengths(props, greedy)
        self.spec_rounds += 1
        for req in running:
            slot = req.slot
            a, e = int(accepted[slot]), int(emitted[slot])
            self.spec_drafted += k
            self.spec_accepted += a
            telemetry.observe("serve_spec_accepted_tokens", float(a))
            for j in range(e):
                self._emit_token(req, int(greedy[slot, j]))
                if req.state != RUNNING:
                    break
            if req.state == RUNNING:
                # The extent rollback is this bookkeeping alone: the verify
                # wrote k+1 positions, the length covers the emitted
                # prefix, and the rejected tail stays in the pages unread.
                self._toks[slot] = req.generated[-1]
                self._lens[slot] = req.cache_len
        step_dur = time.perf_counter() - t0
        telemetry.observe("serve_step_seconds", step_dur)
        telemetry.record_span(
            "serve/decode_batch", step_dur, slots=len(running),
            horizon=k + 1, mode="speculative")
        return True

    def _draft_prefill(self, req):
        """(Re)build one row's draft pages by replaying every token the
        target's cache holds (``replay_tokens``: prompt + generated minus
        the pending input) through the draft's chunked prefill, then
        scattering into the slot's fixed draft pages. Inline: the batch
        waits for it, once per join or resume and after a mixed-batch
        fallback, never in the speculative steady state."""
        runner = self.draft_runner
        src = np.asarray(req.replay_tokens(), np.int32).reshape(-1)
        p = int(src.shape[0])
        t0 = time.perf_counter()
        alloc = runner.prefill_alloc(p)
        cache = runner.new_prefill_cache(alloc)
        start = 0
        while start < p:
            chunk_len = min(alloc, runner.prefill_chunk)
            if start:
                chunk_len = min(chunk_len, alloc - start)
            tokens = np.zeros((1, chunk_len), np.int32)
            real = min(chunk_len, p - start)
            tokens[0, :real] = src[start:start + real]
            cache, _ = runner.prefill_step(cache, tokens, 0, alloc)
            start += chunk_len
        runner.scatter(cache, self._draft_table[req.slot], p, alloc)
        self._draft_ok[req.slot] = True
        telemetry.record_span(
            "serve/draft_prefill", time.perf_counter() - t0,
            request=req.id, trace=req.trace, tokens=p, slot=req.slot)

    # -- transitions ---------------------------------------------------------

    def _emit_token(self, req, token):
        req.generated.append(token)
        self.tokens_generated += 1
        telemetry.inc("serve_tokens_total")
        if req.handle is not None:
            req.handle._events.put(("token", token))
        hit_eos = req.eos_token is not None and token == req.eos_token
        if hit_eos or req.remaining <= 0:
            self._finish(req, FINISHED)

    def _clear_free_slots(self):
        """Zero freed rows in the shared step arrays: released slots
        decode into the trash page until a new request takes them."""
        for slot, holder in enumerate(self.scheduler.slots):
            if holder is None:
                self._table[slot] = 0
                self._toks[slot] = 0
                self._lens[slot] = 0
                self._temps[slot] = 0.0
                self._top_ks[slot] = 0
                self._top_ps[slot] = 0.0
                self._draft_ok[slot] = False

    def _finish(self, req, state, error=None):
        if not self.scheduler.release(req, state):
            return
        self._clear_free_slots()
        req.error = error
        total = req.t_done - req.t_submit
        if state == FINISHED:
            self.requests_finished += 1
            self._e2e.append(total)
            telemetry.observe("serve_request_seconds", total,
                              exemplar={"trace": req.trace,
                                        "request": req.id})
        elif state == CANCELLED:
            self.requests_cancelled += 1
            telemetry.inc("serve_cancelled_total")
        else:
            self.requests_failed += 1
            telemetry.inc("serve_failed_total")
        if req.t_first is not None:
            telemetry.record_span(
                "serve/decode", req.t_done - req.t_first, request=req.id,
                trace=req.trace, tokens=len(req.generated))
        telemetry.record_span(
            "serve/request", total, request=req.id, trace=req.trace,
            prompt=req.prompt_len, tokens=len(req.generated), state=state)
        # A compact summary for the cluster driver's store, on the next beat.
        summary = {"trace": req.trace, "request": req.id, "state": state,
                   "tokens": len(req.generated),
                   "total_ms": round(total * 1e3, 3)}
        if req.t_first is not None:
            summary["ttft_ms"] = round((req.t_first - req.t_submit) * 1e3, 3)
        if req.t_admit is not None:
            summary["queue_ms"] = round((req.t_admit - req.t_submit) * 1e3, 3)
        if req.preempt_count:
            summary["preempts"] = req.preempt_count
        telemetry.note_trace(summary)
        if req.handle is not None:
            if error is not None:
                req.handle._events.put(("error", error))
            else:
                req.handle._events.put(("done", state))
        self._publish()

    def _sample_host(self, logits, temperature, top_k=0, top_p=0.0):
        """Sample the prefill's first token host-side. Greedy matches the
        decode step's argmax bit for bit (same f32 values, first-max tie
        rule); temperature uses Gumbel-max with the same top-k/top-p
        filters as the decode sampler."""
        if temperature <= 0.0:
            return int(logits.argmax())
        scaled = logits.astype(np.float32) / max(temperature, 1e-6)
        if top_k or (top_p and top_p < 1.0):
            sorted_desc = np.sort(scaled)[::-1]
            if top_k:
                kth = sorted_desc[min(int(top_k), scaled.size) - 1]
                scaled = np.where(scaled < kth, -1e30, scaled)
                pos = np.arange(sorted_desc.size)
                sorted_desc = np.where(pos < int(top_k), sorted_desc,
                                       -1e30)
            if top_p and top_p < 1.0:
                e = np.exp(sorted_desc - sorted_desc.max())
                probs = e / e.sum()
                cum_before = np.cumsum(probs) - probs
                thresh = sorted_desc[cum_before < top_p].min()
                scaled = np.where(scaled < thresh, -1e30, scaled)
        g = self._host_rng.gumbel(size=scaled.shape)
        return int((scaled + g).argmax())

    def _publish(self):
        active = sum(1 for s in self.scheduler.slots if s is not None)
        self.peak_active = max(self.peak_active, active)
        _publish_gauges()

    # -- background loop -----------------------------------------------------

    def start(self):
        """Run the step loop on a daemon thread (the HTTP endpoint's
        mode); returns self for chaining."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="serving-engine", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            with self._work:
                while (not self._stop.is_set()
                       and not self.scheduler.has_work()
                       and not self._cancels):
                    self._work.wait(0.2)
            if self._stop.is_set():
                return
            try:
                self.step()
            except Exception:
                # A failed step must not kill the loop; fail the in-flight
                # requests loudly and keep serving. Pool writes are in
                # place, so the pool stays valid: later requests write
                # their own pages before reading them.
                logger.exception("serving engine step failed")
                with self._lock:
                    victims = list(self.scheduler.active())
                    if (self._prefill_req is not None
                            and self._prefill_req not in victims):
                        victims.append(self._prefill_req)
                    self._prefill_req = None
                    for req in victims:
                        self._finish(req, FAILED,
                                     error="engine step failed; see logs")
                    # A failed round may have left a draft row half
                    # written: every row replays before it drafts again.
                    self._draft_ok[:] = False

    def close(self, timeout=5.0):
        """Stop the loop and cancel anything still in flight."""
        with self._work:
            for req in list(self.scheduler.waiting) + self.scheduler.active():
                if req.state not in sched_mod.TERMINAL:
                    req.cancel_requested = True
                    self._cancels.append(req)
            self._work.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            with self._work:
                self._work.notify_all()
            self._thread.join(timeout)
        with self._lock:
            self._process_cancels()
        with _live_lock:
            _live_engines.pop(id(self), None)
        self._registered = False
        # Siblings' numbers survive the pop; a retired solo engine zeroes
        # out. A later submit() registers this engine again.
        _publish_gauges()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- views ---------------------------------------------------------------

    def stats(self):
        """Live engine stats (the ``/v1/serving`` payload)."""
        out = self.scheduler.stats()
        ttft = _percentiles_ms(list(self._ttft))
        e2e = _percentiles_ms(list(self._e2e))
        out.update({
            "device": str(self.device),
            "finished": self.requests_finished,
            "cancelled": self.requests_cancelled,
            "failed": self.requests_failed,
            "accepted": self.requests_accepted,
            "tokens_generated": self.tokens_generated,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "decode_seconds": self.decode_seconds,
            "prefill_seconds": self.prefill_seconds,
            "decode_horizon": self.decode_horizon,
            "max_model_len": self.max_model_len,
            "kv_cache_dtype": self.kv_cache_dtype or "fp",
            "prefix_share": self.scheduler.prefix_share,
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_shared": self.prefix_tokens_shared,
            "preempt_mode": self.preempt,
            "preempt_swaps": self.preempt_swaps,
            "preempt_recomputes": self.preempt_recomputes,
            # Speculation: proposals a round, lifetime rounds, drafted and
            # accepted tokens, and the acceptance rate. Rounds count in
            # none of the decode_* keys above (horizon calls only).
            "speculative_tokens": self.speculative_tokens,
            "spec_rounds": self.spec_rounds,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance_rate": (
                self.spec_accepted / max(1, self.spec_drafted)),
            "peak_active": self.peak_active,
            "ttft_ms_p50": ttft["p50"],
            "ttft_ms_p95": ttft["p95"],
            "ttft_ms_p99": ttft["p99"],
            "request_ms_p50": e2e["p50"],
            "request_ms_p95": e2e["p95"],
            "request_ms_p99": e2e["p99"],
            # The drain ledger: accepted + migrated_in == finished +
            # cancelled + failed + migrated_out once is_drained().
            "draining": self.draining,
            "migrated_out": self.migrated_out,
            "migrated_in": self.migrated_in,
            # Disaggregation: the fleet router's pool assignment and the
            # handoff ledger (handoffs also count as migrations above).
            "role": self.role,
            "handoffs_out": self.handoffs_out,
            "handoffs_in": self.handoffs_in,
            "handoff_fallbacks": self.handoff_fallbacks,
            "handoff_bytes": self.handoff_bytes,
        })
        return out
