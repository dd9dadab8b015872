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
   call returns, and their post-terminal tokens are dropped.

A blocked higher-priority admission may **preempt** a strictly
lower-priority resident (``preempt="swap"``: its pages go to host memory
and come back byte for byte; ``"recompute"``: they are dropped and
rebuilt by prefill replay). With ``prefix_share`` admission shares
already-resident full prompt pages (copy-on-write for a whole-prompt
match) and skips their prefill.

Tokens stream to per-request handles as they exist; TTFT and end-to-end
latency stay on the handles and in :meth:`ServingEngine.stats`.

Outside this slice (each raises ``NotImplementedError`` naming its
ROADMAP item when turned on; the defaults are the "off" values):
``draft_model``/``draft_variables``/``speculative_tokens`` and
``role``/``handoff_fn``.
"""

import collections
import logging
import queue as queue_mod
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch.serving import scheduler as sched_mod
from tensorflowonspark_tpu_torch.serving.cache import PagePool
from tensorflowonspark_tpu_torch.serving.runner import ModelRunner
from tensorflowonspark_tpu_torch.serving.scheduler import (
    CANCELLED, FAILED, FINISHED, PREEMPTED, RUNNING, Request, Scheduler,
)

logger = logging.getLogger(__name__)

# Latency samples kept for the stats() percentiles.
_LATENCY_WINDOW = 1024


class QueueFull(RuntimeError):
    """The engine's admission queue is at ``max_queue`` (HTTP 429)."""


class StreamConsumer:
    """The consumer half of a token-stream handle: the engine loop puts
    ``("token", id)`` / ``("error", msg)`` / ``("done", state)`` tuples
    on ``_events``; ``stream()``/``result()`` drain them."""

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


def _not_ported(arg, item):
    raise NotImplementedError(
        "{} is not ported yet (ROADMAP {}); leave it at its default".format(
            arg, item))


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
    """

    def __init__(self, model, variables=None, *, max_slots=8, page_size=128,
                 num_pages=None, max_model_len=None, prefill_chunk=512,
                 prefill_floor=128, decode_horizon=8, max_queue=256,
                 rng_seed=0, prefix_share=True, kv_cache_dtype="",
                 preempt="swap", draft_model=None, draft_variables=None,
                 speculative_tokens=0, role="both", handoff_fn=None,
                 device="cuda"):
        if draft_model is not None or draft_variables is not None \
                or speculative_tokens:
            _not_ported("speculative decoding", "A7b, speculative verify")
        if str(role or "both") != "both" or handoff_fn is not None:
            _not_ported("role/handoff_fn", "A7b, disaggregated handoff")
        preempt = str(preempt or "off")
        if preempt not in ("swap", "recompute", "off"):
            raise ValueError(
                "preempt must be 'swap', 'recompute' or 'off', got "
                "{!r}".format(preempt))
        self.preempt = preempt
        self.decode_horizon = max(1, int(decode_horizon))
        # A decode call runs every row the full horizon, so a row ending
        # mid-call writes up to horizon - 1 junk slots past its budget:
        # the reservation (and the table row) covers them.
        slack = self.decode_horizon - 1
        self.device = device_info.resolve_device(device)
        model.to(self.device)
        cfg = model.cfg
        max_model_len = int(min(
            max_model_len or cfg.max_seq_len, cfg.max_seq_len))
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
        self.requests_accepted = 0
        self.requests_finished = 0
        self.requests_cancelled = 0
        self.requests_failed = 0
        self.tokens_generated = 0
        self.peak_active = 0
        self._ttft = collections.deque(maxlen=_LATENCY_WINDOW)
        self._e2e = collections.deque(maxlen=_LATENCY_WINDOW)

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens, temperature=0.0,
               eos_token=None, top_k=0, top_p=0.0, priority=0,
               _trace=None):
        """Queue one generation request; returns a :class:`RequestHandle`
        streaming its tokens. ``top_k``/``top_p`` filter temperature
        sampling per request (ignored for greedy rows); ``priority``
        (higher first) orders admission and lets the request preempt a
        strictly lower-priority resident (``preempt=`` mode). Raises
        ValueError for a request that can never run and :class:`QueueFull`
        past ``max_queue``."""
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
        handle = RequestHandle(self, req)
        req.handle = handle
        with self._work:
            if self.scheduler.queued() >= self.max_queue:
                raise QueueFull(
                    "admission queue is full ({} requests)".format(
                        self.max_queue))
            self.scheduler.submit(req)  # may raise ValueError (never fits)
            self.requests_accepted += 1
            self._work.notify_all()
        return handle

    def _cancel(self, req):
        with self._work:
            if req.state in sched_mod.TERMINAL:
                return
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

    def run_until_idle(self, timeout=300.0):
        """Drive ``step()`` inline until no request is queued or active."""
        deadline = time.monotonic() + timeout
        while self.scheduler.has_work() or self._cancels:
            self.step()
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
        req.prefill_cache, last_logits = runner.prefill_step(
            req.prefill_cache, tokens, last_idx, alloc)
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
        self._emit_token(req, first)
        if req.state == RUNNING:  # not finished by eos/budget already
            self._toks[req.slot] = req.generated[-1]
            self._lens[req.slot] = req.cache_len
            self._publish()
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
        self._publish()

    # -- decode --------------------------------------------------------------

    def _decode_once(self):
        running = [r for r in self.scheduler.slots
                   if r is not None and r.state == RUNNING]
        if not running:
            return False
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
        self.decode_seconds += time.perf_counter() - t0
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

    # -- transitions ---------------------------------------------------------

    def _emit_token(self, req, token):
        req.generated.append(token)
        self.tokens_generated += 1
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

    def _finish(self, req, state, error=None):
        if not self.scheduler.release(req, state):
            return
        self._clear_free_slots()
        req.error = error
        if state == FINISHED:
            self.requests_finished += 1
            self._e2e.append(req.t_done - req.t_submit)
        elif state == CANCELLED:
            self.requests_cancelled += 1
        else:
            self.requests_failed += 1
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

    def close(self, timeout=5.0):
        """Stop the loop and cancel anything still in flight."""
        with self._work:
            for req in list(self.scheduler.waiting) + self.scheduler.active():
                if req.state not in sched_mod.TERMINAL:
                    self._cancels.append(req)
            self._work.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            with self._work:
                self._work.notify_all()
            self._thread.join(timeout)
        with self._lock:
            self._process_cancels()

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
            "peak_active": self.peak_active,
            "ttft_ms_p50": ttft["p50"],
            "ttft_ms_p95": ttft["p95"],
            "ttft_ms_p99": ttft["p99"],
            "request_ms_p50": e2e["p50"],
            "request_ms_p95": e2e["p95"],
            "request_ms_p99": e2e["p99"],
        })
        return out
