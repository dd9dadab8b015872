"""Closed-loop serving load generator with a traffic ramp (the port's copy
of ``RampLoad`` from the JAX repo's ``scripts/load_gen.py``).

Drives a :class:`~tensorflowonspark_tpu_torch.serving.ServingFleet` (or a
single engine, or a :class:`~tensorflowonspark_tpu_torch.serving
.RemoteEngine`) with a paced request stream whose rate follows a ramp
profile — baseline, a burst plateau (default 10x), back to baseline —
while collector threads drain every stream to completion and audit the
outcome. ``dropped`` counts requests that were *accepted* (a handle came
back) but never finished cleanly: the number the autoscaler's
graceful-drain guarantee says must stay zero while replicas come and go
(``scripts/torch_chaos_run.py --autoscale-drill``)::

    gen = RampLoad(fleet.submit, duration=30, base_rate=2, peak_factor=10)
    gen.start(); ...; gen.join()
    assert gen.stats()["dropped"] == 0
"""

import threading
import time


def default_prompt_fn(vocab=64, lo=6, hi=24):
    """Random int32 token prompts (the drill's tiny-transformer vocab)."""
    import numpy as np

    rng = np.random.RandomState(1234)

    def make(i):
        n = int(rng.randint(lo, hi))
        return rng.randint(1, vocab, size=n).astype(np.int32)

    return make


class RampLoad:
    """Paced submitter + per-request collector threads over any
    ``submit(prompt, max_new_tokens, priority=...) -> handle`` callable
    whose handle has ``result(timeout=)`` / ``state`` (the engine, fleet
    and RemoteEngine contracts all qualify).

    The offered rate over the run's ``duration`` is piecewise: it holds
    ``base_rate`` req/s until ``ramp_start`` (fraction of the duration),
    ``base_rate * peak_factor`` until ``ramp_end``, then ``base_rate``
    again — the ~10x traffic burst the autoscaler must absorb and then
    give back. ``priority_fn(i)`` (optional) assigns request classes so
    the queue-pressure signal sees a priority mix.
    """

    def __init__(self, submit, duration=30.0, base_rate=2.0,
                 peak_factor=10.0, ramp_start=0.2, ramp_end=0.65,
                 max_new_tokens=8, prompt_fn=None, priority_fn=None,
                 result_timeout=120.0, max_inflight=128, retries=0):
        self.submit = submit
        # A real client retries a stream its server killed (an ABRUPT
        # preemption mid-decode); ``retries`` resubmits such a failure
        # that many times before it counts as dropped. Graceful-drain
        # victims never need the retry — that is the drill's point.
        self.retries = int(retries)
        self.retried = 0
        self.duration = float(duration)
        self.base_rate = float(base_rate)
        self.peak_factor = float(peak_factor)
        self.ramp_start = float(ramp_start)
        self.ramp_end = float(ramp_end)
        self.max_new_tokens = int(max_new_tokens)
        self.prompt_fn = prompt_fn or default_prompt_fn()
        self.priority_fn = priority_fn
        self.result_timeout = float(result_timeout)
        self._inflight = threading.Semaphore(int(max_inflight))
        self._lock = threading.Lock()
        self._threads = []
        self._stop = threading.Event()
        self._driver = None
        self.t_start = None
        # Audit counters. "accepted" = a handle came back from submit();
        # the zero-drop drain guarantee is about exactly these.
        self.submitted = 0       # submit() attempts
        self.accepted = 0
        self.finished = 0
        self.rejected = 0        # QueueFull surfaced by every engine
        self.errors = 0          # submit() raised something else
        self.dropped = 0         # accepted but never finished cleanly
        self.drop_reasons = []
        self.series = []         # per-second [t, offered_rate, finished]
        self._finished_stamp = 0

    # -- profile -------------------------------------------------------------

    def rate_at(self, t):
        """Offered req/s at ``t`` seconds into the run."""
        frac = t / self.duration if self.duration > 0 else 1.0
        if self.ramp_start <= frac < self.ramp_end:
            return self.base_rate * self.peak_factor
        return self.base_rate

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self.t_start = time.monotonic()
        self._driver = threading.Thread(
            target=self._run, name="load-gen", daemon=True)
        self._driver.start()
        return self

    def stop(self):
        self._stop.set()

    def join(self, timeout=None):
        """Wait for the submitter AND every collector (all streams
        audited)."""
        if self._driver is not None:
            self._driver.join(timeout)
        for t in list(self._threads):
            t.join(timeout)
        return self

    def _run(self):
        i = 0
        next_second = 1.0
        sec_finished0 = 0
        while not self._stop.is_set():
            t = time.monotonic() - self.t_start
            if t >= self.duration:
                break
            rate = self.rate_at(t)
            if t >= next_second:
                with self._lock:
                    done = self.finished
                self.series.append(
                    [round(t, 2), rate, done - sec_finished0])
                sec_finished0 = done
                next_second += 1.0
            self._submit_one(i)
            i += 1
            # Pace to the profile: sleep to the next slot, re-reading
            # the clock (a slow submit() eats into the gap).
            gap = 1.0 / max(rate, 1e-3)
            sleep = (self.t_start + t + gap) - time.monotonic()
            if sleep > 0:
                self._stop.wait(sleep)

    def _submit_one(self, i):
        self._inflight.acquire()
        prompt = self.prompt_fn(i)
        kw = {}
        if self.priority_fn is not None:
            kw["priority"] = int(self.priority_fn(i))
        with self._lock:
            self.submitted += 1
        try:
            handle = self.submit(prompt, self.max_new_tokens, **kw)
        except Exception as e:
            qf = type(e).__name__ == "QueueFull"
            with self._lock:
                if qf:
                    self.rejected += 1
                else:
                    self.errors += 1
                    if len(self.drop_reasons) < 10:
                        self.drop_reasons.append(
                            "submit: {}: {}".format(type(e).__name__, e))
            self._inflight.release()
            return
        with self._lock:
            self.accepted += 1
        collector = threading.Thread(
            target=self._collect, args=(handle, prompt, kw, i, 0),
            name="load-collect-{}".format(i), daemon=True)
        self._threads.append(collector)
        collector.start()

    def _collect(self, handle, prompt, kw, i, attempt):
        try:
            toks = handle.result(timeout=self.result_timeout)
            # A cancelled/killed stream returns its partial tokens
            # without raising — the terminal STATE is the honest
            # signal, not the token count.
            state = getattr(handle, "state", None)
            ok = (state == "FINISHED" if state is not None
                  else toks is not None and len(toks) >= 1)
            reason = None if ok else \
                "terminal state {} ({} tokens)".format(state, len(toks or ()))
        except Exception as e:
            ok = False
            reason = "{}: {}".format(type(e).__name__, e)
        if not ok and attempt < self.retries:
            try:
                retry = self.submit(prompt, self.max_new_tokens, **kw)
            except Exception as e:
                reason = "retry submit: {}: {}".format(
                    type(e).__name__, e)
            else:
                with self._lock:
                    self.retried += 1
                return self._collect(retry, prompt, kw, i, attempt + 1)
        self._inflight.release()
        with self._lock:
            if ok:
                self.finished += 1
            else:
                self.dropped += 1
                if len(self.drop_reasons) < 10:
                    self.drop_reasons.append(
                        "request {}: {}".format(i, reason))

    # -- report --------------------------------------------------------------

    def stats(self):
        with self._lock:
            return {
                "duration_s": self.duration,
                "base_rate": self.base_rate,
                "peak_factor": self.peak_factor,
                "submitted": self.submitted,
                "accepted": self.accepted,
                "finished": self.finished,
                "rejected_queue_full": self.rejected,
                "submit_errors": self.errors,
                "retried": self.retried,
                "dropped": self.dropped,
                "drop_reasons": list(self.drop_reasons),
                "offered_series": [list(p) for p in self.series],
            }
