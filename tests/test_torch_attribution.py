"""Request latency attribution of the port (``telemetry/attribution.py``)
against the JAX package's, and over the port engine's own spans.

* Parity: ``align_spans``, ``request_profile``, ``window_profiles``,
  ``window_attribution``, ``dominant_segment`` and ``explain`` equal the
  JAX module's on one seeded span export: two nodes whose clocks differ
  (aligned from the rendezvous-register exchange), requests with queue,
  route, prefill, decode, priority preemptions, drain migrations and
  disaggregated handoffs (stdlib code: equal, not close).
* The port engine records the spans the accounting needs
  (``serve/queue_wait``, ``serve/prefill``, ``serve/decode``, the
  ``serve/request`` envelope), alone and as a disaggregated
  prefill/decode pair (whose handoff is the ``transfer`` segment): every
  request's segments sum to its e2e within the JAX module's tolerance
  (``accounted_frac`` within 0.1 of 1), and its TTFT and e2e histogram
  buckets carry the request's trace id as their exemplar.
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.telemetry import attribution as jax_attr
from tensorflowonspark_tpu_torch import serving, telemetry
from tensorflowonspark_tpu_torch.models import factory
from tensorflowonspark_tpu_torch.telemetry import attribution

pytestmark = pytest.mark.watchdog_timeout(120)

SKEW = 3.25  # seconds the engine node's clock runs ahead of the driver's


def _span(node, name, ts, dur=0.0, **attrs):
    return {"node": node, "name": name, "ts": ts, "dur": dur,
            "trace": "t-" + node, "span": 1, "attrs": attrs}


def _export(seed, n=12):
    """A seeded merged span export of ``n`` requests."""
    rng = np.random.RandomState(seed)
    spans = [_span("driver", "rendezvous/register_rx", 10.0, executor_id=0),
             _span("engine0", "rendezvous/register", 10.0 + SKEW - 0.01,
                   0.02, executor_id=0)]
    t = 20.0
    for i in range(n):
        trace = "req{:02d}".format(i)
        e = t + SKEW
        queue = float(rng.uniform(0.001, 0.05))
        prefill = float(rng.uniform(0.01, 0.2))
        decode = float(rng.uniform(0.05, 0.6))
        kind = i % 4      # 0 plain, 1 preempted, 2 migrated, 3 handed off
        offair = float(rng.uniform(0.05, 0.3)) if kind else 0.0
        e2e = queue + prefill + decode + offair + float(
            rng.uniform(0.0, 0.004))
        spans.append(_span("driver", "serve/route", t - 0.002,
                           e2e + 0.003, trace=trace))
        spans.append(_span("engine0", "serve/queue_wait", e, queue,
                           trace=trace, request=i))
        spans.append(_span("engine0", "serve/prefill", e + queue, prefill,
                           trace=trace, request=i))
        t_first = e + queue + prefill
        spans.append(_span("engine0", "serve/decode", t_first,
                           decode + offair, trace=trace, request=i))
        if kind:
            w0 = t_first + decode / 2
            spans.append(_span("engine0", "serve/preempt_wait", w0, offair,
                               trace=trace, request=i))
            if kind == 2:
                spans.append(_span("engine0", "serve/migrate",
                                   w0 + offair / 2, trace=trace))
            if kind == 3:
                spans.append(_span("engine0", "serve/handoff", w0 + 0.001,
                                   trace=trace))
                spans.append(_span("engine0", "serve/migrate", w0 + 0.002,
                                   trace=trace))
                spans.append(_span("driver", "serve/kv_transfer",
                                   w0 - SKEW, offair * 0.8, trace=trace))
        spans.append(_span("engine0", "serve/request", e, e2e, trace=trace,
                           request=i, state="FINISHED"))
        t += float(rng.uniform(0.05, 0.5))
    # A request still running: no envelope, no profile.
    spans.append(_span("engine0", "serve/queue_wait", t + SKEW, 0.01,
                       trace="running"))
    rng.shuffle(spans)
    return spans


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_request_profiles_equal_jax(seed):
    spans = _export(seed)
    assert attribution.align_spans(spans) == jax_attr.align_spans(spans)
    offsets = telemetry.estimate_clock_offsets(spans)
    assert offsets["engine0"] == pytest.approx(-SKEW)
    for i in range(12):
        trace = "req{:02d}".format(i)
        got = attribution.request_profile(spans, trace)
        assert got == jax_attr.request_profile(spans, trace)
        assert got["nodes"] == ["driver", "engine0"]
        assert abs(got["accounted_frac"] - 1.0) < 0.1
        assert attribution.dominant_segment(got) == \
            jax_attr.dominant_segment(got)
        if i % 4 == 3:
            assert got["transfer_ms"] > 0 and got["kv_transfer_ms"] > 0
        if i % 4 == 2:
            assert got["migration_ms"] > 0
    assert attribution.request_profile(spans, "running") is None
    assert attribution.window_profiles(spans) == \
        jax_attr.window_profiles(spans)


@pytest.mark.parametrize("seed,q", [(0, 0.95), (1, 0.5), (3, 0.9)])
def test_window_attribution_and_explain_equal_jax(seed, q):
    spans = _export(seed)
    got = attribution.window_attribution(spans, quantile=q)
    assert got == jax_attr.window_attribution(spans, quantile=q)
    assert got["requests"] == 12 and got["dominant"] in got["segments"]
    for trace in ("req03", "req07", "nope"):
        assert attribution.explain(spans, trace) == \
            jax_attr.explain(spans, trace)
    assert attribution.window_attribution([]) == {"requests": 0}


def _toy_lm():
    return factory.get_model(
        "transformer", vocab_size=64, num_layers=2, num_heads=4,
        embed_dim=32, mlp_dim=64, max_seq_len=128, remat=False,
        dtype=torch.float32, device="cpu", seed=0)


ENGINE_KW = dict(max_slots=2, page_size=16, num_pages=32, decode_horizon=4,
                 device="cpu")


@pytest.fixture()
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry._reset_for_tests()
    telemetry.configure(node_id="engine", capacity=4096)
    yield
    telemetry._reset_for_tests()
    torch.set_num_threads(threads)


def _requests(submit):
    """Four requests whose decode dominates their e2e: the few ms the
    engine spends between spans (the pages' scatter, the first sample)
    stay a small share of it on a loaded host too."""
    rng = np.random.RandomState(5)
    return [submit(rng.randint(1, 64, size=n).astype(np.int32), m)
            for n, m in ((21, 32), (40, 24), (9, 40), (33, 28))]


def test_engine_spans_account_for_every_request(one_thread):
    eng = serving.ServingEngine(_toy_lm(), None, **ENGINE_KW)
    handles = _requests(eng.submit)
    eng.run_until_idle()
    assert [h.state for h in handles] == [serving.FINISHED] * 4
    spans = telemetry.recent_spans(4096)
    names = {s["name"] for s in spans}
    assert {"serve/queue_wait", "serve/prefill", "serve/prefill_chunk",
            "serve/decode", "serve/request"} <= names
    for h in handles:
        prof = attribution.request_profile(spans, h.trace)
        assert prof["request"] == h.id and prof["state"] == serving.FINISHED
        assert prof["prefill_ms"] > 0 and prof["decode_ms"] > 0
        assert abs(prof["accounted_frac"] - 1.0) < 0.1, prof
    table = attribution.window_attribution(spans)
    assert table["requests"] == 4
    traces = {h.trace for h in handles}
    for fam in ("serve_ttft_seconds", "serve_request_seconds"):
        ex = telemetry.hist_exemplars(fam)
        assert ex and {e["trace"] for e in ex.values()} <= traces
        assert telemetry.hist_export([fam])[fam]["exemplars"] == ex


def test_disaggregated_pair_accounts_the_handoff(one_thread):
    model = _toy_lm()
    pre = serving.ServingEngine(model, None, role="prefill", **ENGINE_KW)
    dec = serving.ServingEngine(model, None, role="decode", **ENGINE_KW)
    fleet = serving.ServingFleet([pre, dec])
    handles = _requests(fleet.submit)
    fleet.run_until_idle()
    assert [h.state for h in handles] == [serving.FINISHED] * 4
    assert pre.stats()["handoffs_out"] == 4
    spans = telemetry.recent_spans(4096)
    for h in handles:
        prof = attribution.request_profile(spans, h.trace)
        assert prof["transfer_ms"] > 0 and prof["kv_transfer_ms"] > 0
        assert abs(prof["accounted_frac"] - 1.0) < 0.1, prof
    assert attribution.window_attribution(spans)["requests"] == 4
