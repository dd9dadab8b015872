"""Disaggregated prefill/decode in the port, against the JAX package.

The wire codec both ways: a JAX ``encode_handoff`` blob (bf16, int8 pages
with f32 scales, a JAX extract's power-of-two padded rows, numpy leaves)
is read by the port's ``decode_handoff`` with equal meta and byte-equal
leaves, and the port's encode of that tree is byte-identical to the JAX
blob; a port blob reads back byte-exact in both decoders; truncated or
trailing payloads raise ``ValueError`` in both.

The engines: greedy streams through a prefill-role and a decode-role
engine behind ``ServingFleet`` — in process and over ``POST /v1/migrate``
— equal the port's solo ``generate`` and the JAX package's disaggregated
pair on the same weights (fp32 pool, horizon 4), and with an int8 pool
(horizon 1) the port's colocated int8 engine and the JAX int8 pair. A
page-size or KV-dtype mismatch is refused and replayed locally, a cancel
in the transfer window frees pages on both engines, a dead decode pool
falls back to colocated replay, the prefix digest scores a warm remote
peer through the heartbeat plane, and concurrent handoffs under a short
thread switch interval keep every stream and ledger. The engines are stepped inline
(``ServingFleet.run_until_idle`` waits out the handoff threads), never
raced against a sleep.
"""

import gc
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu_torch import serving, telemetry, telemetry_store
from tensorflowonspark_tpu_torch.train.metrics import MetricsServer
from torch_serving_common import (
    ENGINE_KW, assert_drained, engine, models, prompt, solo,
)
from torch_serving_common import one_torch_thread  # noqa: F401

CASES = [(29, 20, 8), (45, 21, 6), (17, 22, 10)]
INT8_KW = dict(max_slots=2, num_pages=16, decode_horizon=1,
               kv_cache_dtype="int8")
_JAX = {}


def _cases():
    return [(prompt(n, seed), new) for n, seed, new in CASES]


def _balanced(eng):
    s = eng.stats()
    return (s["accepted"] + s["migrated_in"]
            == s["finished"] + s["cancelled"] + s["failed"]
            + s["migrated_out"])


def _jax_pair_streams(cases, **kw):
    """The JAX package's prefill/decode pair (built once per ``kw``),
    stepped inline until every request finished."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        m = models()
        args = dict(ENGINE_KW)
        args.update(kw)
        pre = jax_serving.ServingEngine(m["jm"], m["variables"],
                                        role="prefill", **args)
        dec = jax_serving.ServingEngine(m["jm"], m["variables"],
                                        role="decode", **args)
        _JAX[key] = (jax_serving.ServingFleet([pre, dec]), pre, dec)
    fleet, pre, dec = _JAX[key]
    handles = [fleet.submit(p, n) for p, n in cases]
    deadline = time.monotonic() + 60
    while not all(h.state == jax_serving.FINISHED for h in handles):
        assert time.monotonic() < deadline
        if not (pre.step() | dec.step()):
            time.sleep(0.001)        # a handoff thread holds the request
    streams = [h.result(timeout=5) for h in handles]
    assert pre.stats()["handoffs_out"] >= len(cases)
    return streams


def _port_pair(**kw):
    pre = engine(role="prefill", **kw)
    dec = engine(role="decode", **kw)
    return serving.ServingFleet([pre, dec]), pre, dec


def _settle(eng, timeout=30.0):
    """Wait until ``eng`` has nothing queued, resident or in flight (its
    handoff threads record their outcome after the stream may have
    ended)."""
    deadline = time.monotonic() + timeout
    while eng.busy():
        assert time.monotonic() < deadline, eng.stats()
        time.sleep(0.005)


def _serve(fleet, cases):
    handles = [fleet.submit(p, n) for p, n in cases]
    fleet.run_until_idle()
    for h in handles:
        assert h.state == serving.FINISHED
    return [h.result(timeout=5) for h in handles]


# -- the wire codec -----------------------------------------------------------


def _jax_tree():
    """A JAX int8 engine's real page extract (padded to 4 rows, int8
    pages, f32 scales, numpy leaves) plus bf16 leaves as the JAX runner's
    bf16 pool yields them."""
    m = models()
    eng = jax_serving.ServingEngine(m["jm"], m["variables"], max_slots=1,
                                    page_size=16, num_pages=8,
                                    kv_cache_dtype="int8")
    tree = eng.runner.extract_pages([1, 2, 3])
    rng = np.random.RandomState(7)
    tree["block_9"] = {"attn": {
        "k_pages": rng.randn(4, 16, 4, 8).astype(jnp.bfloat16),
        "v_pages": rng.randn(4, 16, 4, 8).astype(jnp.bfloat16)}}
    tree["block_0"]["attn"]["k_scales"] = rng.rand(
        4, 16, 4).astype(np.float32)
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _bytes(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        return leaf.numpy().tobytes()
    return np.asarray(leaf).tobytes()


@pytest.mark.watchdog_timeout(120)
def test_port_decoder_reads_a_jax_blob_byte_exact():
    tree = _jax_tree()
    meta = {"version": jax_serving.HANDOFF_WIRE_VERSION, "request": 9,
            "trace": "ab12", "prompt": [1, 2, 3], "pages": 3,
            "generated": [17], "nested": {"deep": [1.5, None, "x"]}}
    blob = jax_serving.encode_handoff(meta, tree)
    meta2, got = serving.decode_handoff(blob)
    assert meta2 == meta
    want = dict(_leaves(tree))
    have = dict(_leaves(got))
    assert want.keys() == have.keys()
    dtypes = set()
    for path, leaf in want.items():
        assert have[path].shape == leaf.shape, path
        assert _bytes(have[path]) == _bytes(leaf), path
        dtypes.add(str(leaf.dtype))
    assert {"bfloat16", "int8", "float32"} <= dtypes
    assert have[("block_9", "attn", "k_pages")].dtype == torch.bfloat16
    assert have[("block_0", "attn", "k_pages")].shape[0] == 4  # padded
    # The port's encoder writes the JAX blob's bytes from that tree.
    assert serving.encode_handoff(meta2, got) == blob


@pytest.mark.watchdog_timeout(120)
def test_port_blob_round_trips_and_reads_in_jax():
    g = torch.Generator().manual_seed(3)
    tree = {"block_0": {
        "k_pages": torch.randn(3, 16, 4, 8, generator=g).to(torch.bfloat16),
        "v_pages": torch.randint(-128, 128, (3, 16, 4, 8), generator=g,
                                 dtype=torch.int8),
        "k_scales": torch.rand(3, 16, 4, generator=g)},
        "extents": torch.tensor([41], dtype=torch.int32)}
    meta = {"version": serving.HANDOFF_WIRE_VERSION, "pages": 3}
    blob = serving.encode_handoff(meta, tree)
    meta2, got = serving.decode_handoff(blob)
    assert meta2 == meta
    for (path, a), (path2, b) in zip(_leaves(tree), _leaves(got)):
        assert path == path2 and a.dtype == b.dtype and a.shape == b.shape
        assert _bytes(a) == _bytes(b), path
    jmeta, jtree = jax_serving.decode_handoff(blob)
    assert jmeta == meta
    for (path, a), (path2, b) in zip(_leaves(tree), _leaves(jtree)):
        assert path == path2 and _bytes(a) == np.asarray(b).tobytes()
    assert str(jtree["block_0"]["k_pages"].dtype) == "bfloat16"


@pytest.mark.parametrize("cut", ["header", "arrays", "trailing", "junk"])
def test_corrupt_payloads_raise_like_jax(cut):
    blob = serving.encode_handoff(
        {"pages": 1}, {"k": torch.zeros(2, 4, dtype=torch.float32)})
    bad = {"header": blob[:10], "arrays": blob[:-3],
           "trailing": blob + b"x", "junk": b"junk"}[cut]
    with pytest.raises(ValueError):
        serving.decode_handoff(bad)
    with pytest.raises(ValueError):
        jax_serving.decode_handoff(bad)


def test_restore_pages_takes_padded_rows():
    """A tree carrying rows past the page count (the JAX extract's
    padding) restores its first rows only."""
    eng = engine()
    src = eng.runner.extract_pages([1, 2, 3])
    padded = {k: {n: torch.cat([t, torch.full_like(t[:1], 7)])
                  for n, t in layer.items()} for k, layer in src.items()}
    eng.runner.restore_pages(padded, [4, 5, 6])
    back = eng.runner.extract_pages([4, 5, 6])
    for key, layer in src.items():
        for name, t in layer.items():
            assert torch.equal(back[key][name], t)
    eng.close()


# -- disaggregated streams ----------------------------------------------------


@pytest.mark.watchdog_timeout(120)
def test_disagg_streams_equal_solo_and_the_jax_pair():
    fleet, pre, dec = _port_pair()
    cases = _cases()
    got = _serve(fleet, cases)
    assert got == [solo(p, n) for p, n in cases]
    assert got == _jax_pair_streams(cases)
    s_pre, s_dec = pre.stats(), dec.stats()
    assert s_pre["handoffs_out"] == len(cases)
    assert s_pre["handoff_fallbacks"] == 0 and s_pre["finished"] == 0
    assert s_pre["decode_steps"] == 0     # a prefill engine never decodes
    assert s_pre["handoff_bytes"] > 0
    assert s_dec["handoffs_in"] == len(cases)
    assert s_dec["finished"] == len(cases)
    for eng in (pre, dec):
        assert_drained(eng)
        assert _balanced(eng)
    fleet.close()


@pytest.mark.watchdog_timeout(120)
def test_disagg_int8_equals_colocated_and_the_jax_pair():
    cases = _cases()[:2]
    colo = engine(**INT8_KW)
    handles = [colo.submit(p, n) for p, n in cases]
    colo.run_until_idle()
    want = [h.result(timeout=5) for h in handles]
    colo.close()
    assert [w[0] for w in want] == [solo(p, n)[0] for p, n in cases]
    fleet, pre, dec = _port_pair(**INT8_KW)
    assert _serve(fleet, cases) == want
    assert want == _jax_pair_streams(cases, **INT8_KW)
    assert pre.stats()["handoffs_out"] == len(cases)
    assert dec.stats()["handoffs_in"] == len(cases)
    assert_drained(pre)
    assert_drained(dec)
    fleet.close()


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp32", "int8"])
def test_disagg_over_http_equals_in_process(kv):
    """The decode engine behind a loopback ``MetricsServer``; the fleet
    holds it as a ``RemoteEngine``: pages cross over ``POST /v1/migrate``
    and the tokens come back into the original handle."""
    kw = INT8_KW if kv else {}
    cases = _cases()[:2]
    fleet, _, _ = _port_pair(**kw)
    want = _serve(fleet, cases)
    fleet.close()
    dec = engine(role="decode", **kw).start()
    server = MetricsServer(engine=dec)
    server.start()
    pre = engine(role="prefill", **kw)
    remote = serving.RemoteEngine(
        "http://127.0.0.1:{}".format(server.port), name="decode-node",
        role="decode")
    fleet = serving.ServingFleet([pre, remote]).start()
    try:
        handles = [fleet.submit(p, n) for p, n in cases]
        got = [h.result(timeout=60) for h in handles]
        assert [h.state for h in handles] == [serving.FINISHED] * 2
        _settle(pre)
        _settle(dec)
        assert got == want
        if not kv:
            assert got == [solo(p, n) for p, n in cases]
        assert pre.stats()["handoffs_out"] == 2
        assert pre.stats()["handoff_fallbacks"] == 0
        assert dec.stats()["handoffs_in"] == 2
        assert dec.stats()["finished"] == 2
        assert telemetry.hist_quantiles("serve_kv_transfer_seconds", (0.5,))
    finally:
        server.stop()
        fleet.close()
        dec.close()
    assert_drained(pre)
    assert_drained(dec)
    assert _balanced(pre) and _balanced(dec)


# -- refusals and fallbacks ---------------------------------------------------


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("wrong", [dict(page_size=8, num_pages=64),
                                   dict(kv_cache_dtype="int8")],
                         ids=["page_size", "kv_dtype"])
def test_geometry_mismatch_is_refused_and_replayed_locally(wrong):
    dec_wrong = engine(role="decode", **wrong)
    blobs = []

    def handoff_fn(req, payload):
        blobs.append(payload)
        dec_wrong.inject_handoff(payload)     # ValueError -> fallback
        return True

    pre = engine(role="prefill", handoff_fn=handoff_fn)
    p = prompt(21, seed=45)
    h = pre.submit(p, 6)
    pre.run_until_idle()
    assert h.state == serving.FINISHED
    assert h.result(timeout=5) == solo(p, 6)
    s = pre.stats()
    assert s["handoff_fallbacks"] == 1 and s["finished"] == 1
    assert s["handoffs_out"] == 0 and s["migrated_out"] == 0
    assert dec_wrong.stats()["handoffs_in"] == 0
    assert_drained(pre)
    assert_drained(dec_wrong)
    assert _balanced(pre)
    # The refusal was the geometry check, not the codec.
    meta, _ = serving.decode_handoff(blobs[0])
    assert meta["page_size"] == 16 and meta["kv_cache_dtype"] == ""
    pre.close()
    dec_wrong.close()


@pytest.mark.watchdog_timeout(120)
def test_cancel_in_the_transfer_window_frees_both_engines():
    dec = engine(role="decode")
    started = threading.Event()
    gate = threading.Event()

    def handoff_fn(req, payload):
        started.set()
        assert gate.wait(timeout=30)
        dec.inject_handoff(payload, req=req)  # raises: cancelled in flight
        return True

    pre = engine(role="prefill", handoff_fn=handoff_fn)
    h = pre.submit(prompt(26, seed=50), 8)
    pre.step()                                # prefill, join, hand off
    assert started.wait(timeout=30)
    assert pre.scheduler.queued() == 0 and pre.pool.pages_in_use == 0
    assert pre.busy() and not pre.is_drained()
    h.cancel()                                # neither engine owns it
    gate.set()
    pre.run_until_idle()
    toks = h.result(timeout=30)
    assert h.state == serving.CANCELLED and len(toks) == 1
    s_pre, s_dec = pre.stats(), dec.stats()
    assert s_pre["cancelled"] == 1 and s_pre["migrated_out"] == 0
    assert s_dec["handoffs_in"] == 0 and s_dec["accepted"] == 0
    assert_drained(pre)
    assert_drained(dec)
    assert _balanced(pre) and _balanced(dec)
    pre.close()
    dec.close()


@pytest.mark.watchdog_timeout(120)
def test_dead_decode_pool_falls_back_to_colocated_replay():
    remote = serving.RemoteEngine("http://127.0.0.1:9", name="dead-decode",
                                  role="decode", timeout=2.0)
    pre = engine(role="prefill")
    fleet = serving.ServingFleet([pre, remote])
    p = prompt(33, seed=55)
    h = fleet.submit(p, 7)
    fleet.run_until_idle()
    assert h.state == serving.FINISHED
    assert h.result(timeout=5) == solo(p, 7)
    s = pre.stats()
    assert s["handoff_fallbacks"] == 1 and s["finished"] == 1
    assert s["migrated_out"] == 0 and s["decode_steps"] > 0
    assert_drained(pre)
    assert _balanced(pre)
    fleet.close()


def test_remote_prefix_digest_scores_a_warm_peer():
    """A warm engine's chain-key digest rides ``node_stats()`` into a
    ``TelemetryStore``; ``heartbeat_stats_fn`` hands it to
    ``RemoteEngine.match_tokens``, which scores the warm prompt with no
    round trip and a cold one zero."""
    gc.collect()            # engines dropped unclosed leave the registry
    eng = engine()
    warm = prompt(48, seed=70)                 # 3 full 16-token pages
    h = eng.submit(warm, 4)
    eng.run_until_idle()
    h.result(timeout=5)
    eng._publish()
    stats = telemetry.node_stats()
    assert stats.get("serve_prefix_digest")
    assert stats.get("serve_page_size") == 16
    store = telemetry_store.TelemetryStore()
    store.ingest("nodeW", stats)
    fn = serving.heartbeat_stats_fn(store=store, node="nodeW")
    assert fn() and fn()["serve_prefix_digest"]
    remote = serving.RemoteEngine("http://127.0.0.1:9", name="warm-peer",
                                  stats_fn=fn)
    assert remote.match_tokens(warm) == 48
    assert remote.match_tokens(prompt(48, seed=71)) == 0
    eng.close()


@pytest.mark.watchdog_timeout(120)
def test_concurrent_handoffs_keep_every_ledger():
    """Both engines on their own loop threads, four submitting threads,
    handoff threads besides, and a short switch interval: every stream
    equals solo ``generate``, every handoff lands once, both ledgers
    balance and no page is left — a lost update in a counter or a request
    dropped between the engines would break one of these."""
    fleet, pre, dec = _port_pair()
    reqs = [(prompt(10 + i, seed=400 + i), 4 + i % 5) for i in range(16)]
    handles = [None] * len(reqs)

    def submit(k):
        for i in range(k, len(reqs), 4):
            handles[i] = fleet.submit(*reqs[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        fleet.start()
        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        got = [h.result(timeout=60) for h in handles]
        _settle(pre)
        _settle(dec)
    finally:
        sys.setswitchinterval(interval)
        fleet.close()
    assert got == [solo(p, n) for p, n in reqs]
    assert pre.stats()["handoffs_out"] == dec.stats()["handoffs_in"] == 16
    assert pre.stats()["handoff_fallbacks"] == 0
    for eng in (pre, dec):
        assert _balanced(eng)
        assert_drained(eng)
