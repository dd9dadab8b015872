"""The port's prefix sharing with copy-on-write.

The JAX package's drills (``tests/test_serving_engine.py:173-353``) on the
port's engine at the same geometry (4 slots, page 16, 32 pages, horizon
4): sharers hold the common prefix's pages once and skip its prefill, the
prefix survives in the pool's cached tier, a sharer's cancel never frees
the other's pages, a whole-prompt match takes a copy-on-write page (also
when its source sits in the cached tier, and under concurrent submit
threads), and every stream equals the port's solo ``generate`` token for
token. Sharers' streams also equal the JAX engine's with
``prefix_share=True``, with an fp32 pool and with an int8 one, where
``gather_prefix`` dequantizes the shared pages for the tail's prefill.
"""

import threading

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import serving
from tensorflowonspark_tpu_torch.serving import runner as runner_mod
from torch_serving_common import (
    LM_KW, assert_drained, engine, jax_engine, models, prompt, shared_engine,
    solo,
)
from torch_serving_common import one_torch_thread  # noqa: F401


def _common_prefix_prompts(seed, n_prompts, prefix_len=32, tail_len=4):
    """Prompts sharing a ``prefix_len``-token common prefix (full pages at
    page 16) with distinct tails."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, LM_KW["vocab_size"], size=prefix_len)
    return [np.concatenate([prefix, rng.randint(
        1, LM_KW["vocab_size"], size=tail_len)]).astype(np.int32)
        for _ in range(n_prompts)]


@pytest.mark.watchdog_timeout(120)
def test_prefix_sharers_allocate_shared_pages_once():
    """N requests on one 2-page common prefix hold those 2 pages ONCE
    (in_use counts unique pages, refcount_total references), skip the
    shared prefill, and stream what solo ``generate`` streams."""
    eng = shared_engine()
    shared_before = eng.prefix_tokens_shared
    prompts = _common_prefix_prompts(31, 3, prefix_len=32, tail_len=2)
    handles = [eng.submit(p, 12) for p in prompts]
    eng.step()  # batch ramp: all three admitted, prefilled and joined
    st = eng.pool.stats()
    # 34-token prompts, 12 new, horizon slack 3 -> 49 tokens -> 4 pages
    # each; the first request allocates 4, each sharer retains the 2
    # prefix pages and allocates 2.
    assert st["in_use"] == 4 + 2 + 2
    assert st["shared_pages"] == 2
    assert st["refcount_total"] == 8 + 2 + 2
    assert eng.prefix_tokens_shared - shared_before == 2 * 32
    eng.run_until_idle()
    for p, h in zip(prompts, handles):
        assert h.result(timeout=5) == solo(p, 12)
    assert_drained(eng)


@pytest.mark.watchdog_timeout(120)
def test_prefix_survives_in_cached_tier_after_release():
    """One user at a time still shares: the first request's prefix pages
    park in the cached tier at release and the next identical prefix
    revives them."""
    eng = shared_engine()
    hits_before = eng.prefix_hits
    pa, pb = _common_prefix_prompts(37, 2, prefix_len=48, tail_len=3)
    h = eng.submit(pa, 4)
    eng.run_until_idle()
    assert h.result(timeout=5) == solo(pa, 4)
    st = eng.pool.stats()
    assert st["in_use"] == 0 and st["cached_pages"] >= 3
    h2 = eng.submit(pb, 4)
    eng.run_until_idle()
    assert h2.result(timeout=5) == solo(pb, 4)
    assert eng.prefix_hits - hits_before == 1
    assert_drained(eng)


@pytest.mark.watchdog_timeout(120)
def test_sharer_cancel_mid_stream_never_frees_the_others_pages():
    eng = shared_engine()
    pa, pb = _common_prefix_prompts(41, 2, prefix_len=32, tail_len=3)
    ha = eng.submit(pa, 24)
    hb = eng.submit(pb, 24)
    eng.step()
    assert ha.state == serving.RUNNING and hb.state == serving.RUNNING
    assert eng.pool.stats()["shared_pages"] == 2
    ha.cancel()
    eng.step()
    assert ha.state == serving.CANCELLED
    assert eng.pool.pages_in_use > 0   # B still holds the shared pages
    eng.run_until_idle()
    assert hb.result(timeout=5) == solo(pb, 24)
    got = ha.result(timeout=5)
    assert got == solo(pa, 24)[:len(got)]
    assert_drained(eng)


@pytest.mark.watchdog_timeout(120)
def test_whole_prompt_match_takes_cow_copy():
    """A duplicate of a fully indexed prompt re-runs only its LAST token;
    the write lands in a COW copy of the final shared page, and the stream
    equals solo."""
    eng = shared_engine()
    p = np.random.RandomState(43).randint(
        1, LM_KW["vocab_size"], size=32).astype(np.int32)
    cows_before = eng.pool.stats()["cow_copies_total"]
    h1 = eng.submit(p, 6)
    eng.run_until_idle()
    assert h1.result(timeout=5) == solo(p, 6)
    chunks = []
    step = eng.runner.prefill_step

    def counted(*args, **kw):
        chunks.append(args[1].shape[1])
        return step(*args, **kw)
    eng.runner.prefill_step = counted
    try:
        h2 = eng.submit(p, 6)   # the whole 32-token prompt is indexed
        eng.run_until_idle()
    finally:
        del eng.runner.prefill_step
    assert chunks == [1]        # only the prompt's last token re-ran
    assert h2.result(timeout=5) == solo(p, 6)
    assert eng.pool.stats()["cow_copies_total"] == cows_before + 1
    assert_drained(eng)


@pytest.mark.watchdog_timeout(120)
def test_cow_under_concurrent_submit_threads_leaks_nothing():
    """Submission threads race the step loop with identical whole-page
    prompts: every stream matches solo and the ledger reads clean."""
    eng = shared_engine()
    p = np.random.RandomState(47).randint(
        1, LM_KW["vocab_size"], size=32).astype(np.int32)
    want = solo(p, 5)
    handles, errors = [], []
    lock = threading.Lock()

    def feed():
        try:
            for _ in range(3):
                h = eng.submit(p, 5)
                with lock:
                    handles.append(h)
        except Exception as e:  # pragma: no cover - the assert reports
            errors.append(e)

    eng.start()
    threads = [threading.Thread(target=feed) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        results = [h.result(timeout=60) for h in handles]
    finally:
        eng.close()
    assert not errors
    assert len(results) == 12
    assert all(r == want for r in results)
    assert_drained(eng)
    assert eng.pool.stats()["cow_copies_total"] >= 1


@pytest.mark.watchdog_timeout(120)
def test_whole_prompt_match_on_cached_tier_keeps_source_alive():
    """COW where the source page has NO live holder (cached tier): admit
    retains it until the copy lands; accounting stays clean."""
    eng = shared_engine()
    p = np.random.RandomState(53).randint(
        1, LM_KW["vocab_size"], size=48).astype(np.int32)
    h1 = eng.submit(p, 4)
    eng.run_until_idle()
    assert eng.pool.pages_in_use == 0   # all parked in the tier
    h2 = eng.submit(p, 4)
    eng.run_until_idle()
    assert h1.result(timeout=5) == h2.result(timeout=5) == solo(p, 4)
    assert_drained(eng)


def _sharer_load(eng):
    """Three sharers of a 2-page prefix (one joining a decoding batch),
    then the bare 2-page prefix as a prompt, a whole-prompt match (COW):
    the streams in order."""
    prompts = _common_prefix_prompts(59, 3, prefix_len=32, tail_len=5)
    handles = [eng.submit(prompts[0], 14)]
    eng.step()
    handles += [eng.submit(p, 11) for p in prompts[1:]]
    eng.run_until_idle()
    handles.append(eng.submit(prompts[0][:32], 9))
    eng.run_until_idle()
    return [h.result(timeout=5) for h in handles], prompts


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("kv_cache_dtype", ["", "int8"],
                         ids=["fp32", "int8"])
def test_sharers_match_jax_engine_with_prefix_share(kv_cache_dtype):
    """The same sharing load through the port's and the JAX engine with
    ``prefix_share=True``: equal streams and equal sharing counters. The
    fp32 engines run horizon 4 and also equal solo; the int8 ones run
    horizon 1, where the two pools quantize the same tokens (at horizon >
    1 the JAX window defers them — see the horizon tests), so the streams
    of the gathered, dequantized prefix are held token for token."""
    horizon = 1 if kv_cache_dtype else 4
    eng = engine(decode_horizon=horizon, kv_cache_dtype=kv_cache_dtype)
    jeng = jax_engine(decode_horizon=horizon, kv_cache_dtype=kv_cache_dtype)
    jhits, jshared = jeng.prefix_hits, jeng.prefix_tokens_shared
    got, prompts = _sharer_load(eng)
    jgot, _ = _sharer_load(jeng)
    assert got == jgot
    assert eng.prefix_hits == jeng.prefix_hits - jhits == 3
    assert eng.prefix_tokens_shared == jeng.prefix_tokens_shared - jshared
    assert eng.pool.stats()["cow_copies_total"] == 1
    if not kv_cache_dtype:
        assert got == [solo(prompts[0], 14), solo(prompts[1], 11),
                       solo(prompts[2], 11), solo(prompts[0][:32], 9)]
    assert_drained(eng)


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("kv_cache_dtype", ["", "int8"],
                         ids=["fp32", "int8"])
def test_gather_prefix_rebuilds_the_private_cache(kv_cache_dtype):
    """``gather_prefix`` after ``scatter``: the first ``extent`` slots of
    the prefill cache come back (dequantized from an int8 pool), the rest
    stay zero, the index and position sit at ``extent``; ``scatter(start=)``
    leaves the positions below ``start`` untouched; ``copy_pages`` copies
    values and scales."""
    tm = models()["tm"]
    r = runner_mod.ModelRunner(tm, None, max_slots=2, page_size=16,
                               num_pages=10, kv_quant=kv_cache_dtype)
    p = prompt(40, 7)
    alloc = r.prefill_alloc(40)
    pc, _ = r.prefill_step(r.new_prefill_cache(alloc), p[None], 39, alloc)
    pages = [3, 5, 8]
    r.scatter(pc, pages, 40, alloc)
    got = r.gather_prefix(pages, 37, alloc)
    assert got["position"] == 37
    for key, layer in pc.items():
        if key == "position":
            continue
        assert got[key]["cache_index"] == 37
        for name in ("cached_key", "cached_value"):
            want = layer[name][0, :37]
            if kv_cache_dtype:
                from tensorflowonspark_tpu_torch.models import transformer
                want = transformer._kv_dequantize(
                    *transformer._kv_quantize(want), want.dtype)
            assert torch.equal(got[key][name][0, :37], want)
            assert not got[key][name][0, 37:].any()
    before = {k: {n: t.clone() for n, t in layer.items()}
              for k, layer in r.cache.items()}
    r.scatter(r.new_prefill_cache(alloc), pages, 40, alloc, start=32)
    for key, layer in r.cache.items():
        for name, t in layer.items():
            flat = t.view((-1,) + t.shape[2:])
            old = before[key][name].view(flat.shape)
            assert torch.equal(flat[3 * 16:3 * 16 + 16], old[48:64])
            assert torch.equal(flat[5 * 16:5 * 16 + 16], old[80:96])
            # Positions 32..39 were rewritten from the zero cache (an
            # all-zero row quantizes to zeros at the 1e-30 scale floor).
            assert (flat[8 * 16:8 * 16 + 8] <= 1e-30).all()
    r.copy_pages([3, 5], [1, 2])
    for layer in r.cache.values():
        for t in layer.values():
            assert torch.equal(t[[1, 2]], t[[3, 5]])
