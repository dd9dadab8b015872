"""The port's continuous-batching engine and HTTP plane.

Greedy streams of the port's ``ServingEngine`` (paged pool, one decode
step per call, the paged-attention wrapper's plain version on the CPU)
must equal, bitwise, both the port's solo ``generate`` and the JAX
package's, in fp32 on converted weights: a solo request, one that joins
a decoding batch, a max-length request. An int8 pool is held against the
JAX engine's int8 pool. Cancels free pages; ``POST /v1/generate`` streams
NDJSON over loopback TCP; without ``device=`` the engine refuses to run
on this CPU-only machine.
"""

import json
import urllib.error
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu.models import decoding as jax_decoding
from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu_torch import convert, serving
from tensorflowonspark_tpu_torch.models import decoding, factory
from tensorflowonspark_tpu_torch.serving import runner as runner_mod
from tensorflowonspark_tpu_torch.train.metrics import MetricsServer

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
_STATE = {}


def _models():
    if not _STATE:
        jm = jax_factory.get_model("transformer", dtype=jnp.float32, **LM_KW)
        params = nn.meta.unbox(jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
        tm = factory.get_model("transformer", dtype=torch.float32,
                               device="cpu", **LM_KW)
        _STATE.update(jm=jm, variables={"params": params}, tm=tm,
                      sd=convert.params_from_flax(jax.device_get(params),
                                                  tm.cfg))
        decoding.load_variables(tm, _STATE["sd"])
    return _STATE


def _engine(**kw):
    # The horizon-1, no-sharing, no-preemption engine these tests pinned
    # before the defaults became the JAX engine's; the new features have
    # their own files (tests/test_torch_serving_{horizon,prefix,preempt}).
    args = dict(max_slots=4, page_size=16, num_pages=32, decode_horizon=1,
                prefix_share=False, preempt="off", device="cpu")
    args.update(kw)
    return serving.ServingEngine(_models()["tm"], None, **args)


def _shared_engine():
    if "engine" not in _STATE:
        _STATE["engine"] = _engine()
    return _STATE["engine"]


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(
        1, LM_KW["vocab_size"], size=n).astype(np.int32)


def _solo(prompt, n_new):
    out = decoding.generate(_models()["tm"], None, prompt[None], n_new,
                            auto_cache=True)
    return out[0, len(prompt):].tolist()


def _jax_solo(prompt, n_new):
    m = _models()
    out = jax_decoding.generate(m["jm"], m["variables"], prompt[None],
                                n_new, auto_cache=True)
    return np.asarray(out)[0, len(prompt):].tolist()


def test_solo_request_matches_port_and_jax_generate():
    eng = _shared_engine()
    p = _prompt(12, seed=3)
    h = eng.submit(p, 10)
    eng.run_until_idle()
    got = h.result(timeout=5)
    assert got == _solo(p, 10) == _jax_solo(p, 10)
    assert h.ttft is not None and h.e2e >= h.ttft


def test_joined_mid_batch_matches_solo_generate():
    """A request admitted into an already-decoding batch, decoding beside
    a neighbour and outliving it, emits bitwise the solo tokens."""
    eng = _shared_engine()
    p1, p2, p3 = _prompt(12, seed=1), _prompt(20, seed=2), _prompt(7, seed=5)
    h1 = eng.submit(p1, 16)
    eng.step()
    eng.step()  # h1 is mid-decode now
    h2 = eng.submit(p2, 12)
    eng.step()
    h3 = eng.submit(p3, 4)  # joins while h1 and h2 are in flight
    eng.run_until_idle()
    for h, p, n in ((h1, p1, 16), (h2, p2, 12), (h3, p3, 4)):
        assert h.result(timeout=5) == _solo(p, n) == _jax_solo(p, n)
    assert eng.pool.pages_in_use == 0


def test_max_length_request_fits_its_table_row():
    eng = _shared_engine()
    p = _prompt(120, seed=13)
    h = eng.submit(p, 8)  # 120 + 8 == max_model_len == 128
    eng.run_until_idle()
    assert h.state == serving.FINISHED
    assert h.result(timeout=5) == _solo(p, 8) == _jax_solo(p, 8)
    assert eng.pool.pages_in_use == 0


def test_int8_pool_matches_jax_int8_engine():
    """The quantized pool: the stream equals the JAX engine's int8 stream
    (same quantize-on-write, same dequantize-in-the-walk), the first token
    is the fp prefill's, and the pool shrinks past 2x (int8 + one f32
    scale per token and KV head vs f32 pages: 1.5/4 at d=8)."""
    m = _models()
    eng8 = _engine(max_slots=2, num_pages=16, kv_cache_dtype="int8")
    jeng8 = jax_serving.ServingEngine(
        m["jm"], m["variables"], max_slots=2, page_size=16, num_pages=16,
        decode_horizon=1, prefix_share=False, kv_cache_dtype="int8")
    p = _prompt(20, seed=61)
    h, jh = eng8.submit(p, 12), jeng8.submit(p, 12)
    eng8.run_until_idle()
    jeng8.run_until_idle()
    got = h.result(timeout=5)
    assert got == jh.result(timeout=5)
    assert got[0] == _solo(p, 12)[0]
    fp_page = _shared_engine().pool.page_bytes
    assert eng8.pool.page_bytes * 2 < fp_page
    assert eng8.stats()["kv_cache_dtype"] == "int8"
    assert eng8.pool.pages_in_use == 0


def test_sampling_rows_beside_greedy_rows():
    """One decode batch holding a greedy row, a top-k=1 sampled row (which
    must be greedy too) and a nucleus-sampled row: the sampler never
    touches the greedy rows' tokens."""
    eng = _shared_engine()
    p1, p2, p3 = _prompt(10, seed=31), _prompt(14, seed=32), _prompt(6, 33)
    h1 = eng.submit(p1, 12)
    h2 = eng.submit(p2, 12, temperature=0.9, top_k=1)
    h3 = eng.submit(p3, 12, temperature=0.8, top_p=0.9)
    eng.run_until_idle()
    assert h1.result(timeout=5) == _solo(p1, 12)
    assert h2.result(timeout=5) == _solo(p2, 12)
    sampled = h3.result(timeout=5)
    assert len(sampled) == 12
    assert all(0 <= t < LM_KW["vocab_size"] for t in sampled)
    assert eng.pool.pages_in_use == 0


def test_row_filters_match_solo_sampler():
    """The decode step's per-row top-k/top-p filters pick what the solo
    sampler picks for each row's settings, given the same Gumbel noise."""
    rs = np.random.RandomState(41)
    logits = torch.as_tensor(rs.standard_normal((5, 64)).astype(np.float32)
                             * 3.0)
    noise = torch.as_tensor(rs.gumbel(size=(5, 64)).astype(np.float32))
    temps = [0.7, 1.0, 1.3, 0.8, 1.0]
    top_ks = [0, 5, 0, 8, 0]
    top_ps = [0.0, 0.0, 0.9, 0.8, 0.3]
    scaled = logits / torch.as_tensor(temps)[:, None]
    filtered = runner_mod._filter_rows(scaled, torch.as_tensor(top_ks),
                                       torch.as_tensor(top_ps))
    got = torch.argmax(filtered + noise, dim=-1)
    for r in range(5):
        want = decoding._sample(logits[r:r + 1], None, temps[r], top_ks[r],
                                top_ps[r], noise=noise[r:r + 1])
        assert int(got[r]) == int(want[0]), r


def test_cancel_mid_stream_frees_pages():
    eng = _shared_engine()
    p = _prompt(8)
    blocker = eng.submit(p, 40)
    eng.step()  # prefill + join
    eng.step()  # some decode
    assert blocker.state == serving.RUNNING
    assert eng.pool.pages_in_use > 0
    blocker.cancel()
    eng.step()
    assert blocker.state == serving.CANCELLED
    assert eng.pool.pages_in_use == 0
    got = blocker.result(timeout=5)
    assert 0 < len(got) < 40  # the partial stream survives
    assert got == _solo(p, 40)[:len(got)]


def test_cancel_queued_request_leaves_queue():
    eng = _engine(max_slots=1, num_pages=2)
    h1 = eng.submit(_prompt(8), 8)
    h2 = eng.submit(_prompt(8), 8)  # blocked behind h1 (one slot)
    eng.step()
    assert h2.state == serving.QUEUED
    h2.cancel()
    eng.step()
    assert h2.state == serving.CANCELLED
    assert h2.result(timeout=5) == []
    eng.run_until_idle()
    assert h1.state == serving.FINISHED
    assert eng.pool.pages_in_use == 0


def test_cache_full_backpressure_and_rejection():
    """A pool that fits one request at a time holds the second QUEUED
    until the first frees its pages; one that can never fit is refused."""
    eng = _engine(max_slots=2, num_pages=3)
    h1 = eng.submit(_prompt(8), 8)   # one page
    h2 = eng.submit(_prompt(20), 8)  # two pages
    eng.step()
    eng.step()
    assert h2.state == serving.QUEUED
    assert eng.pool.pages_in_use == 1
    eng.run_until_idle()
    assert h2.result(timeout=5) == _solo(_prompt(20), 8)
    assert eng.pool.pages_in_use == 0
    with pytest.raises(serving.CacheFull):
        _engine(max_slots=1, num_pages=2).submit(_prompt(30), 8)
    with pytest.raises(ValueError):
        eng.submit(_prompt(100), 100)  # past max_model_len


def test_page_pool_ledger_is_loud():
    pool = serving.PagePool(num_pages=8, page_size=16)
    a, b = pool.alloc(3), pool.alloc(4)
    assert 0 not in a + b and pool.alloc(1) is None
    pool.free(a)
    with pytest.raises(RuntimeError):
        pool.free(a)          # double free
    with pytest.raises(RuntimeError):
        pool.free([0])        # the trash page is nobody's
    pool.free(b)
    assert pool.pages_in_use == 0 and pool.pages_free == 7


def _post(url, body, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def test_http_generate_streams_ndjson():
    eng = _shared_engine().start()
    server = MetricsServer(engine=eng)
    base = "http://127.0.0.1:{}".format(server.start())
    try:
        p = _prompt(9, seed=11)
        want = _solo(p, 6)
        with _post(base + "/v1/generate",
                   {"prompt": p.tolist(), "max_new_tokens": 6,
                    "traceparent": "abcdef012345-7"}) as resp:
            lines = [json.loads(line) for line in resp.read().splitlines()
                     if line]
        assert [line["token"] for line in lines[:-1]] == want
        tail = lines[-1]
        assert tail["done"] and tail["state"] == "FINISHED"
        assert tail["trace"] == "abcdef012345"
        assert tail["ttft_ms"] > 0 and tail["total_ms"] >= tail["ttft_ms"]
        with _post(base + "/v1/generate",
                   {"prompt": p.tolist(), "max_new_tokens": 6,
                    "stream": False}) as resp:
            assert json.loads(resp.read())["tokens"] == want
        with urllib.request.urlopen(base + "/v1/serving", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["finished"] >= 2 and stats["ttft_ms_p50"] > 0
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/v1/generate", {"prompt": "text"})
        assert err.value.code == 400
    finally:
        server.stop()
        eng.close()


def test_engine_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ServingEngine(_models()["tm"], None)


@pytest.mark.parametrize("kw", [
    dict(speculative_tokens=2), dict(draft_model=object()),
    dict(draft_variables={})],
    ids=lambda kw: next(iter(kw)))
def test_arguments_outside_the_slice_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        _engine(**kw)


def test_role_is_validated_like_jax():
    with pytest.raises(ValueError, match="role must be"):
        _engine(role="bogus")
    with pytest.raises(ValueError, match="role must be"):
        jax_serving.ServingEngine(
            _models()["jm"], _models()["variables"], max_slots=1,
            page_size=16, num_pages=4, role="bogus")
    for role in ("both", "prefill", "decode"):
        eng = _engine(role=role, handoff_fn=lambda req, payload: True)
        assert eng.role == role and eng.stats()["role"] == role
        eng.close()


def test_preempt_mode_is_validated_like_jax():
    with pytest.raises(ValueError, match="preempt must be"):
        _engine(preempt="bogus")
    with pytest.raises(ValueError, match="preempt must be"):
        jax_serving.ServingEngine(
            _models()["jm"], _models()["variables"], max_slots=1,
            page_size=16, num_pages=4, preempt="bogus")
