"""The port's solo decoding path held against the JAX package's.

Greedy ``generate`` emits exactly JAX ``decoding.generate(auto_cache=True)``
's tokens in fp32 on converted weights. Sampling cannot share random bits
across ``jax.random`` and ``torch.Generator``, so the filter semantics are
pinned instead: both ``_sample``s get the same logits and the same numpy
Gumbel noise (JAX's categorical is argmax(logits + Gumbel)) and must pick
the same tokens. ``prefill="stepwise"``, a ``decode_attention="chunked"``
model (solo and under the engine) are held against JAX the same way.
"""

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
from torch_serving_common import one_torch_thread  # noqa: F401

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
_STATE = {}


def _pair():
    if "jm" not in _STATE:
        jm = jax_factory.get_model("transformer", dtype=jnp.float32, **LM_KW)
        params = nn.meta.unbox(jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
        tm = factory.get_model("transformer", dtype=torch.float32,
                               device="cpu", **LM_KW)
        decoding.load_variables(
            tm, convert.params_from_flax(jax.device_get(params), tm.cfg))
        _STATE.update(jm=jm, variables={"params": params}, tm=tm)
    return _STATE["jm"], _STATE["variables"], _STATE["tm"]


def _prompt(shape, seed):
    return np.random.RandomState(seed).randint(
        1, LM_KW["vocab_size"], size=shape).astype(np.int32)


@pytest.mark.parametrize("shape,n_new,seed", [
    ((1, 12), 16, 0), ((2, 7), 10, 1), ((1, 120), 8, 2)])
def test_greedy_generate_matches_jax(shape, n_new, seed):
    jm, variables, tm = _pair()
    prompt = _prompt(shape, seed)
    ref = np.asarray(jax_decoding.generate(jm, variables, prompt, n_new,
                                           auto_cache=True))
    got = decoding.generate(tm, None, prompt, n_new, auto_cache=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_eos_freezes_rows_like_jax():
    jm, variables, tm = _pair()
    prompt = _prompt((2, 9), 3)
    free = decoding.generate(tm, None, prompt, 12, auto_cache=True).numpy()
    eos = int(free[0, 9 + 2])  # row 0 stops at its third token
    ref = np.asarray(jax_decoding.generate(
        jm, variables, prompt, 12, eos_token=eos, pad_token=0,
        auto_cache=True))
    got = decoding.generate(tm, None, prompt, 12, eos_token=eos,
                            pad_token=0, auto_cache=True).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[0, 9 + 3:] == 0).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 0.0), (1.0, 5, 0.0), (1.3, 0, 0.9), (0.8, 8, 0.8),
    (1.0, 0, 0.3), (0.0, 0, 0.0)])
def test_sample_filters_match_jax(monkeypatch, temperature, top_k, top_p):
    rs = np.random.RandomState(int(temperature * 10) + top_k)
    logits = (rs.standard_normal((6, 64)) * 3.0).astype(np.float32)
    logits[0, :4] = 9.0  # a tie at the top of one row
    noise = rs.gumbel(size=logits.shape).astype(np.float32)
    monkeypatch.setattr(
        jax.random, "categorical",
        lambda key, lg, axis=-1: jnp.argmax(lg + jnp.asarray(noise), axis))
    ref = np.asarray(jax_decoding._sample(
        jnp.asarray(logits), jax.random.PRNGKey(0), temperature, top_k,
        top_p))
    got = decoding._sample(torch.as_tensor(logits), None, temperature, top_k,
                           top_p, noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_top_k_one_sampling_is_greedy():
    _, _, tm = _pair()
    prompt = _prompt((2, 10), 4)
    greedy = decoding.generate(tm, None, prompt, 8, auto_cache=True)
    sampled = decoding.generate(
        tm, None, prompt, 8, temperature=0.9, top_k=1, auto_cache=True,
        rng=torch.Generator().manual_seed(5))
    assert torch.equal(greedy, sampled)


def test_bucketed_cache_len_and_serving_variables():
    for needed in (1, 127, 128, 129, 300, 600, 2048):
        for max_len in (128, 512, 1024):
            assert (decoding._bucketed_cache_len(needed, max_len)
                    == jax_decoding._bucketed_cache_len(needed, max_len))
    sd = {"w": torch.ones(3), "n": torch.ones(3, dtype=torch.int32)}
    cast = decoding.serving_variables(sd, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16
    assert cast["n"].dtype == torch.int32


def test_generate_validation_is_loud():
    _, _, tm = _pair()
    with pytest.raises(ValueError):  # past the cache
        decoding.generate(tm, None, _prompt((1, 100), 5), 40)
    with pytest.raises(ValueError):
        decoding.generate(tm, None, np.zeros((1, 0), np.int32), 4)
    with pytest.raises(ValueError):
        decoding.generate(tm, None, _prompt((1, 4), 5), 4, top_p=1.5)
    jm, variables, _ = _pair()
    with pytest.raises(ValueError, match="prefill must be"):
        decoding.generate(tm, None, _prompt((1, 4), 5), 4, prefill="bogus")
    with pytest.raises(ValueError, match="prefill must be"):
        jax_decoding.generate(jm, variables, _prompt((1, 4), 5), 4,
                              prefill="bogus")


CHUNKED_KW = dict(LM_KW, max_seq_len=256, decode_attention="chunked")


def _chunked_pair():
    """The JAX and port models with ``decode_attention="chunked"`` and a
    256-token context (two 128-slot chunks), on one set of weights."""
    if "chunked" not in _STATE:
        jm = jax_factory.get_model("transformer", dtype=jnp.float32,
                                   **CHUNKED_KW)
        params = nn.meta.unbox(jax.jit(jm.init)(
            jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))["params"])
        tm = factory.get_model("transformer", dtype=torch.float32,
                               device="cpu", **CHUNKED_KW)
        decoding.load_variables(
            tm, convert.params_from_flax(jax.device_get(params), tm.cfg))
        _STATE["chunked"] = (jm, {"params": params}, tm)
    return _STATE["chunked"]


@pytest.mark.watchdog_timeout(120)
def test_chunked_decode_generate_matches_jax():
    """``decode_attention="chunked"``: a prompt of 150 with 40 new tokens
    runs in the 256 bucket, so the prefill and every step walk two chunks;
    greedy tokens equal JAX's."""
    jm, variables, tm = _chunked_pair()
    prompt = _prompt((2, 150), 11)
    ref = np.asarray(jax_decoding.generate(jm, variables, prompt, 40,
                                           auto_cache=True))
    got = decoding.generate(tm, None, prompt, 40, auto_cache=True)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.watchdog_timeout(120)
def test_stepwise_prefill_generate_matches_jax():
    """``prefill="stepwise"`` (the prompt fed token by token) emits JAX's
    stepwise greedy tokens, and here also the batched prefill's."""
    jm, variables, tm = _pair()
    prompt = _prompt((2, 7), 12)
    ref = np.asarray(jax_decoding.generate(jm, variables, prompt, 10,
                                           prefill="stepwise",
                                           auto_cache=True))
    got = decoding.generate(tm, None, prompt, 10, prefill="stepwise",
                            auto_cache=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), decoding.generate(tm, None, prompt, 10,
                                       auto_cache=True).numpy())


@pytest.mark.watchdog_timeout(120)
def test_engine_over_chunked_model_matches_jax_engine():
    """The engine's private prefill cache runs the chunked walk (a
    150-token prompt prefills into the 256 allocation in two 128-slot
    chunks); streams equal the JAX engine's over the same chunked model
    and the port's solo ``generate``, at the engines' defaults (horizon
    8, prefix sharing, swap preemption)."""
    jm, variables, tm = _chunked_pair()
    loads = [(_prompt((150,), 13), 20), (_prompt((40,), 14), 30),
             (_prompt((9,), 15), 12)]
    eng = serving.ServingEngine(tm, None, max_slots=3, page_size=16,
                                num_pages=40, device="cpu")
    jeng = jax_serving.ServingEngine(jm, variables, max_slots=3,
                                     page_size=16, num_pages=40)
    assert eng.runner.prefill_alloc(150) == 256
    handles = [eng.submit(p, n) for p, n in loads]
    jhandles = [jeng.submit(p, n) for p, n in loads]
    eng.run_until_idle()
    jeng.run_until_idle()
    for (p, n), h, jh in zip(loads, handles, jhandles):
        got = h.result(timeout=5)
        assert got == jh.result(timeout=5)
        assert got == decoding.generate(
            tm, None, p[None], n, auto_cache=True)[0, len(p):].tolist()
    assert eng.pool.pages_in_use == 0
