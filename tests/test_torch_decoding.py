"""The port's solo decoding path held against the JAX package's.

Greedy ``generate`` emits exactly JAX ``decoding.generate(auto_cache=True)``
's tokens in fp32 on converted weights. Sampling cannot share random bits
across ``jax.random`` and ``torch.Generator``, so the filter semantics are
pinned instead: both ``_sample``s get the same logits and the same numpy
Gumbel noise (JAX's categorical is argmax(logits + Gumbel)) and must pick
the same tokens.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import decoding as jax_decoding
from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import decoding, factory

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
_STATE = {}


def _pair():
    if not _STATE:
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
    with pytest.raises(NotImplementedError):
        decoding.generate(tm, None, _prompt((1, 4), 5), 4,
                          prefill="stepwise")
