"""The port's engine with grouped KV heads and a prefill in several chunks.

Engines over models with GQA (4 query heads on 2 KV heads) and MQA (4 on
1), prefilling in chunks of 16 and 24 tokens, with an fp32 and an int8
pool: the greedy streams of three 33-token prompts (three chunks at 16,
two at 24) must equal token for token the JAX package's ``generate`` and
the port's solo ``generate`` on the same converted fp32 weights. The
paged decode step runs its plain version here (CPU tensors); the grouped
layouts and the chunked prefill are what the engine around it must get
right. One test per variant runs all four engines, and the JAX streams
come from one batched ``generate`` (one compile), so that a worker
builds each variant's references once and cheaply.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import decoding as jax_decoding
from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu_torch import convert, serving
from tensorflowonspark_tpu_torch.models import decoding, factory

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
KV_HEADS = {"gqa": 2, "mqa": 1}
PROMPT_LEN = 33
SEEDS = (71, 72, 73)
N_NEW = 8
# (prefill_chunk, kv_cache_dtype) of the engines each variant runs.
ENGINES = ((16, ""), (24, ""), (16, "int8"), (24, "int8"))
_MODELS = {}


def _prompts():
    return np.stack([np.random.RandomState(seed).randint(
        1, LM_KW["vocab_size"], size=PROMPT_LEN).astype(np.int32)
        for seed in SEEDS])


def _variant(name):
    """The JAX and port models of a variant on one set of weights, with
    the JAX and port ``generate`` streams of the prompts (made once)."""
    if name not in _MODELS:
        kw = dict(LM_KW, num_kv_heads=KV_HEADS[name])
        jm = jax_factory.get_model("transformer", dtype=jnp.float32, **kw)
        params = nn.meta.unbox(jax.jit(jm.init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
        tm = factory.get_model("transformer", dtype=torch.float32,
                               device="cpu", **kw)
        decoding.load_variables(tm, convert.params_from_flax(
            jax.device_get(params), tm.cfg))
        prompts = _prompts()
        out = jax_decoding.generate(jm, {"params": params}, prompts, N_NEW,
                                    auto_cache=True)
        jax_streams = np.asarray(out)[:, PROMPT_LEN:].tolist()
        port_streams = [
            decoding.generate(tm, None, p[None], N_NEW,
                              auto_cache=True)[0, PROMPT_LEN:].tolist()
            for p in prompts]
        _MODELS[name] = dict(tm=tm, jax=jax_streams, port=port_streams)
    return _MODELS[name]


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("variant", sorted(KV_HEADS))
def test_grouped_kv_engine_streams_match_jax_generate(variant):
    """Every engine of ``ENGINES`` on the variant's model: streams equal
    to JAX ``generate`` and to the port's solo ``generate``, the prefill
    in ceil(33 / prefill_chunk) chunks, no page left in use. Torch runs on
    one thread here: the model is a toy, and a thread pool only competes
    with the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _run_engines(variant)
    finally:
        torch.set_num_threads(threads)


def _run_engines(variant):
    m = _variant(variant)
    assert m["tm"].cfg.kv_heads == KV_HEADS[variant]
    for prefill_chunk, kv_cache_dtype in ENGINES:
        eng = serving.ServingEngine(
            m["tm"], None, max_slots=4, page_size=16, num_pages=32,
            prefill_chunk=prefill_chunk, kv_cache_dtype=kv_cache_dtype,
            decode_horizon=1, prefix_share=False, preempt="off",
            device="cpu")
        chunks = []
        step = eng.runner.prefill_step

        def counted(*args, **kw):
            chunks.append(args[1].shape[1])
            return step(*args, **kw)
        eng.runner.prefill_step = counted
        handles = [eng.submit(p, N_NEW) for p in _prompts()]
        eng.run_until_idle()
        where = "prefill_chunk {} pool {}".format(prefill_chunk,
                                                  kv_cache_dtype or "fp32")
        assert len(chunks) == len(SEEDS) * -(-PROMPT_LEN // prefill_chunk), \
            where
        for h, want_jax, want_port in zip(handles, m["jax"], m["port"]):
            assert h.state == serving.FINISHED, where
            got = h.result(timeout=5)
            assert got == want_port, where
            assert got == want_jax, where
        assert eng.pool.pages_in_use == 0, where
        assert eng.stats()["kv_cache_dtype"] == (kv_cache_dtype or "fp"), \
            where
