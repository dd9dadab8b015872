"""Shared fixtures of the port's serving tests (not a test module).

One toy fp32 geometry (``LM_KW``, as ``tests/test_torch_serving.py``), the
JAX model's seeded weights converted by ``convert.params_from_flax`` into
the port's model, and engines built lazily once per test process: under
``--dist load`` every xdist worker builds its own, so each is small and
built only by the tests that need it.
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
from tensorflowonspark_tpu_torch.serving import runner as runner_mod

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
# The geometry of the JAX package's own engine drills
# (tests/test_serving_engine.py): 4 slots, page 16, 32 pages, horizon 4.
ENGINE_KW = dict(max_slots=4, page_size=16, num_pages=32, decode_horizon=4)
_STATE = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread during each test of a module that imports this
    fixture: the model is a toy, and under xdist a thread pool per worker
    only competes with the other workers for the cores (ten times slower
    with six workers on eight cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def models():
    """``{"jm", "variables", "tm"}``: the JAX model and its variables, and
    the port's model holding the same weights."""
    if not _STATE:
        jm = jax_factory.get_model("transformer", dtype=jnp.float32, **LM_KW)
        params = nn.meta.unbox(jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
        tm = factory.get_model("transformer", dtype=torch.float32,
                               device="cpu", **LM_KW)
        decoding.load_variables(tm, convert.params_from_flax(
            jax.device_get(params), tm.cfg))
        _STATE.update(jm=jm, variables={"params": params}, tm=tm)
    return _STATE


def engine(**kw):
    """A fresh port engine at ``ENGINE_KW`` (overridden by ``kw``)."""
    args = dict(ENGINE_KW, device="cpu")
    args.update(kw)
    return serving.ServingEngine(models()["tm"], None, **args)


def shared_engine():
    """The process's port engine at ``ENGINE_KW`` and the defaults
    (prefix sharing, swap preemption); every test leaves it drained."""
    if "engine" not in _STATE:
        _STATE["engine"] = engine()
    return _STATE["engine"]


def jax_engine(**kw):
    """The JAX engine at ``ENGINE_KW`` updated by ``kw``, built once per
    distinct ``kw``."""
    args = dict(ENGINE_KW)
    args.update(kw)
    key = ("jax_engine",) + tuple(sorted(args.items()))
    if key not in _STATE:
        m = models()
        _STATE[key] = jax_serving.ServingEngine(m["jm"], m["variables"],
                                                **args)
    return _STATE[key]


def prompt(n, seed=0):
    return np.random.RandomState(seed).randint(
        1, LM_KW["vocab_size"], size=n).astype(np.int32)


def solo(p, n_new):
    """The port's solo greedy ``generate`` stream."""
    out = decoding.generate(models()["tm"], None, np.asarray(p)[None],
                            n_new, auto_cache=True)
    return out[0, len(p):].tolist()


def jax_solo(p, n_new):
    """The JAX package's solo greedy ``generate`` stream."""
    m = models()
    out = jax_decoding.generate(m["jm"], m["variables"], np.asarray(p)[None],
                                n_new, auto_cache=True)
    return np.asarray(out)[0, len(p):].tolist()


def assert_drained(eng):
    """No page, slot or queue entry is left once every request ended."""
    assert eng.pool.pages_in_use == 0
    assert eng.scheduler.queued() == 0
    assert all(s is None for s in eng.scheduler.slots)


# The JAX int8 engine keeps a multi-token call's own tokens unquantized (a
# decode horizon's deferred-write window, the speculative verify's causal
# window) until the call's flush, while the port quantizes each token as it
# is written (amax/127 per token and KV head); the attention over those
# tokens therefore differs, and so can a near-tied argmax. The JAX streams
# are held teacher-forced against the port's int8 pool: at every step, the
# JAX token's port logit within INT8_TF_TOL of the port's largest. The
# limit lies above the largest difference an unquantized cache makes at
# all along the horizon streams — a whole fp32 pool against the int8 one
# moved a logit by at most 6.2e-3 — and a window quantizes fewer tokens
# than that.
INT8_TF_TOL = 1e-2


def teacher_forced_int8_logits(p, stream, page_size=16):
    """Port int8-pool logits along ``stream`` (the prompt's fp prefill,
    then one paged step per token), as a (len(stream), vocab) array."""
    tm = models()["tm"]
    r = runner_mod.ModelRunner(tm, None, max_slots=1, page_size=page_size,
                               num_pages=12, kv_quant="int8")
    alloc = r.prefill_alloc(len(p))
    pc, last = r.prefill_step(r.new_prefill_cache(alloc), p[None],
                              len(p) - 1, alloc)
    pages = list(range(1, 1 + r.table_width))
    r.scatter(pc, pages, len(p), alloc)
    table = torch.as_tensor(np.asarray([pages], np.int32))
    rows = [last.numpy()]
    with torch.no_grad():
        for j, tok in enumerate(stream[:-1]):
            lg = tm(torch.tensor([[tok]]), decode=True, pages=table,
                    seq_lens=torch.tensor([len(p) + j], dtype=torch.int32),
                    cache=r.cache)
            rows.append(lg[0, 0].numpy())
    return np.stack(rows)
