"""The port's ``TransformerLM`` held against the JAX model.

Both models compute with the same weights — the JAX model's seeded init,
converted by ``convert.params_from_flax`` — on the same numpy tokens, at
the fp32 toy geometry of ``tests/test_serving_engine.py`` (MHA and a GQA
variant): full-forward logits, decode-mode prefill plus contiguous-cache
steps, and the paged single-token step against ``paged_attention_impl=
"pallas"`` (interpret mode), with an f32 and an int8 pool. fp32 logits
agree to 1e-5 (the frameworks reduce in different orders). A bf16 model
is held to a looser bound, stated where it is checked. The chunked cache
attention (``decode_attention="chunked"``) is held against the JAX
function at 1e-6.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import decoding as jax_decoding
from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.models import transformer as jax_transformer
from tensorflowonspark_tpu_torch import convert, device_info
from tensorflowonspark_tpu_torch.models import decoding, factory, transformer

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
_STATE = {}


def _pair(num_kv_heads=0, dtype="f32"):
    """(jax model, jax variables, port model) sharing one set of weights."""
    key = (num_kv_heads, dtype)
    if key not in _STATE:
        jdt, tdt = {"f32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        jm = jax_factory.get_model("transformer", dtype=jdt,
                                   num_kv_heads=num_kv_heads, **LM_KW)
        params = nn.meta.unbox(jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
        tm = factory.get_model("transformer", dtype=tdt, device="cpu",
                               num_kv_heads=num_kv_heads, **LM_KW)
        decoding.load_variables(
            tm, convert.params_from_flax(jax.device_get(params), tm.cfg))
        _STATE[key] = (jm, {"params": params}, tm)
    return _STATE[key]


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(
        1, LM_KW["vocab_size"], size=shape).astype(np.int32)


@pytest.mark.parametrize("num_kv_heads", [0, 2], ids=["mha", "gqa"])
def test_full_forward_logits_match_jax(num_kv_heads):
    jm, variables, tm = _pair(num_kv_heads)
    toks = _tokens((2, 24), 0)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(toks)))
    got = tm(torch.as_tensor(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_packed_segments_match_jax():
    """Packed rows: segment masks and per-document positions derived from
    ``segment_ids``, padding queries zeroed."""
    jm, variables, tm = _pair()
    toks = _tokens((2, 16), 1)
    seg = np.array([[1] * 6 + [2] * 7 + [0] * 3, [1] * 16], np.int32)
    apply = jax.jit(lambda v, t, s: jm.apply(v, t, segment_ids=s))
    ref = np.asarray(apply(variables, jnp.asarray(toks), jnp.asarray(seg)))
    got = tm(torch.as_tensor(toks), segment_ids=torch.as_tensor(seg))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("num_kv_heads", [0, 2], ids=["mha", "gqa"])
def test_decode_prefill_and_cache_steps_match_jax(num_kv_heads):
    """A batched prefill through the contiguous cache, then single-token
    steps: logits track the JAX decode path at every call."""
    jm, variables, tm = _pair(num_kv_heads)
    jm = jm.clone(cfg=dataclasses.replace(jm.cfg, decode_cache_len=32))
    prompt, steps = _tokens((2, 9), 2), _tokens((2, 5), 3)
    jcache = jax_decoding.init_cache(jm, variables, 2)
    tcache = decoding.init_cache(tm, 2, 32)
    calls = [prompt] + [steps[:, i:i + 1] for i in range(steps.shape[1])]
    step = jax.jit(lambda v, c, t: jm.apply(
        {**v, "cache": c}, t, decode=True, mutable=["cache"]))
    for toks in calls:
        ref, upd = step(variables, jcache, jnp.asarray(toks))
        jcache = upd["cache"]
        got = tm(torch.as_tensor(toks), decode=True, cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert tcache["position"] == 9 + 5
    assert tcache["block_0"]["cache_index"] == 9 + 5


def _jax_paged_step(jm):
    @jax.jit
    def step(variables, cache, toks, table, lens):
        logits, upd = jm.apply({**variables, "cache": cache}, toks,
                               decode=True, pages=table, seq_lens=lens,
                               mutable=["cache"])
        return logits, upd["cache"]
    return step


@pytest.mark.parametrize("kv_quant,atol", [("", 1e-5), ("int8", 1e-4)])
def test_paged_step_matches_jax_pallas_kernel(kv_quant, atol):
    """Stepping tokens through the paged pool (page size 4, so the walk
    crosses pages) against the JAX model dispatching to its Pallas
    kernel in interpret mode; the pools end up equal too."""
    ps, n_pages = 4, 12
    jm, variables, tm = _pair()
    jm = jm.clone(cfg=dataclasses.replace(
        jm.cfg, page_size=ps, num_pages=n_pages, kv_quant=kv_quant,
        paged_attention_impl="pallas"))
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    toks = _tokens((2, 10), 4)
    _, shapes = jax.eval_shape(
        lambda v, t, pg, sl: jm.apply(v, t, decode=True, pages=pg,
                                      seq_lens=sl, mutable=["cache"]),
        variables, jnp.zeros((2, 1), jnp.int32), jnp.asarray(table),
        jnp.zeros((2,), jnp.int32))
    jcache = jax.tree_util.tree_map(
        lambda sd: jnp.zeros(sd.shape, sd.dtype), shapes["cache"])
    step = _jax_paged_step(jm)
    pages_dtype = torch.int8 if kv_quant else torch.float32
    pool = {}
    for i in range(LM_KW["num_layers"]):
        layer = {name: torch.zeros((n_pages, ps, 4, 8), dtype=pages_dtype)
                 for name in ("k_pages", "v_pages")}
        if kv_quant:
            layer.update({name: torch.zeros((n_pages, ps, 4))
                          for name in ("k_scales", "v_scales")})
        pool["block_{}".format(i)] = layer
    for t in range(toks.shape[1]):
        lens = np.full((2,), t, np.int32)
        ref, jcache = step(variables, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.asarray(table), jnp.asarray(lens))
        got = tm(torch.as_tensor(toks[:, t:t + 1]), decode=True,
                 pages=torch.as_tensor(table), seq_lens=torch.as_tensor(lens),
                 cache=pool)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      np.asarray(ref).argmax(-1))
    jpool = {name: np.asarray(val, np.float32)
             for name, val in jcache["block_0"]["attn"].items()}
    tpool = {name: val.float().numpy()
             for name, val in pool["block_0"].items()}
    for kv in ("k", "v"):
        if kv_quant:
            # Equal up to one quantization step where x/scale sat on a
            # rounding boundary.
            got = tpool[kv + "_pages"] * tpool[kv + "_scales"][..., None]
            ref = jpool[kv + "_pages"] * jpool[kv + "_scales"][..., None]
            tol = jpool[kv + "_scales"].max() * 1.01
        else:
            got, ref, tol = tpool[kv + "_pages"], jpool[kv + "_pages"], 1e-5
        np.testing.assert_allclose(got, ref, atol=tol)


def test_bf16_forward_close_to_jax():
    """bf16: both frameworks round at the same points (projections,
    scores, probabilities in bf16; softmax and layer-norm statistics in
    f32) but fuse elementwise work differently (GELU, residual adds), so
    logits of O(1) magnitude differ by a few bf16 ulps: bound 0.1."""
    jm, variables, tm = _pair(dtype="bf16")
    toks = _tokens((2, 24), 5)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(toks)))
    got = tm(torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, ref, atol=0.1)


def test_kv_quantize_matches_jax():
    x = np.random.RandomState(6).standard_normal((5, 3, 8)).astype(
        np.float32)
    x[1, 2] = 0.0  # all-zero row: floor scale, exact zeros back
    jq, js = jax_transformer._kv_quantize(jnp.asarray(x))
    tq, ts = transformer._kv_quantize(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = transformer._kv_dequantize(tq, ts, torch.float32).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jax_transformer._kv_dequantize(jq, js,
                                                        jnp.float32)))
    assert (back[1, 2] == 0).all()


def test_config_validation_mirrors_jax():
    for bad in (dict(decode_cache_len=4096), dict(decode_attention="x"),
                dict(page_size=8), dict(page_size=8, num_pages=1),
                dict(kv_quant="int4"), dict(kv_quant="int8"),
                dict(paged_attention_impl="triton")):
        with pytest.raises(ValueError):
            jax_transformer.TransformerConfig(**bad)
        with pytest.raises(ValueError):
            transformer.TransformerConfig(**bad)
    # The port's paged step has one route, the kernel.
    assert transformer.TransformerConfig().paged_attention_impl == "pallas"
    with pytest.raises(ValueError, match="not ported"):
        transformer.TransformerConfig(paged_attention_impl="lax")


def test_model_builds_on_the_card_by_default():
    """``device`` defaults to the card; with none present the factory
    raises instead of quietly building on the CPU."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.get_model("transformer", **LM_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.get_model("transformer", device="cuda", **LM_KW)


def test_device_info_never_guesses_on_the_cpu():
    assert device_info.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_info.resolve_device()
    with pytest.raises(ValueError):
        device_info.resolve_device("meta")
    assert device_info.card() is None
    assert device_info.peak_bandwidth() is None
    assert device_info.peak_ops("bf16") is None


def test_unported_impls_raise():
    """The sequence-parallel implementations are ported: without a seq
    axis they run dense attention, as the JAX dispatcher falls back, so
    the model equals the dense one (``tests/test_torch_sharded_trainer.py``
    holds them over a mesh); zigzag is a ring_flash layout only."""
    tokens = torch.arange(1, 9, dtype=torch.int64)[None]
    dense = factory.get_model("transformer", device="cpu",
                              attention_impl="dense", dtype=torch.float32,
                              **LM_KW)(tokens)
    for impl in ("ring", "ring_flash", "ulysses"):
        tm = factory.get_model("transformer", device="cpu",
                               attention_impl=impl, dtype=torch.float32,
                               **LM_KW)
        assert torch.equal(tm(tokens), dense)
    tm = factory.get_model("transformer", device="cpu",
                           attention_impl="ulysses", ring_layout="zigzag",
                           dtype=torch.float32, **LM_KW)
    with pytest.raises(ValueError, match="ring_flash schedule"):
        tm(tokens)


# (cache_len, cache index i, s_step, kv heads): one chunk and several, a
# cache_len no multiple of the chunk (its last chunk clamps back), a call
# crossing a chunk boundary, one step and several, MHA, GQA and MQA.
CHUNKED_CASES = [(100, 40, 1, 4), (100, 60, 7, 2), (256, 200, 1, 4),
                 (256, 120, 9, 2), (200, 190, 1, 4), (200, 180, 5, 1),
                 (256, 255, 1, 4)]


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("case", CHUNKED_CASES,
                         ids=lambda c: "len{}_i{}_s{}_kv{}".format(*c))
def test_chunked_cache_attention_matches_jax(case):
    """``_chunked_cache_attention`` against the JAX function on the same
    f32 inputs: within 1e-6 (largest reading 2.4e-7 on outputs up to
    0.8; the frameworks sum the products in other orders). A cache of at
    most one chunk takes the dense formulation, bitwise the port's dense
    decode attention."""
    cache_len, i, s_step, h_kv = case
    rs = np.random.RandomState(cache_len + i + s_step)
    q = rs.standard_normal((2, s_step, 4, 8)).astype(np.float32)
    k = rs.standard_normal((2, cache_len, h_kv, 8)).astype(np.float32)
    v = rs.standard_normal((2, cache_len, h_kv, 8)).astype(np.float32)
    want = np.asarray(jax_transformer._chunked_cache_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), i, cache_len))
    got = transformer._chunked_cache_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), i,
        cache_len)
    assert got.shape == (2, s_step, 4, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if cache_len <= 128:
        cfg = transformer.TransformerConfig(
            vocab_size=8, num_layers=1, num_heads=4, num_kv_heads=h_kv,
            embed_dim=32, mlp_dim=8, dtype=torch.float32)
        attn = transformer.Attention(cfg)
        kc, vc = torch.as_tensor(k).clone(), torch.as_tensor(v).clone()
        cache = {"cached_key": kc, "cached_value": vc, "cache_index": i}
        dense = attn._decode_step(
            torch.as_tensor(q), kc[:, i:i + s_step].clone(),
            vc[:, i:i + s_step].clone(), cache, None, None)
        assert torch.equal(got, dense)
