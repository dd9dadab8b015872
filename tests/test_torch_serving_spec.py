"""The port's speculative decoding against the JAX package's.

A draft (the registry's ``gpt2-draft`` at the toy geometry) proposes k
tokens a row; the target verifies them in one forward through its paged
pool: the window's K/V written in place, then the paged-attention wrapper
(its plain version here) over ``rows x (k + 1)`` virtual rows. Greedy fp32
streams of the port's speculative engine must equal the JAX engine's on the
same weights and the port's solo ``generate``, token for token, with the
same ``spec_rounds``, ``spec_drafted`` and ``spec_accepted``: the JAX
package's seven drills (``tests/test_serving_engine.py``: a noise draft,
a join, a swap preemption, a mixed batch, full acceptance, constructor
validation, telemetry), a round straddling ``max_seq_len``, and int8 pools
(held teacher-forced, as the horizon tests hold them). ``runner.verify``
must give per position the greedy of W one-token steps, and its pool rows
and greedy must equal the JAX runner's after its flush, for the dense LM
and the MoE LM.
"""

import importlib.util
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu.models import decoding as jax_decoding
from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.serving import runner as jax_runner_mod
from tensorflowonspark_tpu_torch import convert, serving, telemetry
from tensorflowonspark_tpu_torch.models import decoding, factory
from tensorflowonspark_tpu_torch.ops import paged_attention as pa
from tensorflowonspark_tpu_torch.serving import runner as runner_mod
from torch_serving_common import (
    ENGINE_KW, INT8_TF_TOL, LM_KW, assert_drained, models, prompt, solo,
    teacher_forced_int8_logits,
)
from torch_serving_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.watchdog_timeout(120)

K = 3
PAGE = ENGINE_KW["page_size"]
# Pool rows of the port's verify against the JAX runner's flushed pool, in
# fp32: the same projections, rounded by two libraries' GEMMs.
POOL_TOL = 1e-5
_SPEC_COUNTERS = ("spec_rounds", "spec_drafted", "spec_accepted")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STATE = {}


def _load(name):
    """A module of the repo's root (``bench.py``, ``chip_smoke.py``)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_ROOT, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _draft_pair(vocab_size=None, seed=7):
    """The JAX ``gpt2-draft`` at the toy geometry, initialised from
    ``PRNGKey(seed)`` (the JAX drills' draft), and the port's draft holding
    the same weights: ``(jax model, jax variables, port model)``."""
    key = ("draft", vocab_size, seed)
    if key not in _STATE:
        kw = dict(LM_KW, vocab_size=vocab_size or LM_KW["vocab_size"])
        jd = jax_factory.get_model("gpt2-draft", dtype=jnp.float32, **kw)
        params = nn.meta.unbox(jax.jit(jd.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])
        td = factory.get_model("gpt2-draft", dtype=torch.float32,
                               device="cpu", **kw)
        decoding.load_variables(td, convert.params_from_flax(
            jax.device_get(params), td.cfg))
        _STATE[key] = (jd, {"params": params}, td)
    return _STATE[key]


def _port_spec(draft="noise", **kw):
    """A port engine at ``ENGINE_KW`` with a draft: the noise draft, or the
    target itself (``draft="target"``)."""
    m = models()
    td = m["tm"] if draft == "target" else _draft_pair()[2]
    args = dict(ENGINE_KW, device="cpu", draft_model=td,
                draft_variables=td.state_dict(), speculative_tokens=K)
    args.update(kw)
    return serving.ServingEngine(m["tm"], None, **args)


def _jax_spec(draft="noise", **kw):
    m = models()
    jd, jvars = ((m["jm"], m["variables"]) if draft == "target"
                 else _draft_pair()[:2])
    args = dict(ENGINE_KW, draft_model=jd, draft_variables=jvars,
                speculative_tokens=K)
    args.update(kw)
    return jax_serving.ServingEngine(m["jm"], m["variables"], **args)


@pytest.fixture(scope="module")
def pair():
    """The shared speculative engines, port and JAX, with a random-init
    draft: acceptance sits near zero, so every round rolls back. Every
    test leaves both drained; the same tests run on both in one order, so
    their histories agree."""
    return _port_spec(), _jax_spec()


def _counts(eng):
    return {k: getattr(eng, k) for k in _SPEC_COUNTERS}


def _deltas(eng, before):
    return {k: getattr(eng, k) - before[k] for k in _SPEC_COUNTERS}


def _on_both(pair, drive):
    """``drive(engine)`` on the port's and the JAX engine; returns
    ``[(handles, counter deltas)]``, port first."""
    out = []
    for eng in pair:
        before = _counts(eng)
        handles = drive(eng)
        out.append((handles, _deltas(eng, before)))
    return out


def _results(handles):
    return [h.result(timeout=5) for h in handles]


# -- the acceptance rule and the draft geometry -----------------------------


@pytest.mark.parametrize("accept", ["none", "partial", "full"])
def test_speculative_lengths_match_jax(accept):
    rs = np.random.RandomState({"none": 0, "partial": 1, "full": 2}[accept])
    rows, k = 6, 5
    greedy = rs.randint(0, 50, size=(rows, k + 1))
    draft = greedy[:, :k].copy()
    if accept == "none":
        draft[:, 0] = greedy[:, 0] + 1
    elif accept == "partial":
        for r, cut in enumerate([0, 1, 2, 4, 5, 3]):
            if cut < k:
                draft[r, cut] += 1
    got = decoding.speculative_lengths(draft, greedy)
    want = jax_decoding.speculative_lengths(draft, greedy)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    accepted, emitted = got
    if accept == "full":
        assert (accepted == k).all() and (emitted == k).all()
    if accept == "none":
        assert (accepted == 0).all() and (emitted == 1).all()
    if accept == "partial":
        assert accepted.tolist() == [0, 1, 2, 4, 5, 3]
        assert emitted.tolist() == [1, 2, 3, 5, 5, 4]


def test_gpt2_draft_matches_jax_registry():
    jd = jax_factory.get_model("gpt2-draft")
    td = factory.get_model("gpt2-draft", dtype=torch.float32, device="cpu",
                           num_layers=1, embed_dim=32, num_heads=4,
                           mlp_dim=64, vocab_size=64)
    for f in ("vocab_size", "num_layers", "num_heads", "embed_dim",
              "mlp_dim", "max_seq_len", "remat", "decode_attention"):
        want = getattr(jd.cfg, f)
        assert factory.GPT2_DRAFT[f] == want, f
    # Overrides merge over the defaults, as in the JAX registry.
    assert (td.cfg.num_layers, td.cfg.max_seq_len, td.cfg.decode_attention,
            td.cfg.remat) == (1, 512, "chunked", False)


def test_stem_sharing_pair_matches_bench():
    """``chip_smoke.stem_sharing_pair`` on the port gives the parameters
    of ``bench.py``'s ``_speculative_pair`` (converted), and the pair's
    draft computes its target's logits bitwise (the zeroed blocks add 0),
    which are the JAX target's."""
    bench, smoke = _load("bench"), _load("chip_smoke")
    kw = dict(vocab_size=64, num_layers=4, num_heads=4, embed_dim=32,
              mlp_dim=64, max_seq_len=128, dtype=jnp.float32)
    jm, jvars, _ = bench._serving_model(kw)
    _, jtarget, _, jdraft_vars, _ = bench._speculative_pair(kw)
    jvars, jtarget, jdraft_vars = (nn.meta.unbox(v) for v in (
        jvars, jtarget, jdraft_vars))
    tm = factory.get_model("transformer", dtype=torch.float32, device="cpu",
                           vocab_size=64, num_layers=4, num_heads=4,
                           embed_dim=32, mlp_dim=64, max_seq_len=128,
                           decode_attention="chunked", remat=False)
    sd = convert.params_from_flax(jvars["params"], tm.cfg)
    target, draft, draft_vars = smoke.stem_sharing_pair(torch, tm, sd)
    assert draft.cfg.num_layers == 2
    want = convert.params_from_flax(jtarget["params"], tm.cfg)
    want_draft = convert.params_from_flax(jdraft_vars["params"], draft.cfg)
    assert set(target) == set(want) and set(draft_vars) == set(want_draft)
    for got, ref in ((target, want), (draft_vars, want_draft)):
        for name in ref:
            assert torch.equal(got[name], ref[name]), name
    toks = prompt(20, 217)[None]
    decoding.load_variables(tm, target)
    decoding.load_variables(draft, draft_vars)
    with torch.no_grad():
        t_logits = tm(torch.as_tensor(toks).long())
        d_logits = draft(torch.as_tensor(toks).long())
    assert torch.equal(t_logits, d_logits)
    j_logits = np.asarray(jm.apply(jtarget, jnp.asarray(toks)))
    np.testing.assert_allclose(t_logits.numpy(), j_logits, rtol=0,
                               atol=1e-5)


# -- the kernel route: one call over b * W virtual rows ---------------------


@pytest.mark.parametrize("kind", ["mha_f32", "gqa_int8"])
def test_paged_attention_window_equals_one_token_calls(kind):
    """Query j of a row attends as a one-token call at ``seq_len + j``
    does, bitwise, and the window is one wrapper call."""
    g = torch.Generator().manual_seed(3)
    b, w, h, d, ps, tw = 3, 4, 4, 8, 16, 5
    h_kv = 4 if kind == "mha_f32" else 2
    n_pages = 1 + b * tw
    table = (1 + torch.randperm(n_pages - 1, generator=g)).reshape(
        b, tw).to(torch.int32)
    lens = torch.tensor([0, 15, 60], dtype=torch.int32)
    q = torch.randn(b, w, h, d, generator=g)
    scales = {}
    if kind == "gqa_int8":
        kp = torch.randint(-127, 128, (n_pages, ps, h_kv, d),
                           generator=g).to(torch.int8)
        vp = torch.randint(-127, 128, (n_pages, ps, h_kv, d),
                           generator=g).to(torch.int8)
        scales = dict(k_scales=torch.rand(n_pages, ps, h_kv, generator=g),
                      v_scales=torch.rand(n_pages, ps, h_kv, generator=g))
    else:
        kp = torch.randn(n_pages, ps, h_kv, d, generator=g)
        vp = torch.randn(n_pages, ps, h_kv, d, generator=g)
    before = pa.launches
    got = pa.paged_attention_window(q, kp, vp, table, lens, page_size=ps,
                                    **scales)
    assert got.shape == (b, w, h, d) and pa.launches == before
    for j in range(w):
        one = pa.paged_attention(q[:, j:j + 1].contiguous(), kp, vp, table,
                                 lens + j, page_size=ps, **scales)
        assert torch.equal(got[:, j:j + 1], one), j


# -- runner.verify -----------------------------------------------------------


def _prefilled_port_runner(model, kv_quant, loads, page_size=PAGE):
    """A port runner whose rows hold ``loads``' prompts (prefill + scatter;
    the last row inactive); returns (runner, table, lens)."""
    r = runner_mod.ModelRunner(model, None, max_slots=len(loads) + 1,
                               page_size=page_size, num_pages=24,
                               extra_table_tokens=K, kv_quant=kv_quant)
    return (r,) + _prefill_rows(r, loads)


def _prefill_rows(r, loads):
    table = np.zeros((r.max_slots, r.table_width), np.int32)
    lens = np.zeros((r.max_slots,), np.int32)
    for i, p in enumerate(loads):
        table[i] = 1 + i * r.table_width + np.arange(r.table_width)
        alloc = r.prefill_alloc(len(p))
        pc, _ = r.prefill_step(r.new_prefill_cache(alloc), p[None],
                               len(p) - 1, alloc)
        r.scatter(pc, table[i], len(p), alloc)
        lens[i] = len(p)
    return table, lens


def _verify_tokens(rows, seed):
    return np.random.RandomState(seed).randint(
        1, LM_KW["vocab_size"], size=(rows, K + 1)).astype(np.int32)


_LOADS = [prompt(9, 31), prompt(20, 32), prompt(16, 33)]


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_verify_equals_one_token_steps(kv_quant):
    """W teacher-forced one-token decode calls at ``lens .. lens + W - 1``
    give the verify's greedy at every position, and leave the same pool."""
    tm = models()["tm"]
    rv, table, lens = _prefilled_port_runner(tm, kv_quant, _LOADS)
    rs, _, _ = _prefilled_port_runner(tm, kv_quant, _LOADS)
    toks = _verify_tokens(rv.max_slots, 5)
    greedy = rv.verify(toks, table, lens)
    assert greedy.shape == toks.shape and greedy.dtype == np.int32
    zeros = np.zeros((rs.max_slots,), np.int32)
    for j in range(K + 1):
        step = rs.decode(toks[:, j], table, lens + j, zeros.astype(
            np.float32), zeros, zeros.astype(np.float32), horizon=1,
            sampling=False)
        np.testing.assert_array_equal(greedy[:, j], step[:, 0])
    for key, layer in rv.cache.items():
        for name, t in layer.items():
            assert torch.equal(t, rs.cache[key][name]), (key, name)


def _moe_models():
    if "moe" not in _STATE:
        kw = dict(LM_KW, num_experts=4, moe_every=2)
        jm = jax_factory.get_model("moe_transformer", dtype=jnp.float32, **kw)
        params = nn.meta.unbox(jax.jit(jm.init)(
            jax.random.PRNGKey(11), jnp.zeros((1, 8), jnp.int32))["params"])
        tm = factory.get_model("moe_transformer", dtype=torch.float32,
                               device="cpu", **kw)
        decoding.load_variables(tm, convert.params_from_flax(
            jax.device_get(params), tm.cfg))
        _STATE["moe"] = (jm, {"params": params}, tm)
    return _STATE["moe"]


@pytest.mark.parametrize("lm", ["dense", "moe"])
def test_verify_matches_jax_runner_and_flushed_pool(lm):
    """The port's verify and the JAX runner's on the same weights and
    rows: the same greedy at every position, and the window's pool rows
    (the JAX runner's after its flush) equal to ``POOL_TOL``."""
    if lm == "dense":
        m = models()
        jm, jvars, tm = m["jm"], m["variables"], m["tm"]
    else:
        jm, jvars, tm = _moe_models()
    r, table, lens = _prefilled_port_runner(tm, "", _LOADS)
    jr = jax_runner_mod.ModelRunner(
        jm, jvars, max_slots=r.max_slots, page_size=PAGE, num_pages=24,
        extra_table_tokens=K)
    assert jr.table_width == r.table_width
    _prefill_rows(jr, _LOADS)
    toks = _verify_tokens(r.max_slots, 6)
    toks[:len(_LOADS), 1:] = 7   # a repeated proposal, as a draft makes
    got = r.verify(toks, table, lens)
    want = np.asarray(jr.verify(toks, table, lens))
    np.testing.assert_array_equal(got[:len(_LOADS)], want[:len(_LOADS)])
    for i in range(len(_LOADS)):
        pos = lens[i] + np.arange(K + 1)
        slots = table[i][pos // PAGE] * PAGE + pos % PAGE
        for key in r.cache:
            for name in ("k_pages", "v_pages"):
                port = r.cache[key][name].reshape(
                    -1, *r.cache[key][name].shape[2:])[slots]
                jx = np.asarray(jr.cache[key]["attn"][name]).reshape(
                    (-1,) + port.shape[1:])[slots]
                np.testing.assert_allclose(port.numpy(), jx, rtol=0,
                                           atol=POOL_TOL)


# -- the engine: the JAX package's drills ------------------------------------


def test_speculative_stream_matches_jax_solo_and_counts(pair):
    p1, p2 = prompt(12, 200), prompt(9, 201)

    def drive(eng):
        hs = [eng.submit(p1, 10), eng.submit(p2, 6)]
        eng.run_until_idle()
        return hs

    (hs, d), (jhs, jd) = _on_both(pair, drive)
    got = _results(hs)
    assert got == _results(jhs) == [solo(p1, 10), solo(p2, 6)]
    assert d == jd and d["spec_rounds"] > 0
    assert d["spec_drafted"] >= K * d["spec_rounds"]
    assert 0 <= d["spec_accepted"] <= d["spec_drafted"]
    eng = pair[0]
    assert_drained(eng)
    st = eng.stats()
    assert st["speculative_tokens"] == K
    assert st["spec_rounds"] == eng.spec_rounds
    assert st["spec_acceptance_rate"] == pytest.approx(
        eng.spec_accepted / max(1, eng.spec_drafted))


def test_speculative_join_mid_batch_matches_jax_and_solo(pair):
    """A request admitted into a speculating batch: its draft rows are
    cold (replayed inside the next round), and no stream is perturbed."""
    ps = prompt(12, 202), prompt(20, 203), prompt(7, 204)

    def drive(eng):
        h1 = eng.submit(ps[0], 12)
        eng.step()
        eng.step()
        h2 = eng.submit(ps[1], 8)
        eng.step()
        h3 = eng.submit(ps[2], 4)
        eng.run_until_idle()
        return [h1, h2, h3]

    (hs, d), (jhs, jd) = _on_both(pair, drive)
    got = _results(hs)
    assert got == _results(jhs)
    assert got == [solo(ps[0], 12), solo(ps[1], 8), solo(ps[2], 4)]
    assert d == jd
    assert_drained(pair[0])


def test_speculative_swap_preempt_resume_matches_jax_and_solo(pair):
    """A swap preemption under speculation: p=100, g=10 reserves
    ceil((110 + 3) / 16) = 8 of 31 pages, so three residents block a
    fourth of higher priority; the victim's draft rows go stale with its
    slot, and its resume replays them."""
    lowp = [prompt(100, 205 + i) for i in range(3)]
    hi_p = prompt(100, 208)

    def drive(eng):
        lows = [eng.submit(p, 10) for p in lowp]
        eng.step()
        assert all(h.state == serving.RUNNING for h in lows)
        hi = eng.submit(hi_p, 10, priority=1)
        eng.run_until_idle()
        return lows + [hi]

    preempts = [e.scheduler.preemptions for e in pair]
    (hs, d), (jhs, jd) = _on_both(pair, drive)
    assert [e.scheduler.preemptions - n for e, n in zip(pair, preempts)] \
        == [1, 1]
    assert hs[2]._req.preempt_count == jhs[2]._req.preempt_count == 1
    got = _results(hs)
    assert got == _results(jhs) == [solo(p, 10) for p in lowp + [hi_p]]
    assert d == jd
    assert_drained(pair[0])


def test_speculative_mixed_batch_falls_back_and_recovers(pair):
    """A sampled request turns rounds off (normal horizon decode, draft
    rows marked stale); once it leaves, rounds resume after a replay. The
    greedy stream and the counts stay the JAX engine's."""
    pg = prompt(14, 209)

    def drive(eng):
        g = eng.submit(pg, 12)
        eng.step()
        s = eng.submit(prompt(8, 210), 3, temperature=0.8, top_k=8)
        eng.run_until_idle()
        return [g, s]

    (hs, d), (jhs, jd) = _on_both(pair, drive)
    assert hs[0].result(timeout=5) == jhs[0].result(timeout=5) \
        == solo(pg, 12)
    assert len(hs[1].result(timeout=5)) == len(jhs[1].result(timeout=5)) == 3
    assert d == jd and d["spec_rounds"] > 0
    assert_drained(pair[0])


def test_speculative_full_acceptance_extent_lockstep():
    """Draft == target: every proposal accepted, the emitted cap keeping
    both extents in lockstep; streams and counts the JAX engine's."""
    p1, p2 = prompt(11, 211), prompt(16, 212)

    def drive(eng):
        hs = [eng.submit(p1, 8), eng.submit(p2, 8)]
        eng.run_until_idle()
        return hs

    engines = (_port_spec("target", max_slots=2),
               _jax_spec("target", max_slots=2))
    (hs, d), (jhs, jd) = _on_both(engines, drive)
    assert _results(hs) == _results(jhs) == [solo(p1, 8), solo(p2, 8)]
    assert d == jd and d["spec_rounds"] > 0
    assert d["spec_accepted"] == d["spec_drafted"]
    assert engines[0].stats()["spec_acceptance_rate"] == 1.0
    assert_drained(engines[0])


def _bad_cases():
    m = models()
    jd, jvars, td = _draft_pair(vocab_size=32, seed=8)
    return {
        "k_without_draft": (dict(speculative_tokens=2),
                            dict(speculative_tokens=2)),
        "draft_without_variables": (
            dict(draft_model=m["tm"], speculative_tokens=2),
            dict(draft_model=m["jm"], speculative_tokens=2)),
        "draft_vocab": (
            dict(draft_model=td, draft_variables=td.state_dict(),
                 speculative_tokens=2),
            dict(draft_model=jd, draft_variables=jvars,
                 speculative_tokens=2)),
    }


@pytest.mark.parametrize("case", ["k_without_draft",
                                  "draft_without_variables", "draft_vocab"])
def test_speculative_constructor_validation(case):
    """Each refusal of the JAX constructor, with its message."""
    kw, jkw = _bad_cases()[case]
    m = models()
    with pytest.raises(ValueError) as want:
        jax_serving.ServingEngine(m["jm"], m["variables"],
                                  **dict(ENGINE_KW, **jkw))
    with pytest.raises(ValueError) as got:
        serving.ServingEngine(m["tm"], None,
                              **dict(ENGINE_KW, device="cpu", **kw))
    assert str(got.value) == str(want.value)


def test_speculative_telemetry_rides_node_stats(pair):
    """The round and rate gauges ride ``node_stats()`` as the live
    engines' aggregate, and the accepted-token histogram exports its
    buckets."""
    eng = pair[0]
    if not eng.spec_rounds:        # standalone run: drive one stream
        eng.submit(prompt(10, 213), 4)
        eng.run_until_idle()
    eng._publish()
    stats = telemetry.node_stats()
    live = [e for e in serving.engine._live_engines.values()]
    assert stats["serve_spec_rounds"] == sum(e.spec_rounds for e in live)
    assert stats["serve_spec_rounds"] >= eng.spec_rounds >= 1
    drafted = sum(e.spec_drafted for e in live)
    # Gauges ride heartbeats rounded to four places.
    assert stats["serve_spec_acceptance_rate"] == pytest.approx(
        sum(e.spec_accepted for e in live) / max(1, drafted), abs=5e-5)
    assert "serve_spec_accepted_tokens" in stats.get("hists", {})


# -- the rest: budget ends, int8 pools, sizing -------------------------------


def test_round_straddling_max_seq_len(pair):
    """max_model_len == max_seq_len (128): the last rounds of a 120 + 8
    request verify positions up to 126 + K, past the position table; they
    clamp, as JAX's gathers do, and the stream stays the JAX engine's and
    solo's."""
    p = prompt(120, 214)
    assert pair[0].max_model_len == LM_KW["max_seq_len"] == 128

    def drive(eng):
        h = eng.submit(p, 8)
        eng.run_until_idle()
        return [h]

    (hs, d), (jhs, jd) = _on_both(pair, drive)
    assert _results(hs) == _results(jhs) == [solo(p, 8)]
    assert d == jd and d["spec_rounds"] > 0
    assert_drained(pair[0])


def test_int8_speculative_against_jax_int8_engine():
    """int8 pools: the JAX engine's speculative streams (its verify window
    unquantized until the flush), teacher-forced through the port's int8
    pool, pick the port's largest logit up to ``INT8_TF_TOL``; the first
    tokens (fp prefill) are exact; the port's own streams follow its
    teacher-forced argmax, as every emitted token is a verify position's
    greedy over the quantized pool."""
    loads = [(prompt(20, 215), 14), (prompt(9, 216), 11)]
    eng = _port_spec(kv_cache_dtype="int8")
    jeng = _jax_spec(kv_cache_dtype="int8")
    handles = [eng.submit(p, n) for p, n in loads]
    jhandles = [jeng.submit(p, n) for p, n in loads]
    eng.run_until_idle()
    jeng.run_until_idle()
    assert_drained(eng)
    assert eng.spec_rounds > 0
    for (p, n), h, jh in zip(loads, handles, jhandles):
        got, jgot = h.result(timeout=5), jh.result(timeout=5)
        assert len(got) == len(jgot) == n
        assert got[0] == jgot[0] == solo(p, 1)[0]
        logits = teacher_forced_int8_logits(p, jgot, PAGE)
        gap = logits.max(axis=1) - logits[np.arange(n), jgot]
        assert gap.max() <= INT8_TF_TOL, gap
        port_tf = teacher_forced_int8_logits(p, got, PAGE).argmax(axis=1)
        assert got == port_tf.tolist()


@pytest.mark.parametrize("horizon,k", [(1, 3), (8, 3), (4, 12)])
def test_default_sizing_matches_jax(horizon, k):
    """Slack ``max(horizon - 1, k)`` in the default pool, the scheduler's
    reservation, the table width, and the draft pool and table."""
    m = models()
    jd, jvars, td = _draft_pair()
    kw = dict(max_slots=3, page_size=PAGE, decode_horizon=horizon,
              speculative_tokens=k)
    eng = serving.ServingEngine(m["tm"], None, device="cpu", draft_model=td,
                                draft_variables=td.state_dict(), **kw)
    jeng = jax_serving.ServingEngine(m["jm"], m["variables"], draft_model=jd,
                                     draft_variables=jvars, **kw)
    slack = max(horizon - 1, k)
    assert eng.scheduler.reserve_slack == jeng.scheduler.reserve_slack \
        == slack
    assert eng.pool.num_pages == jeng.pool.num_pages \
        == 1 + 3 * -(-(128 + slack) // PAGE)
    assert eng.runner.table_width == jeng.runner.table_width
    assert eng.draft_runner.num_pages == jeng.draft_runner.num_pages
    np.testing.assert_array_equal(eng._draft_table, jeng._draft_table)
    eng.close()
    jeng.close()
