"""The port's decode horizon: k single-token steps in one decode call.

The port writes the pool in place, so a horizon of k is k steps of the
horizon-1 path inside one ``ModelRunner.decode`` call, one host sync at
its end, each step reaching the paged-attention kernel (its plain version
here). Greedy fp32 streams at horizons 2, 4 and 8 must equal the JAX
engine's at the same horizon and the port's solo ``generate``, token for
token: a request joining a decoding batch, a budget no multiple of the
horizon, a max-length request whose table row holds the slack, and an eos
ending a row mid-call. Horizon k must equal horizon 1 bitwise with fp32
and int8 pools; every reservation is ``ceil((p + n + horizon - 1) /
page_size)`` pages and none leaks.

Against the JAX int8 engine at horizon > 1 the streams are held
teacher-forced (see ``test_int8_horizon_against_jax_int8_engine``).
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import serving
from tensorflowonspark_tpu_torch.models import decoding
from tensorflowonspark_tpu_torch.serving import runner as runner_mod
from torch_serving_common import (
    INT8_TF_TOL, assert_drained, engine, jax_engine, models, prompt, solo,
    teacher_forced_int8_logits,
)
from torch_serving_common import one_torch_thread  # noqa: F401

PAGE = 16


def _record_reservations(eng):
    """Wrap admission to record (prompt_len + max_new, pages reserved)."""
    seen = []
    admit = eng.scheduler.next_admission

    def recorded():
        req = admit()
        if req is not None:
            seen.append((req.total_len, len(req.pages)))
        return req
    eng.scheduler.next_admission = recorded
    return seen


def _eos_index(stream, horizon):
    """The first index k >= 3 whose token is new in the stream and lands
    mid-call (not the last of a decode call's ``horizon`` tokens; token 0
    comes from the prefill)."""
    for k in range(3, len(stream)):
        if (k - 1) % horizon != horizon - 1 and stream[k] not in stream[:k]:
            return k
    raise AssertionError("no usable eos token in {}".format(stream))


def _drive(eng, horizon, eos):
    """The load, step for step the same on either engine. Returns the four
    handles and whether the second request joined a decoding batch."""
    h1 = eng.submit(prompt(12, 1), 40)
    eng.step()
    eng.step()                               # h1 is mid-decode
    h2 = eng.submit(prompt(20, 2), 13)       # 13: no multiple of 2, 4, 8
    eng.step()
    joined = h1.state == h2.state == serving.RUNNING
    h3 = eng.submit(prompt(7, 17), 12, eos_token=eos)
    eng.run_until_idle()
    h4 = eng.submit(prompt(120, 13), 8)      # 120 + 8 == max_model_len
    eng.run_until_idle()
    return (h1, h2, h3, h4), joined


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("horizon", [2, 4, 8])
def test_horizon_streams_match_jax_engine_and_solo(horizon):
    want = [solo(prompt(12, 1), 40), solo(prompt(20, 2), 13),
            solo(prompt(7, 17), 12), solo(prompt(120, 13), 8)]
    k = _eos_index(want[2], horizon)
    eos = want[2][k]
    want[2] = want[2][:k + 1]
    eng = engine(decode_horizon=horizon)
    reserved = _record_reservations(eng)
    handles, joined = _drive(eng, horizon, eos)
    assert joined
    jhandles, jjoined = _drive(jax_engine(decode_horizon=horizon), horizon,
                               eos)
    assert jjoined
    for i, (h, jh, w) in enumerate(zip(handles, jhandles, want)):
        assert h.state == serving.FINISHED, i
        got = h.result(timeout=5)
        assert got == w, i
        assert got == jh.result(timeout=5), i
    assert len(reserved) == 4
    for total, pages in reserved:
        assert pages == -(-(total + horizon - 1) // PAGE)
    # The max-length request's row held every reserved page.
    assert eng.runner.table_width == reserved[-1][1] == -(
        -(128 + horizon - 1) // PAGE)
    assert eng.stats()["decode_horizon"] == horizon
    assert_drained(eng)


def _greedy_load(eng):
    """Seven requests of mixed lengths over four slots, so slots recycle
    and rows join and leave at every horizon."""
    shapes = [(12, 21), (33, 9), (5, 30), (47, 14), (20, 3), (64, 17),
              (9, 26)]
    handles = [eng.submit(prompt(p, 100 + i), n)
               for i, (p, n) in enumerate(shapes)]
    eng.run_until_idle()
    assert_drained(eng)
    return [h.result(timeout=5) for h in handles], shapes


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("kv_cache_dtype", ["", "int8"],
                         ids=["fp32", "int8"])
def test_horizon_k_equals_horizon_1_bitwise(kv_cache_dtype):
    """The in-place loop is the horizon-1 work step by step: streams at
    horizons 3 and 8 equal horizon 1's token for token, for either pool,
    and with the fp32 pool equal solo ``generate``."""
    base, shapes = _greedy_load(engine(decode_horizon=1,
                                       kv_cache_dtype=kv_cache_dtype))
    for horizon in (3, 8):
        got, _ = _greedy_load(engine(decode_horizon=horizon,
                                     kv_cache_dtype=kv_cache_dtype))
        assert got == base, horizon
    if not kv_cache_dtype:
        assert base == [solo(prompt(p, 100 + i), n)
                        for i, (p, n) in enumerate(shapes)]


@pytest.mark.watchdog_timeout(120)
def test_decode_call_runs_the_horizon_with_one_draw_a_step():
    """``ModelRunner.decode(horizon=k)`` is k calls of one step: the same
    tokens, the pool written the same, and the sampler's generator
    advanced by one (slots, vocab) draw a step in both."""
    tm = models()["tm"]

    def run(horizon_calls):
        r = runner_mod.ModelRunner(tm, None, max_slots=3, page_size=PAGE,
                                   num_pages=12, extra_table_tokens=5,
                                   rng_seed=7)
        table = np.zeros((3, r.table_width), np.int32)
        toks = np.zeros((3,), np.int32)
        lens = np.zeros((3,), np.int32)
        for slot, (p, seed) in enumerate(((9, 1), (20, 2))):
            pages = [1 + 4 * slot + j for j in range(3)]
            alloc = r.prefill_alloc(p)
            pc = r.new_prefill_cache(alloc)
            pc, last = r.prefill_step(pc, prompt(p, seed)[None], p - 1,
                                      alloc)
            r.scatter(pc, pages, p, alloc)
            table[slot, :3] = pages
            toks[slot] = int(torch.argmax(last))
            lens[slot] = p
        temps = np.array([0.0, 0.9, 0.0], np.float32)
        zeros = np.zeros((3,), np.int32)
        outs = []
        for k in horizon_calls:
            out = r.decode(toks, table, lens, temps, zeros,
                           zeros.astype(np.float32), horizon=k)
            outs.append(out)
            toks, lens = out[:, -1], lens + k
        return np.concatenate(outs, axis=1), r

    one, r1 = run([1] * 6)
    six, r6 = run([6])
    assert six.shape == (3, 6) and six.dtype == np.int32
    np.testing.assert_array_equal(six, one)
    for key, layer in r1.cache.items():
        for name, t in layer.items():
            assert torch.equal(t, r6.cache[key][name]), (key, name)
    assert torch.equal(torch.rand(4, generator=r1.rng),
                       torch.rand(4, generator=r6.rng))


@pytest.mark.watchdog_timeout(120)
def test_int8_horizon_against_jax_int8_engine():
    """Horizon 4, int8 pools: the JAX engine's greedy streams, teacher-
    forced through the port's int8 pool, pick the port's largest logit up
    to ``INT8_TF_TOL``; the first tokens (fp prefill) are exact; the port's
    own horizon-4 int8 streams follow its teacher-forced argmax."""
    loads = [(prompt(20, 61), 24), (prompt(9, 62), 17), (prompt(35, 63), 11)]
    eng = engine(kv_cache_dtype="int8")
    jeng = jax_engine(kv_cache_dtype="int8")
    handles = [eng.submit(p, n) for p, n in loads]
    jhandles = [jeng.submit(p, n) for p, n in loads]
    eng.run_until_idle()
    jeng.run_until_idle()
    assert_drained(eng)
    for (p, n), h, jh in zip(loads, handles, jhandles):
        got, jgot = h.result(timeout=5), jh.result(timeout=5)
        assert len(got) == len(jgot) == n
        assert got[0] == jgot[0] == solo(p, 1)[0]
        logits = teacher_forced_int8_logits(p, jgot)
        gap = logits.max(axis=1) - logits[np.arange(n), jgot]
        assert gap.max() <= INT8_TF_TOL, gap
        port_tf = teacher_forced_int8_logits(p, got).argmax(axis=1)
        assert got == port_tf.tolist()


@pytest.mark.watchdog_timeout(120)
def test_horizon_defaults_and_sizing():
    """The engine's defaults are the JAX engine's; the default pool counts
    the slack: every slot a max-length request plus horizon - 1 tokens."""
    eng = serving.ServingEngine(models()["tm"], None, max_slots=2,
                                page_size=PAGE, device="cpu")
    st = eng.stats()
    assert (st["decode_horizon"], st["prefix_share"], st["preempt_mode"]) \
        == (8, True, "swap")
    assert eng.pool.num_pages == 1 + 2 * -(-(128 + 7) // PAGE)
    assert eng.runner.table_width == -(-(128 + 7) // PAGE)
    assert eng.scheduler.reserve_slack == 7
    one = engine(decode_horizon=1)
    assert one.scheduler.reserve_slack == 0
    assert one.runner.table_width == 128 // PAGE
    p = prompt(10, 3)
    h = one.submit(p, 6)
    one.run_until_idle()
    assert h.result(timeout=5) == solo(p, 6)
    assert decoding.generate(models()["tm"], None, p[None], 6,
                             auto_cache=True).shape == (1, 16)
