"""The port's priority preemption: swap and recompute resume.

The JAX package's drills (``tests/test_serving_engine.py:729-905`` and
``:1178``) on the port's engine at the same geometry (4 slots, page 16,
32 pages, horizon 4). Long prompts oversubscribe the pool: p = 100, g =
10 reserves ceil((110 + 3) / 16) = 8 of the 31 allocatable pages, so
three residents block a fourth. A swap-mode victim's pages go to host
memory and come back byte for byte; a recompute-mode victim replays
prompt + generated through the chunked prefill; either resumed greedy
stream equals the port's solo ``generate`` and the JAX engine's stream
under the same drill, token for token. Also: the victim policy, a victim
cancelled mid-swap, a preemption storm whose ledger balances to zero,
priority ordering with ``preempt="off"``, a prefill-stage preemptee
re-admitted with fresh semantics, and swap with an int8 pool, whose
restored bytes and scales equal the extracted ones bitwise.
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import serving
from tensorflowonspark_tpu_torch.serving import runner as runner_mod
from torch_serving_common import (
    assert_drained, engine, jax_engine, models, prompt, shared_engine, solo,
)
from torch_serving_common import one_torch_thread  # noqa: F401


def _big(seed):
    return prompt(100, seed=seed)


def _fill_three(eng, seeds, g=10, priority=0):
    handles = [eng.submit(_big(s), g, priority=priority) for s in seeds]
    eng.step()  # batch ramp: all three admitted, prefilled and joined
    assert all(h.state == serving.RUNNING for h in handles)
    return handles


def _drill(eng, low_seeds, high_seed):
    """Three low-priority residents, then a high-priority arrival that
    must evict one. Returns the four handles (lows first)."""
    lows = _fill_three(eng, low_seeds)
    hi = eng.submit(_big(high_seed), 10, priority=1)   # 8 > 7 free pages
    eng.run_until_idle()
    return lows + [hi]


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preempt_resume_stream_matches_solo_and_jax(mode):
    """The newest low-priority victim is preempted once (its pages
    swapped to host memory, or dropped for replay), resumes after the
    preemptor, and every stream — victim, bystanders, preemptor — equals
    solo ``generate`` and the JAX engine's under the same drill."""
    seeds = (80, 81, 82, 90) if mode == "swap" else (83, 84, 85, 91)
    eng = shared_engine()
    jeng = jax_engine()
    eng.preempt = jeng.preempt = mode
    try:
        swaps, recomputes = eng.preempt_swaps, eng.preempt_recomputes
        preempts = eng.scheduler.preemptions
        handles = _drill(eng, seeds[:3], seeds[3])
        jhandles = _drill(jeng, seeds[:3], seeds[3])
    finally:
        eng.preempt = jeng.preempt = "swap"
    assert eng.scheduler.preemptions == preempts + 1
    assert (eng.preempt_swaps - swaps, eng.preempt_recomputes - recomputes) \
        == ((1, 0) if mode == "swap" else (0, 1))
    victim = handles[2]._req                   # lowest class, newest
    assert victim.preempt_count == 1
    assert handles[0]._req.preempt_count == handles[1]._req.preempt_count \
        == 0
    assert victim.swap_pages is None           # host copy consumed
    assert jhandles[2]._req.preempt_count == 1
    for s, h, jh in zip(seeds, handles, jhandles):
        got = h.result(timeout=5)
        assert got == solo(_big(s), 10), s
        assert got == jh.result(timeout=5), s
    assert_drained(eng)
    st = eng.stats()
    assert st["preempt_mode"] == "swap"
    assert st["preempt_swaps"] + st["preempt_recomputes"] >= 1


@pytest.mark.watchdog_timeout(120)
def test_victim_policy_lowest_priority_then_newest():
    """Among actives of classes (0 old, 1, 0 new), a class-2 arrival
    evicts the NEWEST class-0 request."""
    eng = shared_engine()
    a = eng.submit(_big(86), 10, priority=0)
    b = eng.submit(_big(87), 10, priority=1)
    c = eng.submit(_big(88), 10, priority=0)
    eng.step()
    assert all(h.state == serving.RUNNING for h in (a, b, c))
    assert eng.scheduler.preemption_victim(2) is c._req
    assert eng.scheduler.preemption_victim(1) is c._req
    assert eng.scheduler.preemption_victim(0) is None
    d = eng.submit(_big(92), 10, priority=2)
    eng.run_until_idle()
    assert c._req.preempt_count == 1
    assert a._req.preempt_count == 0 and b._req.preempt_count == 0
    for s, h in zip((86, 87, 88, 92), (a, b, c, d)):
        assert h.result(timeout=5) == solo(_big(s), 10), s
    assert_drained(eng)


@pytest.mark.watchdog_timeout(120)
def test_victim_cancelled_mid_swap_frees_everything():
    """A victim cancelled between swap-out and resume: its host copy,
    queue entry and reservation all go; the partial stream is a solo
    prefix and the ledger drains to zero."""
    eng = shared_engine()
    lows = _fill_three(eng, (93, 94, 95))
    hi = eng.submit(_big(96), 10, priority=1)
    for _ in range(40):
        eng.step()
        if lows[2].state == serving.PREEMPTED:
            break
    victim = lows[2]
    assert victim.state == serving.PREEMPTED
    assert victim._req.swap_pages is not None
    assert eng.scheduler.preempted_waiting() == 1
    assert eng.stats()["preempted_waiting"] == 1
    victim.cancel()
    eng.step()
    assert victim.state == serving.CANCELLED
    assert victim._req.swap_pages is None
    eng.run_until_idle()
    got = victim.result(timeout=5)
    assert 0 < len(got) < 10
    assert got == solo(_big(95), 10)[:len(got)]
    for s, h in zip((93, 94, 96), lows[:2] + [hi]):
        assert h.result(timeout=5) == solo(_big(s), 10), s
    assert_drained(eng)


@pytest.mark.watchdog_timeout(120)
def test_preemption_storm_ledger_balances_to_zero():
    """Four priority classes over an oversubscribed pool: each class-1..3
    admission evicts a class-0 resident, preempted requests resume as
    capacity frees, and at the drain the ledger reads zero with every
    stream equal to solo."""
    eng = shared_engine()
    preempts = eng.scheduler.preemptions
    lowp = [prompt(80, seed=100 + i) for i in range(4)]
    lows = [eng.submit(p, 45) for p in lowp[:3]]
    eng.step()
    assert all(h.state == serving.RUNNING for h in lows)
    lows.append(eng.submit(lowp[3], 45))        # queues (pool full)
    hip = [prompt(80, seed=110 + p) for p in (1, 2, 3)]
    highs = [eng.submit(p, 30, priority=pr)
             for p, pr in zip(hip, (1, 2, 3))]
    assert eng.stats()["queued_by_priority"].get(0, 0) >= 1
    eng.run_until_idle()
    assert eng.scheduler.preemptions - preempts >= 2
    for p, h in zip(lowp, lows):
        assert h.result(timeout=10) == solo(p, 45)
    for p, h in zip(hip, highs):
        assert h.result(timeout=10) == solo(p, 30)
    assert_drained(eng)
    assert eng.scheduler.preempted_waiting() == 0


@pytest.mark.watchdog_timeout(120)
def test_priority_orders_admission_without_preemption():
    """``preempt="off"``: a class-5 arrival behind a class-0 one is
    admitted first when a slot frees; running requests are never
    evicted."""
    eng = shared_engine()
    eng.preempt = "off"
    try:
        preempts = eng.scheduler.preemptions
        running = [eng.submit(prompt(20, seed=120 + i), 20)
                   for i in range(4)]           # fills all 4 slots
        eng.step()
        low = eng.submit(prompt(8, seed=124), 4, priority=0)
        high = eng.submit(prompt(8, seed=125), 4, priority=5)
        eng.run_until_idle()
        assert eng.scheduler.preemptions == preempts
        assert high._req.t_admit < low._req.t_admit
        assert low.result(timeout=5) == solo(prompt(8, seed=124), 4)
        assert high.result(timeout=5) == solo(prompt(8, seed=125), 4)
        for h in running:
            assert h.state == serving.FINISHED
        assert_drained(eng)
    finally:
        eng.preempt = "swap"


@pytest.mark.watchdog_timeout(120)
def test_prefill_stage_preemptee_readmits_with_fresh_semantics():
    """A preemptee with NO generated tokens still needs the prompt's
    last-token logits for its first sample, so its re-admission keeps the
    whole-prompt-match COW demotion (fresh-request semantics)."""
    pool = serving.PagePool(num_pages=10, page_size=4)
    sched = serving.Scheduler(pool, max_slots=2, prefix_share=True)
    p = np.arange(1, 9, dtype=np.int32)          # 2 full pages
    keys = serving.prefix_keys(p, 4)
    pages = pool.alloc(2)
    for k, pg in zip(keys, pages):
        pool.register_prefix(k, pg)
    pool.free(pages)         # park in the cached tier, index intact
    req = serving.Request(p, 4)
    sched.submit(req)
    assert sched.next_admission() is req
    assert req.cow_src is not None               # fresh whole-match COW
    assert req.prefix_len == req.prompt_len - 1
    sched.release(req, serving.PREEMPTED)        # before ANY sample
    assert req.state == serving.PREEMPTED and not req.generated
    assert sched.next_admission() is req
    assert req.cow_src is not None
    assert req.prefix_len == req.prompt_len - 1
    sched.release(req, serving.CANCELLED)
    assert pool.pages_in_use == 0
    # A resumed request that had sampled re-admits without the demotion.
    req2 = serving.Request(p, 4)
    sched.submit(req2)
    assert sched.next_admission() is req2
    req2.generated = [5]
    sched.release(req2, serving.PREEMPTED)
    assert sched.next_admission() is req2
    # Both prompt pages are retained as they are (no COW copy): the
    # resume gathers the whole prompt and re-runs nothing.
    assert req2.cow_src is None and req2.shared_pages == 2
    assert req2.prefix_len == req2.cache_len == 8
    assert req2.replay_tokens().tolist() == p.tolist()
    sched.release(req2, serving.FINISHED)
    assert pool.pages_in_use == 0


@pytest.mark.watchdog_timeout(120)
def test_int8_swap_restores_bytes_and_scales_bitwise():
    """``extract_pages``/``restore_pages`` on an int8 pool move the int8
    bytes and the f32 scales to host memory and back to other page ids
    unchanged; an int8 engine's swap-resumed streams equal the same
    requests served without preemption."""
    tm = models()["tm"]
    r = runner_mod.ModelRunner(tm, None, max_slots=2, page_size=16,
                               num_pages=10, kv_quant="int8")
    p = prompt(40, 9)
    alloc = r.prefill_alloc(40)
    pc, _ = r.prefill_step(r.new_prefill_cache(alloc), p[None], 39, alloc)
    r.scatter(pc, [2, 4, 6], 40, alloc)
    host = r.extract_pages([2, 4, 6])
    assert set(host["block_0"]) == {"k_pages", "v_pages", "k_scales",
                                    "v_scales"}
    assert host["block_0"]["k_pages"].dtype == torch.int8
    assert host["block_0"]["k_pages"].device.type == "cpu"
    r.restore_pages(host, [7, 8, 9])
    for layer in r.cache.values():
        for name, t in layer.items():
            assert torch.equal(t[[7, 8, 9]], t[[2, 4, 6]]), name
    want = []
    for seeds in ((80, 81, 82), (90,)):
        ref = engine(kv_cache_dtype="int8", preempt="off")
        hs = [ref.submit(_big(s), 10) for s in seeds]
        ref.run_until_idle()
        want += [h.result(timeout=5) for h in hs]
    eng = engine(kv_cache_dtype="int8")
    handles = _drill(eng, (80, 81, 82), 90)
    assert eng.preempt_swaps == 1
    assert [h.result(timeout=5) for h in handles] == want
    assert_drained(eng)
