"""The port's ``DevicePrefetch``, ``AsyncStepMetrics`` and ``Trainer.fit``.

The mesh-free cases of ``tests/test_prefetch.py``, ported: order, the
depth bound, an exception in order, ``close()`` reaping the producer and
closing the source, ``depth=0`` without a thread, a placed batch passing
``Trainer._place`` unchanged, the metrics cadence, ``fit`` checkpointing
and resuming past an exploding source, the steps cap over an existing
prefetch, and chunked ``fit`` over one source with a shared buffer. The
sources stand in for ``data.InputPipeline``: an endless, re-iterable
stream with a thread-safe ``close()``.

Then ``fit`` against the JAX package's ``fit`` on the fp32 toy LM of
``tests/test_torch_trainer.py``, from the same converted weights over 6
batches with ``flush_every=4`` under AdamW: equal history steps and losses
within 1e-5, the tolerance of ``test_three_adam_steps_match_jax_trainer``.
Both run the dense attention route: the loop is under test here, and the
flash route's steps are held against the Pallas kernels by
``tests/test_torch_trainer.py`` (its interpret-mode compile would take
this test past its few seconds). And ``fit`` against a plain loop of
``train_step`` in the port, on the flash route: bitwise.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import factory
from tensorflowonspark_tpu_torch.train import Trainer, trainer
from tensorflowonspark_tpu_torch.train.checkpoint import (
    CheckpointManager,
    latest_committed_step,
)
from tensorflowonspark_tpu_torch.train.metrics import AsyncStepMetrics
from tensorflowonspark_tpu_torch.train.prefetch import DevicePrefetch

pytestmark = pytest.mark.watchdog_timeout(120)

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
B, S = 4, 16
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(n, delay=0.0, pulled=None):
    for i in range(n):
        if delay:
            time.sleep(delay)
        if pulled is not None:
            pulled.append(i)
        yield {"x": np.full((16, 4), float(i), np.float32),
               "y": np.full((16,), i % 2, np.int32)}


def _lm_batch(i):
    toks = np.random.RandomState(i).randint(1, LM_KW["vocab_size"],
                                            size=(B, S + 1))
    return {"x": toks[:, :-1].astype(np.int32),
            "y": toks[:, 1:].astype(np.int32)}


def _lm_batches(n, start=0):
    for i in range(start, start + n):
        yield _lm_batch(i)


class _Stream:
    """An endless batch source: re-iterable (each ``iter()`` continues the
    same stream), ``close()`` thread-safe and stopping every iterator."""

    def __init__(self):
        self.served = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()

    def __iter__(self):
        while not self._stop.is_set():
            with self._lock:
                i = self.served
                self.served += 1
            yield _lm_batch(i)

    def close(self):
        self._stop.set()


def _lm(seed=0, model=None):
    model = model or factory.get_model(
        "transformer", device="cpu", dtype=torch.float32, seed=seed,
        attention_impl="pallas", **LM_KW)
    tr = Trainer(model, optimizer=trainer.adamw(1e-3), device="cpu")
    return tr, tr.init()


# -- DevicePrefetch -----------------------------------------------------------

def test_ordering_and_placement():
    pf = DevicePrefetch(_batches(5), device="cpu")
    got = list(pf)
    pf.close()
    assert [float(b["x"][0, 0]) for b in got] == [0.0, 1.0, 2.0, 3.0, 4.0]
    for b in got:
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        assert b["y"].dtype == torch.int32


def test_depth_bounds_batches_in_flight():
    pulled = []
    pf = DevicePrefetch(_batches(20, pulled=pulled), depth=2, device="cpu")
    deadline = time.time() + 2.0
    while len(pulled) < 3 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)  # the producer would run ahead here if unbounded
    # depth=2 queued + 1 blocked on put: the producer pulls no more.
    assert len(pulled) == 3
    assert len(list(pf)) == 20  # draining still yields everything
    pf.close()


def test_producer_exception_propagates_in_order():
    def bad():
        yield {"x": np.zeros((8, 2), np.float32)}
        yield {"x": np.ones((8, 2), np.float32)}
        raise RuntimeError("decode failed")

    pf = DevicePrefetch(bad(), device="cpu")
    it = iter(pf)
    assert float(next(it)["x"][0, 0]) == 0.0
    assert float(next(it)["x"][0, 0]) == 1.0
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    pf.close()


def test_close_mid_stream_reaps_producer():
    pf = DevicePrefetch(_batches(1000, delay=0.005), depth=2, device="cpu")
    assert float(next(iter(pf))["x"][0, 0]) == 0.0
    pf.close()
    pf._thread.join(30.0)
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(iter(pf))
    pf.close()  # idempotent


def test_close_closes_the_source():
    source = _Stream()
    pf = DevicePrefetch(source, device="cpu")
    batch = next(iter(pf))
    assert batch["x"].shape == (B, S) and isinstance(batch["x"], torch.Tensor)
    pf.close()
    assert source._stop.is_set()  # closed, not orphaned
    pf._thread.join(30.0)
    assert not pf._thread.is_alive()


def test_depth_zero_is_synchronous_no_thread():
    pulled = []
    pf = DevicePrefetch(_batches(4, pulled=pulled), depth=0, device="cpu")
    assert pf._thread is None
    it = iter(pf)
    first = next(it)
    assert len(pulled) == 1  # nothing ran ahead
    assert isinstance(first["x"], torch.Tensor)
    assert [float(b["x"][0, 0]) for b in it] == [1.0, 2.0, 3.0]
    with pytest.raises(StopIteration):
        next(it)
    pf.close()


def test_placed_batch_passes_place_unchanged():
    """A batch placed by the trainer's placer enters train_step without a
    second copy: ``_place`` hands back the very tensors."""
    tr, _ = _lm()
    pf = DevicePrefetch(_lm_batches(1), placer=tr.batch_placer)
    placed = next(iter(pf))
    pf.close()
    again = tr._place(placed)
    assert all(again[k] is placed[k] for k in placed)
    assert tr.batch_placer.device == tr.device


def test_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetch(_batches(1))


# -- AsyncStepMetrics ---------------------------------------------------------

def test_async_metrics_flush_cadence(monkeypatch):
    calls = []
    buf = AsyncStepMetrics(flush_every=4, hooks=[
        lambda s, m: calls.append((s, m["loss"]))])
    transfers = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: (
        transfers.append(tuple(self.shape)), cpu(self, *a, **k))[1])
    for i in range(6):
        buf.push(i, {"loss": torch.tensor(float(i)),
                     "aux": torch.tensor(i, dtype=torch.int32)})
        # Nothing is fetched until flush_every steps have accumulated.
        assert len(buf.history) == (4 if i >= 3 else 0)
    buf.flush()
    # One host transfer a window: 4 steps x 2 keys, then 2 x 2.
    assert transfers == [(8,), (4,)]
    assert [h["step"] for h in buf.history] == list(range(6))
    assert calls == [(i, float(i)) for i in range(6)]
    assert buf.last == {"step": 5, "loss": 5.0, "aux": 5.0}
    buf.close()
    with pytest.raises(RuntimeError, match="closed"):
        buf.push(6, {"loss": torch.tensor(0.0)})


# -- Trainer.fit --------------------------------------------------------------

def test_fit_checkpoints_and_resumes(tmp_path):
    """fit(checkpoint=..., checkpoint_every=k): periodic committed saves
    plus the final forced save; a crash mid-loop still commits the last
    completed step; a fresh fit resumes from it."""
    d = str(tmp_path / "ck")
    tr, state = _lm()
    hooked = []
    state, history = tr.fit(state, _lm_batches(5), checkpoint=d,
                            checkpoint_every=2, flush_every=2,
                            hooks=[lambda s, m: hooked.append(s)])
    assert state.step == 5 and latest_committed_step(d) == 5
    assert [h["step"] for h in history] == hooked == list(range(5))
    assert all(np.isfinite(h["loss"]) for h in history)

    def exploding():
        yield from _lm_batches(3, start=5)
        raise RuntimeError("boom mid-epoch")

    mgr = CheckpointManager(d, save_interval_steps=1)
    tr2, fresh = _lm(seed=1)
    state = mgr.restore(fresh)
    assert state.step == 5
    with pytest.raises(RuntimeError, match="boom mid-epoch"):
        tr2.fit(state, exploding(), checkpoint=mgr, depth=0)
    # The 3 completed steps were saved on the exception exit.
    assert mgr.latest_committed_step() == 8


def test_fit_steps_cap_and_existing_prefetch():
    tr, state = _lm()
    pf = DevicePrefetch(_lm_batches(50), depth=2, placer=tr.batch_placer)
    try:
        state, history = tr.fit(state, pf, steps=5)
    finally:
        pf.close()
    assert state.step == 5 and len(history) == 5


def test_fit_chunked_over_one_source():
    """A steps-capped fit() leaves the source usable, fit(steps=0) is a
    no-op, and hooks passed per call to a shared buffer do not pile up."""
    source = _Stream()
    tr, state = _lm()
    buf = AsyncStepMetrics(flush_every=4)
    calls = []
    hook = lambda s, m: calls.append(s)  # noqa: E731
    state, _ = tr.fit(state, source, steps=3, hooks=[hook], metrics=buf)
    assert state.step == 3 and not source._stop.is_set()

    served = source.served
    state, _ = tr.fit(state, source, steps=0, hooks=[hook], metrics=buf)
    assert state.step == 3 and source.served == served  # no batch taken

    state, hist = tr.fit(state, source, steps=3, hooks=[hook], metrics=buf)
    assert state.step == 6
    assert [h["step"] for h in hist] == list(range(6))
    assert calls == list(range(6))  # each step hooked exactly once
    assert buf.hooks == [] and not buf.closed
    source.close()


def test_fit_equals_a_plain_train_step_loop():
    tr, state = _lm()
    state, history = tr.fit(state, _lm_batches(5), flush_every=2)
    ref_tr, ref = _lm()
    losses = []
    for batch in _lm_batches(5):
        ref, m = ref_tr.train_step(ref, batch)
        losses.append(float(m["loss"]))
    assert [h["loss"] for h in history] == losses
    assert state.step == ref.step == 5
    for name in ref.params:
        assert torch.equal(state.params[name], ref.params[name]), name
    moments = state.optimizer.state_dict()["state"]
    for idx, ref_moments in ref.optimizer.state_dict()["state"].items():
        for key, val in ref_moments.items():
            assert torch.equal(moments[idx][key], val), (idx, key)


def test_fit_matches_the_jax_fit():
    import jax
    import jax.numpy as jnp
    import flax.linen as nn
    import optax

    from tensorflowonspark_tpu.models import factory as jax_factory
    from tensorflowonspark_tpu.parallel import MeshConfig
    from tensorflowonspark_tpu.train import Trainer as JaxTrainer

    jm = jax_factory.get_model("transformer", dtype=jnp.float32,
                               attention_impl="dense", **LM_KW)
    jtr = JaxTrainer(jm, optimizer=optax.adamw(1e-3),
                     mesh=MeshConfig(data=1).build(jax.devices()[:1]))
    jstate = jtr.init(jax.random.PRNGKey(0), _lm_batch(0))
    params = jax.device_get(nn.meta.unbox(jstate.params))
    jstate, jhist = jtr.fit(jstate, _lm_batches(6), flush_every=4)

    model = factory.get_model("transformer", device="cpu",
                              dtype=torch.float32, attention_impl="dense",
                              **LM_KW)
    tr = Trainer(model, optimizer=trainer.adamw(1e-3), device="cpu")
    state = tr.init(params=convert.params_from_flax(params, model.cfg))
    state, hist = tr.fit(state, _lm_batches(6), flush_every=4)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] \
        == list(range(6))
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=0, atol=TOL)
    assert int(jstate.step) == state.step == 6
