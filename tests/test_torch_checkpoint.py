"""The port's ``CheckpointManager`` against the JAX package's.

The spec cases are the ports of ``tests/test_checkpoint.py`` (all but the
metrics server, which ``tests/test_torch_metrics_writer.py`` and
``tests/test_torch_serving.py`` cover), on the fp32 toy LM of
``tests/test_torch_model.py`` with ``trainer.adamw``. Where the JAX package
is the reference it runs on one device
(``MeshConfig(data=1).build(jax.devices()[:1])``), built only inside the
test that needs it:

* its ``latest_committed_step`` (a file-level probe, no orbax) reads the
  port's trees as the port's probe does, damaged ones included, and the
  port's probe reads a JAX-written tree;
* its manager and the port's, given one sequence of ``save(step,
  force)`` calls, return the same values and leave the same latest step,
  committed step, step directories and markers (orbax's save decisions);
* a resumed ``fit`` is bitwise the uninterrupted one, for the LM under
  AdamW and a tiny ResNet under SGD momentum with BatchNorm buffers.
"""

import os
import uuid

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.train import checkpoint as jax_ckpt
from tensorflowonspark_tpu_torch.models import decoding, factory
from tensorflowonspark_tpu_torch.train import Trainer, trainer
from tensorflowonspark_tpu_torch.train import checkpoint as ckpt_lib
from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

pytestmark = pytest.mark.watchdog_timeout(120)

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lm_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        toks = rng.randint(1, LM_KW["vocab_size"], size=(B, S + 1))
        yield {"x": toks[:, :-1].astype(np.int32),
               "y": toks[:, 1:].astype(np.int32)}


def _resnet_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(n):
        yield {"x": rng.rand(4, 32, 32, 3).astype(np.float32),
               "y": (np.arange(4, dtype=np.int32) * 3 + i) % 10}


def _lm(seed=0):
    model = factory.get_model("transformer", device="cpu",
                              dtype=torch.float32, seed=seed,
                              attention_impl="pallas", **LM_KW)
    tr = Trainer(model, optimizer=trainer.adamw(1e-2), device="cpu")
    return tr, tr.init()


def _resnet(seed=0):
    model = factory.get_model("resnet18", device="cpu", dtype=torch.float32,
                              seed=seed, num_classes=10, width=8)
    tr = Trainer(model, optimizer=trainer.sgd(0.1, momentum=0.9),
                 device="cpu")
    return tr, tr.init()


MAKERS = {"lm_adamw": (_lm, _lm_batches),
          "resnet_sgd_momentum": (_resnet, _resnet_batches)}


def _trained(steps, seed=0):
    tr, state = _lm(seed)
    for batch in _lm_batches(steps):
        state, _ = tr.train_step(state, batch)
    return tr, state


def _first_param(state):
    return next(iter(state.params.values())).detach().clone()


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert a.params.keys() == b.params.keys()
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
    assert a.model_state.keys() == b.model_state.keys()
    for name in a.model_state:
        assert torch.equal(a.model_state[name], b.model_state[name]), name
    sa = a.optimizer.state_dict()["state"]
    sb = b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for idx in sa:
        assert sa[idx].keys() == sb[idx].keys()
        for key in sa[idx]:
            assert torch.equal(torch.as_tensor(sa[idx][key]),
                               torch.as_tensor(sb[idx][key])), (idx, key)


def _step_dirs(d):
    return sorted(int(n) for n in os.listdir(d) if n.isdigit())


def _markers(d):
    return sorted(n for n in os.listdir(d)
                  if n.startswith(ckpt_lib._MARKER_PREFIX))


def _jax_probe(d):
    return jax_ckpt.latest_committed_step(d)


# -- the spec cases (tests/test_checkpoint.py) -------------------------------

def test_save_restore_roundtrip(tmp_path):
    _, state = _trained(3)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.save(state)
    assert ckpt.latest_step() == 3

    _, blank = _lm(seed=1)
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore(blank)
    assert restored.step == 3
    _assert_states_equal(state, restored)
    # In place: the restored state names the fresh trainer's tensors.
    assert all(restored.params[k] is blank.params[k] for k in blank.params)


def test_restore_without_checkpoint_is_noop(tmp_path):
    _, state = _lm()
    restored = CheckpointManager(str(tmp_path / "empty")).restore(state)
    assert restored is state


def test_file_uri_checkpoint_dir(tmp_path):
    _, state = _lm()
    mgr = CheckpointManager("file://" + str(tmp_path / "uri_ckpt"))
    mgr.save(state, force=True)
    assert mgr.latest_step() == 0
    assert os.path.isfile(str(tmp_path / "uri_ckpt" / "0" / "default" /
                              "params.pt"))


@pytest.mark.parametrize("steps", [0, 1])
def test_async_save_commits_after_wait(tmp_path, steps):
    """async saves return at once; the marker appears only at wait() (or
    close()), and the step then restores."""
    _, state = _trained(steps)
    mgr = CheckpointManager(str(tmp_path / "m"), async_checkpointing=True)
    assert mgr.save(state, force=True)
    assert _markers(str(tmp_path / "m")) == []  # not before durability
    mgr.wait()
    assert mgr.latest_committed_step() == steps
    assert _jax_probe(str(tmp_path / "m")) == steps
    restored = mgr.restore(_lm(seed=1)[1])
    assert restored.step == steps
    _assert_states_equal(state, restored)
    mgr.close()


def test_force_save_rewrites_foreign_step(tmp_path):
    """force=True must not silently drop different state at a step another
    manager wrote; a re-force of this manager's own save is a no-op."""
    _, state = _lm()
    d = str(tmp_path / "ck")
    assert CheckpointManager(d).save(state, force=True)
    original = _first_param(state)

    second = CheckpointManager(d)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    assert second.save(state, force=True)  # rewritten, not dropped
    assert not [n for n in os.listdir(d) if n.startswith(".force-backup")]
    _, fresh = _lm(seed=1)
    restored = second.restore(fresh)
    assert torch.equal(_first_param(restored), original + 1.0)
    # The same manager re-forcing its own step: no-op.
    assert second.save(state, force=True) is False


@pytest.mark.parametrize("failure", ["declined", "raises"])
def test_force_rewrite_failure_restores_backup(tmp_path, monkeypatch,
                                               failure):
    """A forced rewrite that is declined (falsy save) or raises after the
    old step was deleted puts the backup copy back and leaves no backup
    dir behind."""
    _, state = _lm()
    d = str(tmp_path / "ck")
    assert CheckpointManager(d).save(state, force=True)
    original = _first_param(state)

    second = CheckpointManager(d)

    def failing_save(self, *a, **k):
        if failure == "raises":
            raise OSError("disk full")
        return False

    monkeypatch.setattr(ckpt_lib._StepStore, "save", failing_save)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    if failure == "raises":
        with pytest.raises(OSError, match="disk full"):
            second.save(state, force=True)
    else:
        assert second.save(state, force=True) is False
    monkeypatch.undo()
    assert not [n for n in os.listdir(d) if n.startswith(".force-backup")]
    assert second.latest_step() == 0
    assert ckpt_lib.latest_committed_step(d) == 0 == _jax_probe(d)
    restored = CheckpointManager(d).restore(_lm(seed=1)[1])
    assert torch.equal(_first_param(restored), original)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_failed_write_leaves_no_step(tmp_path, monkeypatch, mode):
    """A write that fails (a full disk at the optimizer file) leaves no
    step directory, no temporary directory and no marker; the synchronous
    save raises, the async one raises at wait()."""
    tr, state = _trained(1)
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, async_checkpointing=mode == "async")
    assert mgr.save(state)
    mgr.wait()
    state, _ = tr.train_step(state, next(_lm_batches(1, seed=1)))
    save = torch.save

    def full_disk(obj, path, *a, **k):
        if path.endswith("opt_state.pt"):
            raise OSError("no space left on device")
        return save(obj, path, *a, **k)

    monkeypatch.setattr(torch, "save", full_disk)
    with pytest.raises(OSError, match="no space"):
        mgr.save(state)
        mgr.wait()
    assert sorted(os.listdir(d)) == sorted(["1", ckpt_lib._marker_name(1)])
    assert mgr.latest_step() == 1
    assert mgr.latest_committed_step() == 1 == _jax_probe(d)


def test_latest_committed_step_falls_back_on_damage(tmp_path):
    """Truncating or deleting files under the latest step drops it from
    latest_committed_step(); restore() falls back to the prior committed
    step; the JAX supervisor's probe agrees at every point."""
    from tensorflowonspark_tpu.testing import faults

    tr, state = _lm()
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, save_interval_steps=1)
    firsts = {}
    for batch in _lm_batches(3):
        state, _ = tr.train_step(state, batch)
        mgr.save(state)
        firsts[state.step] = _first_param(state)
    assert mgr.latest_committed_step() == 3 == _jax_probe(d)

    assert faults.corrupt_step(d, mode="truncate") == 3
    assert mgr.latest_committed_step() == 2
    assert ckpt_lib.latest_committed_step(d) == 2 == _jax_probe(d)

    restored = CheckpointManager(d).restore(_lm(seed=1)[1])
    assert restored.step == 2
    assert torch.equal(_first_param(restored), firsts[2])
    # The torn step 3 was discarded, so a retrained step 3 can commit.
    assert _step_dirs(d) == [1, 2]

    assert faults.corrupt_step(d, step=2, mode="delete") == 2
    assert ckpt_lib.latest_committed_step(d) == 1 == _jax_probe(d)
    restored = CheckpointManager(d).restore(_lm(seed=2)[1])
    assert restored.step == 1
    assert torch.equal(_first_param(restored), firsts[1])


def test_uncommitted_save_is_invisible_to_committed_probe(tmp_path):
    """A crash before the commit (marker removed) leaves the step on disk
    but not committed: neither probe reports it, and restore prefers the
    committed line."""
    tr, state = _lm()
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, save_interval_steps=1)
    for batch in _lm_batches(2):
        state, _ = tr.train_step(state, batch)
        mgr.save(state)
    os.unlink(os.path.join(d, ckpt_lib._marker_name(2)))
    assert ckpt_lib.latest_committed_step(d) == 1 == _jax_probe(d)
    restored = CheckpointManager(d).restore(_lm(seed=1)[1])
    assert restored.step == 1


def test_torn_first_save_starts_fresh(tmp_path):
    """A crash during the FIRST-ever save (files damaged, no marker):
    restore() starts fresh instead of failing every relaunch."""
    from tensorflowonspark_tpu.testing import faults

    tr, state = _lm()
    d = str(tmp_path / "ck")
    state, _ = tr.train_step(state, next(_lm_batches(1)))
    CheckpointManager(d).save(state)
    os.unlink(os.path.join(d, ckpt_lib._marker_name(1)))
    faults.corrupt_step(d, mode="truncate")
    _, blank = _lm(seed=1)
    assert CheckpointManager(d).restore(blank) is blank


def test_unreadable_committed_step_raises(tmp_path):
    """No quiet fresh start over a committed step: a step whose marker
    validates but whose file cannot be read raises."""
    tr, state = _lm()
    d = str(tmp_path / "ck")
    state, _ = tr.train_step(state, next(_lm_batches(1)))
    CheckpointManager(d).save(state)
    path = os.path.join(d, "1", "default", "params.pt")
    size = os.path.getsize(path)
    with open(path, "wb") as f:  # same size, so the manifest validates
        f.write(b"\0" * size)
    assert ckpt_lib.latest_committed_step(d) == 1
    with pytest.raises(Exception):
        CheckpointManager(d).restore(_lm(seed=1)[1])


def test_markerless_foreign_tree_still_restores(tmp_path):
    """With no committed step at all, restore degrades to the latest step
    (trees written without markers)."""
    tr, state = _lm()
    d = str(tmp_path / "ck")
    state, _ = tr.train_step(state, next(_lm_batches(1)))
    CheckpointManager(d).save(state)
    for name in _markers(d):
        os.unlink(os.path.join(d, name))
    assert ckpt_lib.latest_committed_step(d) is None
    restored = CheckpointManager(d).restore(_lm(seed=1)[1])
    assert restored.step == 1


def test_force_save_purges_stale_remote_mirror(tmp_path):
    """Mirror-mode remotes: a force-rewrite of a foreign step purges the
    remote step first (same-size files would survive the incremental
    sync), and a fresh mirror pull sees the rewritten state."""
    remote = "memory://torch-ckpt-{}".format(uuid.uuid4().hex[:8])
    _, state = _lm()
    assert CheckpointManager(remote).save(state, force=True)
    assert ckpt_lib.latest_committed_step(remote) == 0 == _jax_probe(remote)
    original = _first_param(state)

    second = CheckpointManager(remote)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    assert second.save(state, force=True)

    third = CheckpointManager(remote)
    restored = third.restore(_lm(seed=1)[1])
    assert torch.equal(_first_param(restored), original + 1.0)


# -- the JAX probe on port trees, and the port's probe on JAX trees ---------

@pytest.mark.parametrize("damage", ["saves", "truncate_newest",
                                    "delete_newest_marker"])
def test_jax_probe_agrees_on_port_trees(tmp_path, damage):
    tr, state = _lm()
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, max_to_keep=3)
    for batch in _lm_batches(4):
        state, _ = tr.train_step(state, batch)
        mgr.save(state)
    if damage == "truncate_newest":
        path = os.path.join(d, "4", "default", "opt_state.pt")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 1)
    elif damage == "delete_newest_marker":
        os.unlink(os.path.join(d, ckpt_lib._marker_name(4)))
    want = 4 if damage == "saves" else 3
    assert _step_dirs(d) == [2, 3, 4]
    assert ckpt_lib.latest_committed_step(d) == want == _jax_probe(d)


def _jax_manager_and_state(d, **kw):
    import jax
    import optax

    from tensorflowonspark_tpu.models import factory as jax_factory
    from tensorflowonspark_tpu.parallel import MeshConfig
    from tensorflowonspark_tpu.train import Trainer as JaxTrainer

    tr = JaxTrainer(jax_factory.get_model("mlp", features=(4,),
                                          num_classes=2),
                    optimizer=optax.sgd(0.1),
                    mesh=MeshConfig(data=1).build(jax.devices()[:1]))
    state = tr.init(jax.random.PRNGKey(0),
                    {"x": np.zeros((2, 3), np.float32)})
    return jax_ckpt.CheckpointManager(d, **kw), state


def test_port_probe_reads_jax_tree(tmp_path):
    from tensorflowonspark_tpu.testing import faults

    d = str(tmp_path / "jax")
    mgr, state = _jax_manager_and_state(d, max_to_keep=3)
    for step in (1, 2, 3):
        assert mgr.save(state, step=step)
    assert ckpt_lib.latest_committed_step(d) == 3 == _jax_probe(d)
    faults.corrupt_step(d, mode="truncate")
    assert ckpt_lib.latest_committed_step(d) == 2 == _jax_probe(d)
    mgr.close()


# Each entry: (step, force). Covers the interval decision, declines at and
# below the latest step, forced saves of own steps (no-ops) and of a
# rotated-away lower step (appended last, so it becomes the latest), and a
# plain save at a step that exists without being the latest (raises).
SAVE_CALLS = [(0, False), (1, False), (2, False), (3, False), (3, False),
              (3, True), (2, False), (4, False), (5, True), (6, False),
              (6, False), (7, False), (9, False), (2, True), (9, False),
              (8, False), (12, False), (12, True), (13, True), (15, False),
              (16, False)]


@pytest.mark.parametrize("interval", [1, 3])
def test_save_decisions_match_orbax(tmp_path, interval):
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_mgr, jax_state = _jax_manager_and_state(
        jd, max_to_keep=2, save_interval_steps=interval)
    port_mgr = CheckpointManager(pd, max_to_keep=2,
                                 save_interval_steps=interval)
    _, port_state = _lm()

    def outcome(mgr, state, step, force):
        try:
            return mgr.save(state, step=step, force=force)
        except ValueError as e:  # orbax's StepAlreadyExistsError
            return "raises " + type(e).__name__

    trace = []
    for step, force in SAVE_CALLS:
        got = [outcome(jax_mgr, jax_state, step, force),
               outcome(port_mgr, port_state, step, force)]
        views = [(m.latest_step(), m.latest_committed_step(),
                  _step_dirs(d), _markers(d))
                 for m, d in ((jax_mgr, jd), (port_mgr, pd))]
        assert got[0] == got[1], (step, force, got)
        assert views[0] == views[1], (step, force, views)
        trace.append(got[1])
    jax_mgr.close()
    port_mgr.close()
    # The sequence does exercise saves, declines and the raise.
    assert True in trace and False in trace
    assert "raises StepAlreadyExistsError" in trace


# -- resume and serving restore -----------------------------------------------

@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_fit_resume_is_bitwise(tmp_path, kind):
    """fit 4 steps == fit 2, then a fresh model and trainer, restore, fit 2:
    every parameter, buffer (BatchNorm's running statistics) and optimizer
    moment, and the step."""
    make, batches = MAKERS[kind]
    tr, whole = make()
    whole, _ = tr.fit(whole, batches(4), depth=0)

    d = str(tmp_path / "ck")
    tr1, first = make()
    first, _ = tr1.fit(first, batches(2), checkpoint=d, checkpoint_every=2)
    tr2, fresh = make(seed=1)
    resumed = CheckpointManager(d).restore(fresh)
    assert resumed.step == 2
    rest = batches(4)
    next(rest), next(rest)
    resumed, hist = tr2.fit(resumed, rest)
    assert [h["step"] for h in hist] == [2, 3]
    _assert_states_equal(whole, resumed)
    assert resumed.optimizer.state_dict()["state"]
    if kind == "resnet_sgd_momentum":
        assert resumed.model_state  # the running statistics came along


def test_restore_variables_serves_without_optimizer_file(tmp_path,
                                                        monkeypatch):
    """restore_variables reads params.pt and model_state.pt only; greedy
    generate from its variables equals generate from the trainer's
    in-memory parameters, token for token."""
    tr, state = _lm()
    d = str(tmp_path / "ck")
    state, _ = tr.fit(state, _lm_batches(3), checkpoint=d)
    os.unlink(os.path.join(d, "3", "default", "opt_state.pt"))
    read = []
    load = torch.load
    monkeypatch.setattr(torch, "load", lambda path, *a, **k: (
        read.append(os.path.basename(path)), load(path, *a, **k))[1])
    variables = CheckpointManager(d).restore_variables()
    assert sorted(read) == ["model_state.pt", "params.pt"]
    live = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    assert variables.keys() == live.keys()

    prompt = np.random.RandomState(5).randint(1, LM_KW["vocab_size"],
                                              size=(2, 7))
    want = decoding.generate(tr.model, None, prompt, 12)
    serve = factory.get_model("transformer", device="cpu",
                              dtype=torch.float32, seed=3,
                              attention_impl="pallas", **LM_KW)
    got = decoding.generate(serve, decoding.serving_variables(
        variables, torch.float32), prompt, 12)
    assert torch.equal(got, want)
