"""The port's sequence packing against the JAX package's, and the toy
packed-from-files training run.

``pack_documents``, ``unpack_documents``, ``packing_efficiency`` and
``packed_batches`` return equal arrays for the same seeded documents
(every ``oversize`` mode, ``min_fill``, ``drop_remainder`` either way).
Then the FILES-mode path at toy width: token documents written with
``dfutil.save_as_tfrecords`` into shards, read by ``InputPipeline`` with a
transform that strips each document's padding, packed by
``packed_batches`` (``chip_smoke.py``'s files phase's pipeline, at toy
width): the port's batches equal the JAX pipeline's bitwise,
and three steps of the port's ``Trainer`` on them agree with the JAX
``Trainer`` on the same batches and weights within the trainer tests'
1e-5 (the JAX side runs Pallas in interpret mode, the port's side B1-B3's
plain versions). A row of padding alone (segment 0 everywhere) gives a
finite loss and no gradient: the gradients do not change, bit for bit,
when that row's tokens do.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import torch_data_programs as progs
from tensorflowonspark_tpu.data import dfutil as jax_dfutil
from tensorflowonspark_tpu.data import packing as jax_packing
from tensorflowonspark_tpu.data.input_pipeline import (
    InputPipeline as JaxPipeline,
)
from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.parallel import MeshConfig
from tensorflowonspark_tpu.train import Trainer as JaxTrainer
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.data import dfutil as port_dfutil
from tensorflowonspark_tpu_torch.data import packing as port_packing
from tensorflowonspark_tpu_torch.data.input_pipeline import InputPipeline
from tensorflowonspark_tpu_torch.models import factory
from tensorflowonspark_tpu_torch.train import Trainer

pytestmark = pytest.mark.watchdog_timeout(120)

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
SEQ, ROWS, STEPS = 32, 4, 3
TOL = 1e-5
ADAM_LR = 1e-3
ADAM_NEAR_EPS = 1e-7
MAX_DOC = 96


@pytest.fixture(autouse=True)
def _nothing_left():
    before = progs.live_children()
    yield
    assert progs.wait_no_new_children(before) == set()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _docs(n=60, seed=0, lo=4, hi=MAX_DOC, vocab=64):
    """Documents with lengths log-uniform over [lo, hi]."""
    rng = np.random.RandomState(seed)
    lens = np.exp(rng.uniform(np.log(lo), np.log(hi), size=n)).astype(int)
    return [rng.randint(1, vocab, size=k).astype(np.int32) for k in lens]


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)


@pytest.mark.parametrize("min_fill", [0.0, 0.5])
@pytest.mark.parametrize("oversize", ["split", "truncate"])
def test_pack_documents_equal_to_jax(oversize, min_fill):
    docs = _docs(seed=1, hi=80)
    got = port_packing.pack_documents(docs, SEQ, oversize, min_fill)
    want = jax_packing.pack_documents(docs, SEQ, oversize, min_fill)
    _equal(got, want)
    assert port_packing.packing_efficiency(got) == \
        jax_packing.packing_efficiency(want)
    for g, w in zip(port_packing.unpack_documents(got),
                    jax_packing.unpack_documents(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [dict(seq_len=0), dict(oversize="drop"),
                                dict(oversize="error")])
def test_pack_errors_match_jax(kw):
    args = dict(dict(seq_len=SEQ, oversize="split"), **kw)
    docs = _docs(seed=2, hi=80)
    with pytest.raises(ValueError) as want:
        jax_packing.pack_documents(docs, **args)
    with pytest.raises(ValueError) as got:
        port_packing.pack_documents(docs, **args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_packed_batches_equal_to_jax(drop_remainder):
    docs = _docs(70, seed=3)
    kw = dict(seq_len=SEQ, batch_rows=ROWS, drop_remainder=drop_remainder,
              min_fill=0.25, target_key="labels")
    got = list(port_packing.packed_batches(iter(docs), **kw))
    want = list(jax_packing.packed_batches(iter(docs), **kw))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        _equal(g, w)
    if not drop_remainder:
        assert (got[-1]["segment_ids"] == 0).all(axis=1).any()
    assert port_packing.packing_efficiency({"segment_ids": np.zeros(0)}) == \
        jax_packing.packing_efficiency({"segment_ids": np.zeros(0)}) == 0.0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    docs = _docs(90, seed=4)
    rows = [{"tokens": d.tolist(), "length": len(d)} for d in docs]
    out = str(tmp_path_factory.mktemp("corpus") / "docs")
    port_dfutil.save_as_tfrecords(rows, out, num_shards=4)
    return out, docs


COLUMNS = {"tokens": ("int64", MAX_DOC), "length": ("int64", 1)}


def _file_batches(pipeline_cls, packing_mod, path, shard, workers=None,
                  drop_remainder=True):
    kw = {} if workers is None else {"decode_workers": workers}
    pipe = pipeline_cls(path, COLUMNS, batch_size=8, shard=shard,
                        transform=chip_smoke.strip_padding, **kw)
    docs = (d for b in pipe for d in b["docs"])
    return list(packing_mod.packed_batches(
        docs, seq_len=SEQ, batch_rows=ROWS, drop_remainder=drop_remainder))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shard", [(1, 0), (2, 1)])
def test_packed_batches_from_files_equal_to_jax(corpus, shard, workers):
    path, docs = corpus
    got = _file_batches(InputPipeline, port_packing, path, shard, workers)
    want = _file_batches(JaxPipeline, jax_packing, path, shard)
    assert len(got) == len(want) >= STEPS
    for g, w in zip(got, want):
        _equal(g, w)
    if shard == (1, 0):
        # Every document, in shard-file order, survives the trip.
        stored = port_dfutil.load_tfrecords(path)
        assert sorted(len(r["tokens"]) for r in stored) == \
            sorted(len(d) for d in docs)


def _jax_run(batches):
    """Three JAX ``Trainer`` steps under Adam from its own init: the initial
    params, the losses, step 1's gradients and the final params."""
    jm = jax_factory.get_model("transformer", dtype=jnp.float32,
                               **dict(LM_KW, attention_impl="pallas"))
    capture = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    tr = JaxTrainer(jm, optimizer=optax.chain(capture, optax.adam(ADAM_LR)),
                    donate=False,
                    mesh=MeshConfig(data=1).build(jax.devices()[:1]))
    state = tr.init(jax.random.PRNGKey(0), batches[0])
    run = {"params0": jax.device_get(nn.meta.unbox(state.params)),
           "losses": []}
    for i, b in enumerate(batches):
        state, m = tr.train_step(state, b)
        run["losses"].append(float(m["loss"]))
        if i == 0:
            run["grads1"] = _flat(state.opt_state[0])
    run["params"] = _flat(state.params)
    return run


def _flat(tree):
    tree = jax.device_get(nn.meta.unbox(tree))
    return {k.replace("/", "."): np.asarray(v)
            for k, v in convert._flat(tree).items()}


def _port_trainer(params0):
    model = factory.get_model("transformer", device="cpu",
                              dtype=torch.float32,
                              **dict(LM_KW, attention_impl="pallas"))
    tr = Trainer(model, device="cpu")  # torch Adam at 1e-3
    return tr, tr.init(params=convert.params_from_flax(params0, model.cfg))


def test_three_steps_from_record_files_match_jax_trainer(corpus):
    path, _ = corpus
    batches = _file_batches(InputPipeline, port_packing, path, (1, 0))[:STEPS]
    assert any((b["segment_ids"].max(axis=1) > 1).any() for b in batches)
    run = _jax_run(batches)
    tr, state = _port_trainer(run["params0"])
    losses = []
    for b in batches:
        state, m = tr.train_step(state, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, run["losses"], rtol=0, atol=TOL)
    assert losses[-1] < losses[0]
    for name, p in state.params.items():
        got, want = p.detach().numpy(), run["params"][name]
        near = np.abs(run["grads1"][name]) < ADAM_NEAR_EPS
        np.testing.assert_allclose(got[~near], want[~near], rtol=0, atol=TOL,
                                   err_msg=name)
        assert np.all(np.abs(got[near] - want[near]) <= STEPS * ADAM_LR)


def test_all_padding_row_gives_finite_loss_and_no_gradient(corpus):
    path, _ = corpus
    batch = _file_batches(InputPipeline, port_packing, path, (1, 0),
                          drop_remainder=False)[-1]
    pad = (batch["segment_ids"] == 0).all(axis=1)
    if not pad.any():  # make one: the last row padding alone
        batch = {k: v.copy() for k, v in batch.items()}
        for k in batch:
            batch[k][-1] = 0
        pad = (batch["segment_ids"] == 0).all(axis=1)
    other = {k: v.copy() for k, v in batch.items()}
    rng = np.random.RandomState(9)
    other["x"][pad] = rng.randint(1, 64, size=other["x"][pad].shape)
    other["y"] = other["x"]
    grads = []
    for b in (batch, other):
        tr, state = _port_trainer(_jax_init())
        state, m = tr.train_step(state, b)
        assert np.isfinite(float(m["loss"]))
        grads.append({k: p.grad.clone() for k, p in state.params.items()})
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


_INIT = []


def _jax_init():
    if not _INIT:
        jm = jax_factory.get_model("transformer", dtype=jnp.float32,
                                   **dict(LM_KW, attention_impl="pallas"))
        tr = JaxTrainer(jm, optimizer=optax.adam(ADAM_LR), donate=False,
                        mesh=MeshConfig(data=1).build(jax.devices()[:1]))
        x = np.zeros((ROWS, SEQ), np.int32)
        state = tr.init(jax.random.PRNGKey(0), {"x": x, "y": x})
        _INIT.append(jax.device_get(nn.meta.unbox(state.params)))
    return _INIT[0]
