"""Node programs (``map_fun``s) for the port's cluster tests.

They live in a module of their own that imports only the port, numpy and
torch: a spawned executor unpickles a program by importing its module, and
the tests show that such an executor loads nothing of JAX or of the JAX
package. A test module imports JAX (through ``conftest.py``), so a program
defined there would bring JAX into every executor.
"""

import json
import os
import sys

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "tensorflowonspark_tpu")


def forbidden_modules():
    """Names of loaded modules that the port must never load."""
    # list() copies the keys at once: another thread may be importing.
    return sorted(m for m in list(sys.modules)
                  if any(m == r or m.startswith(r + ".") for r in FORBIDDEN))


def _dump(path, doc):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def square_feed(args, ctx):
    """Consume the feed and answer each item with its square (the
    reference's ``test_TFCluster`` FEED program)."""
    import torch

    df = ctx.get_data_feed(train_mode=False)
    while not df.should_stop():
        batch = df.next_batch(16)
        if batch:
            t = torch.as_tensor([float(x) for x in batch])
            df.batch_results([float(v) for v in torch.square(t)])
    if args and args.get("outdir"):
        _dump(os.path.join(args["outdir"], "feed_{}.json".format(
            ctx.executor_id)), {"forbidden": forbidden_modules(),
                                "pid": os.getpid()})


def sum_train_feed(args, ctx):
    """Sum every training item the node receives and record the sum."""
    df = ctx.get_data_feed(train_mode=True)
    total, count = 0.0, 0
    while not df.should_stop():
        batch = df.next_batch(8)
        total += float(sum(batch))
        count += len(batch)
    _dump(os.path.join(args["outdir"], "sum_{}.json".format(
        ctx.executor_id)), {"sum": total, "count": count})


def write_square_files(args, ctx):
    """FILES mode: every node squares its own id + 2 and writes it."""
    import torch

    out = float(torch.square(torch.tensor(float(ctx.executor_id) + 2.0)))
    _dump(os.path.join(args["outdir"], "node_{}.json".format(
        ctx.executor_id)), {"value": out,
                            "forbidden": forbidden_modules()})


def fail_feed(args, ctx):
    """Raise inside the node program after the first batch."""
    df = ctx.get_data_feed(train_mode=False)
    df.next_batch(1)
    raise ValueError("boom from node {}".format(ctx.executor_id))


def decoded_feed(args, ctx):
    """Train-mode feed through ``decoded_batches(4, ..., workers=2)``;
    writes the decoded batches (or raises the decode error)."""
    import torch_data_programs as data_progs

    df = ctx.get_data_feed(train_mode=True)
    fn = (data_progs.feed_rows_fail_on if args["fail"]
          else data_progs.feed_rows)
    batches = [b.tolist() for b in df.decoded_batches(4, fn, workers=2)]
    _dump(os.path.join(args["outdir"], "decoded_{}.json".format(
        ctx.executor_id)), {"batches": batches,
                            "forbidden": forbidden_modules()})


def agree_and_lockstep(args, ctx):
    """Join the gloo group, then record ``agree_sum`` and the batches
    :func:`multihost.lockstep` yields over uneven local streams."""
    from tensorflowonspark_tpu_torch.parallel import multihost

    joined = ctx.initialize_distributed(device="cpu")
    rank = multihost.process_index()
    summed = multihost.agree_sum([1.0, float(rank), 2.5])
    local = [{"x": np.full((2,), 10 * rank + i, np.int64),
              "mask": np.ones((2,), np.float32)}
             for i in range(args["lengths"][rank])]
    got = [{k: v.tolist() for k, v in b.items()}
           for b in multihost.lockstep(iter(local))]
    _dump(os.path.join(args["outdir"], "agree_{}.json".format(rank)), {
        "joined": joined, "rank": rank,
        "world": multihost.process_count(),
        "backend": ctx.distributed_backend,
        "sum": summed.tolist(), "batches": got,
        "batch_size": multihost.process_batch_size(8)})
    multihost.shutdown()


def _lm(args, device):
    import torch

    from tensorflowonspark_tpu_torch.models import factory

    return factory.get_model("transformer", device=device,
                             dtype=torch.float32, attention_impl="pallas",
                             **args["lm"])


def _lm_batch(arrays, mask):
    """Rows of ``S + 1`` tokens and the feed's per-row mask as a language
    model batch with a per-token mask."""
    arrays = np.asarray(arrays)
    seq = arrays.shape[1] - 1
    return {"x": arrays[:, :-1].astype(np.int64),
            "y": arrays[:, 1:].astype(np.int64),
            "mask": np.repeat(np.asarray(mask, np.float32)[:, None], seq, 1)}


def train_lm_data_parallel(args, ctx):
    """Data-parallel LM training through the feed's lockstep loop.

    Feed items are rows of ``args["seq"] + 1`` tokens. Every rank joins the gloo group, builds the toy LM from the weights in
    ``args["init"]``, and trains with ``Trainer.fit`` over
    ``sync_batches``; it records each batch it trained on, its final
    parameters and its node stats, and all ranks save one collective
    checkpoint."""
    import torch

    from tensorflowonspark_tpu_torch.parallel import MeshConfig, multihost
    from tensorflowonspark_tpu_torch.train import checkpoint as ckpt_lib
    from tensorflowonspark_tpu_torch.train import trainer as trainer_lib

    torch.set_num_threads(1)
    ctx.initialize_distributed(device="cpu")
    rank = multihost.process_index()
    model = _lm(args, ctx.device)
    tr = trainer_lib.Trainer(model, optimizer=trainer_lib.adamw(args["lr"]),
                             mesh=MeshConfig(data=-1).build(),
                             device=ctx.device)
    state = tr.init(params=torch.load(args["init"], weights_only=True))
    seen = []

    def batches():
        df = ctx.get_data_feed(train_mode=True)
        example = np.zeros((1, args["seq"] + 1), np.int64)
        for arrays, mask in df.sync_batches(args["batch_size"],
                                            example=example):
            b = _lm_batch(arrays, mask)
            seen.append(b)
            yield b

    state, history = tr.fit(state, batches(), flush_every=1)
    out = os.path.join(args["outdir"], "rank{}".format(rank))
    np.savez(out + "_batches.npz", **{
        "{}_{}".format(k, i): v for i, b in enumerate(seen)
        for k, v in b.items()})
    torch.save({k: v.detach().cpu() for k, v in state.params.items()},
               out + "_params.pt")
    ckpt = ckpt_lib.CheckpointManager(args["ckpt_dir"])
    ckpt.save(state, force=True)
    ckpt.close()
    _dump(out + ".json", {
        "steps": len(seen), "losses": [h["loss"] for h in history],
        "backend": ctx.distributed_backend,
        "forbidden": forbidden_modules()})
    multihost.shutdown()


def _probe(args, ctx, kind):
    """Record this process's forbidden modules (and its pid) under
    ``args["probe_dir"]``, one file per incarnation."""
    path = os.path.join(args["probe_dir"], "{}_{}_{}.json".format(
        kind, ctx.executor_id, os.getpid()))
    _dump(path, {"forbidden": forbidden_modules(), "pid": os.getpid(),
                 "executor_id": ctx.executor_id})


def supervised_probe(args, ctx):
    """``programs.supervised_linreg_fun`` behind a probe of the process's
    modules, taken after the program's imports (the probe runs once the
    first incarnation's program returns or raises)."""
    from tensorflowonspark_tpu_torch.testing import programs

    try:
        programs.supervised_linreg_fun(args, ctx)
    finally:
        _probe(args, ctx, "supervised")


def elastic_probe(args, ctx):
    """``programs.elastic_linreg_fun`` behind the same probe."""
    from tensorflowonspark_tpu_torch.testing import programs

    try:
        programs.elastic_linreg_fun(args, ctx)
    finally:
        _probe(args, ctx, "elastic")


def agent_task_probe(iterator):
    """A remote-backend task: the agent's executor reports its modules."""
    list(iterator)
    return [{"forbidden": forbidden_modules(), "pid": os.getpid(),
             "executor_idx": int(os.environ["TPU_FRAMEWORK_EXECUTOR_IDX"])}]


def dp_linreg_supervised(args, ctx):
    """Two-rank data-parallel linear regression under supervision.

    Every rank joins the gloo group, restores the collective checkpoint
    under ``args["model_dir"]``, trains on ``sync_batches`` with one
    collective save a step, and polls its own fault plan
    ``<plan_dir>/rank<r>`` after each commit. Audit lines (``resume``,
    ``step``) go to ``<log_dir>/rank<r>.log``; the final parameters to
    ``<log_dir>/rank<r>_params.pt``."""
    import torch

    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.parallel import MeshConfig, multihost
    from tensorflowonspark_tpu_torch.testing.faults import FaultPlan
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.train.losses import mse

    torch.set_num_threads(1)
    ctx.initialize_distributed(device="cpu")
    rank = multihost.process_index()
    log = os.path.join(args["log_dir"], "rank{}".format(rank))

    def note(line):
        with open(log + ".log", "a") as f:
            f.write(line + "\n")

    tr = Trainer(factory.get_model("linear_regression", device="cpu"),
                 optimizer=trainer.sgd(0.5),
                 mesh=MeshConfig(data=-1).build(),
                 loss_fn=lambda out, b: mse(out, b["y"], b.get("mask")),
                 device="cpu")
    ckpt = CheckpointManager(args["model_dir"], max_to_keep=50)
    state = ckpt.restore(tr.init())
    note("resume {}".format(state.step))
    plan = FaultPlan(os.path.join(args["plan_dir"], "rank{}".format(rank)))
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping={"c0": "x", "c1": "y"})
    example = {"x": np.zeros((1, 2), np.float32),
               "y": np.zeros((1,), np.float32)}
    for arrays, mask in feed.sync_batches(8, example=example):
        state, m = tr.train_step(state, {
            "x": np.asarray(arrays["x"], np.float32),
            "y": np.asarray(arrays["y"], np.float32).reshape(-1, 1),
            "mask": mask.astype(np.float32)})
        ckpt.save(state, force=True)
        note("step {} {:.6f}".format(state.step, float(m["loss"])))
        plan.on_step(state.step, checkpoint_dir=args["model_dir"])
    ckpt.close()
    torch.save({k: v.detach() for k, v in state.params.items()},
               log + "_params.pt")
    multihost.shutdown()


# -- remote-backend tasks (run inline in an agent) ----------------------------


def square_partition(iterator):
    return [x * x for x in iterator]


def sleep_forever(iterator):
    import time

    list(iterator)
    time.sleep(3600)


def whoami(iterator):
    list(iterator)
    return [int(os.environ["TPU_FRAMEWORK_EXECUTOR_IDX"]), os.getpid()]


def retry_if_first(iterator):
    from tensorflowonspark_tpu_torch import backend

    list(iterator)
    if os.environ["TPU_FRAMEWORK_EXECUTOR_IDX"] == "0":
        raise backend.RetryTask("wrong executor")
    return ["ran"]


def train_lm_tensor_parallel(args, ctx):
    """Tensor-parallel LM training through the feed (``args["mesh"]``,
    e.g. ``{"data": 1, "tensor": 2}``): ``sync_batches(..., mesh=)``
    hands the ranks of a ``seq x tensor`` group the same rows (their fed
    rows concatenated), and ``Trainer.fit`` trains the sharded model on
    them. Each rank records the batches it trained on and its losses."""
    import torch

    from tensorflowonspark_tpu_torch.parallel import MeshConfig, multihost
    from tensorflowonspark_tpu_torch.train import trainer as trainer_lib

    torch.set_num_threads(1)
    ctx.initialize_distributed(device="cpu")
    rank = multihost.process_index()
    mesh = MeshConfig(**args["mesh"]).build()
    tr = trainer_lib.Trainer(_lm(args, ctx.device),
                             optimizer=trainer_lib.adamw(args["lr"]),
                             mesh=mesh, device=ctx.device)
    state = tr.init(params=torch.load(args["init"], weights_only=True))
    seen = []

    def batches():
        df = ctx.get_data_feed(train_mode=True)
        example = np.zeros((1, args["seq"] + 1), np.int64)
        for arrays, mask in df.sync_batches(args["batch_size"],
                                            example=example, mesh=mesh):
            b = _lm_batch(arrays, mask)
            seen.append(b)
            yield b

    state, history = tr.fit(state, batches(), flush_every=1)
    out = os.path.join(args["outdir"], "rank{}".format(rank))
    np.savez(out + "_batches.npz", **{
        "{}_{}".format(k, i): v for i, b in enumerate(seen)
        for k, v in b.items()})
    _dump(out + ".json", {
        "steps": len(seen), "losses": [h["loss"] for h in history],
        "backend": ctx.distributed_backend,
        "forbidden": forbidden_modules()})
    multihost.shutdown()
