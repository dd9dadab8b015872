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
    return sorted(m for m in sys.modules
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
