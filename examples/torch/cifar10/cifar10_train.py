"""CIFAR-10 training on the port (port of ``examples/cifar10/
cifar10_train.py``): CifarNet, SGD with momentum 0.9 under a cosine decay
from 0.05 and global-norm clipping at 1.0, the batch sharded over the data
axis of every process. Prints the tutorial's sec/batch + examples/sec log
line.

Run (single process)::

    python examples/torch/cifar10/cifar10_data_setup.py --output /tmp/c10
    python examples/torch/cifar10/cifar10_train.py --data_dir /tmp/c10 \\
        --model_dir /tmp/cifar10_model

Multi-executor (one process a node, data-parallel across all)::

    python examples/torch/cifar10/cifar10_train.py --distributed \\
        --cluster_size 2 --data_dir /tmp/c10 --model_dir /tmp/cifar10_model
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import common  # noqa: E402

IMAGE = (24, 24, 3)


def train_fun(args, ctx):
    """Per-node program; also callable inline for the single-process path."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.data import dfutil, input_pipeline
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.parallel import MeshConfig, multihost
    from tensorflowonspark_tpu_torch.paths import strip_scheme
    from tensorflowonspark_tpu_torch.train import Trainer
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.train.losses import softmax_cross_entropy
    from tensorflowonspark_tpu_torch.train.metrics import MetricsWriter

    dist = ctx.initialize_distributed(device=args.device) \
        if ctx is not None else False
    device = ctx.device if dist else common.use_device(args.device)
    if dist and device.type == "cpu":
        torch.set_num_threads(common.CPU_THREADS)
    task_index = ctx.task_index if ctx is not None else 0
    num_workers = ctx.num_workers if ctx is not None else 1
    is_chief = task_index == 0

    model_dir = os.path.abspath(args.model_dir) if ctx is None else \
        strip_scheme(ctx.absolute_path(args.model_dir))
    data_dir = os.path.abspath(args.data_dir) if ctx is None else \
        strip_scheme(ctx.absolute_path(args.data_dir))

    files = sorted(dfutil.tfrecord_files(data_dir))
    mine = files[task_index::num_workers]

    trainer = Trainer(
        factory.get_model("cifarnet", device=str(device)),
        optimizer=common.clipped(
            lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9),
            common.cosine_decay(0.05, max(args.steps, 1))),
        mesh=MeshConfig(data=-1).build(),
        loss_fn=lambda logits, batch: softmax_cross_entropy(
            logits, batch["y"], batch.get("mask")),
        device=str(device),
    )
    state = trainer.init()
    ckpt = CheckpointManager(model_dir, save_interval_steps=500)
    state = ckpt.restore(state)
    writer = MetricsWriter(model_dir) if is_chief else None

    def batches():
        """The native input pipeline over this node's shard (record IO and
        Example decode in C++ where the codecs build)."""
        if not mine:
            return

        def to_model_batch(b):
            return {
                "x": b["image"].reshape((-1,) + IMAGE).astype(np.float32),
                "y": b["label"].astype(np.int64),
                "mask": b["mask"].astype(np.float32),
            }

        pipe = input_pipeline.InputPipeline(
            mine,
            columns={"image": ("float", int(np.prod(IMAGE))),
                     "label": ("int64", 1)},
            batch_size=args.batch_size, epochs=None,
            shuffle_files=True, seed=0, prefetch=4,
            transform=to_model_batch,
        )
        for b in pipe:
            yield b

    zero = {
        "x": np.zeros((args.batch_size,) + IMAGE, np.float32),
        "y": np.zeros((args.batch_size,), np.int64),
        "mask": np.zeros((args.batch_size,), np.float32),
    }
    step = int(state.step)
    t0 = time.time()
    window = 10
    for batch in multihost.lockstep(batches(), zero=zero):
        if step >= args.steps:
            break
        state, metrics = trainer.train_step(state, batch)
        step = int(state.step)
        if is_chief and step % window == 0:
            loss = float(metrics["loss"])
            dt = (time.time() - t0) / window
            t0 = time.time()
            # The tutorial's log line: step, loss, examples/sec, sec/batch.
            print("step {}, loss = {:.2f} ({:.1f} examples/sec; {:.3f} "
                  "sec/batch)".format(step, loss, args.batch_size / dt, dt))
            writer.write(step, loss=loss, sec_per_batch=dt)
        if dist or is_chief:
            ckpt.save(state)

    if dist or is_chief:
        ckpt.save(state, force=True)
    ckpt.close()
    if is_chief:
        writer.close()


def main(argv=None):
    parser = common.add_common_args(argparse.ArgumentParser())
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--model_dir", default="cifar10_model")
    parser.add_argument("--distributed", action="store_true",
                        help="run via the cluster runtime (one executor "
                             "process per node) instead of inline")
    parser.set_defaults(steps=2000)
    args = parser.parse_args(argv)
    common.use_device(args.device)

    if not args.distributed:
        train_fun(args, None)
        return

    from tensorflowonspark_tpu_torch import backend, cluster

    args.data_dir = os.path.abspath(args.data_dir)
    args.model_dir = os.path.abspath(args.model_dir)
    pool = backend.LocalBackend(args.cluster_size)
    try:
        c = cluster.run(pool, train_fun, args,
                        num_executors=args.cluster_size,
                        input_mode=cluster.InputMode.FILES)
        c.shutdown()
    finally:
        pool.stop()


if __name__ == "__main__":
    main()
