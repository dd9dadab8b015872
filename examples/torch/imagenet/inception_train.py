"""Inception training over the cluster feed plane on the port (port of
``examples/imagenet/inception_train.py``): the driver pushes (image,
label) rows through the feed plane, every worker joins one process group,
and the gradient all-reduce is the port Trainer's. The optimizer is the
JAX example's: RMSProp (decay 0.9, momentum 0.9, epsilon 1.0) under an
exponential decay (0.94 every 2000 steps), global-norm clipping at 1.0.

Run::

    python examples/torch/imagenet/imagenet_data_setup.py --output /tmp/inet \\
        --image_size 75 --num_classes 50
    python examples/torch/imagenet/inception_train.py --data_dir /tmp/inet \\
        --image_size 75 --num_classes 50 --model_dir /tmp/inception_model \\
        --steps 20
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import common  # noqa: E402


def train_fun(args, ctx):
    import time

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.paths import strip_scheme
    from tensorflowonspark_tpu_torch.train import Trainer
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.train.losses import softmax_cross_entropy
    from tensorflowonspark_tpu_torch.train.metrics import MetricsWriter

    dist = ctx.initialize_distributed(device=args.device)
    device = ctx.device if dist else common.use_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(common.CPU_THREADS)
    is_chief = ctx.task_index == 0
    shape = (args.image_size, args.image_size, 3)
    model_dir = strip_scheme(ctx.absolute_path(args.model_dir))

    trainer = Trainer(
        common.image_model(args.model_name, args.num_classes + 1,
                           args.image_size, device),
        optimizer=common.clipped(
            lambda p: torch.optim.RMSprop(p, lr=args.learning_rate,
                                          alpha=0.9, momentum=0.9, eps=1.0),
            common.exponential_decay(args.learning_rate, 2000, 0.94)),
        mesh=MeshConfig(data=-1, fsdp=args.fsdp).build(),
        loss_fn=lambda logits, batch: softmax_cross_entropy(
            logits, batch["y"], batch.get("mask")),
        device=str(device),
    )
    state = trainer.init()
    ckpt = CheckpointManager(model_dir, save_interval_steps=500)
    state = ckpt.restore(state)
    writer = MetricsWriter(model_dir) if is_chief else None

    feed = ctx.get_data_feed(
        train_mode=True, input_mapping={"image": "x", "label": "y"})
    example = {"x": np.zeros((1,) + shape, np.float32),
               "y": np.zeros((1,), np.int64)}
    step = int(state.step)
    t0 = time.time()
    for arrays, mask in feed.sync_batches(args.batch_size, example=example):
        batch = {
            "x": np.asarray(arrays["x"], np.float32).reshape((-1,) + shape),
            "y": np.asarray(arrays["y"], np.int64).reshape(-1),
            "mask": mask.astype(np.float32),
        }
        state, metrics = trainer.train_step(state, batch)
        step = int(state.step)
        if is_chief and step % 10 == 0:
            loss = float(metrics["loss"])
            rate = 10 * args.batch_size / (time.time() - t0)
            t0 = time.time()
            print("step {}: loss {:.3f} ({:.1f} examples/sec)".format(
                step, loss, rate))
            writer.write(step, loss=loss, examples_per_sec=rate)
        if dist or is_chief:
            ckpt.save(state)
        if step >= args.steps:
            feed.terminate()
            break

    if dist or is_chief:
        ckpt.save(state, force=True)
    ckpt.close()
    if is_chief:
        writer.close()


def main(argv=None):
    parser = common.add_common_args(argparse.ArgumentParser())
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--model_name", default="inception_v3",
                        help="inception_v1..v4 or inception_resnet_v2")
    parser.add_argument("--model_dir", default="inception_model")
    parser.add_argument("--image_size", type=int, default=299)
    parser.add_argument("--num_classes", type=int, default=1000)
    parser.add_argument("--learning_rate", type=float, default=0.045)
    parser.add_argument("--fsdp", type=int, default=1)
    parser.add_argument("--num_partitions", type=int, default=8)
    args = parser.parse_args(argv)
    common.use_device(args.device)

    import numpy as np

    from tensorflowonspark_tpu_torch import backend, cluster
    from tensorflowonspark_tpu_torch.data import dfutil

    args.model_dir = os.path.abspath(args.model_dir)
    rows = dfutil.load_tfrecords(os.path.abspath(args.data_dir))
    items = [
        (np.asarray(r["image"], np.float32), int(r["label"])) for r in rows
    ]
    data = backend.Partitioned.from_items(items, args.num_partitions)
    pool = backend.LocalBackend(args.cluster_size)
    try:
        c = cluster.run(pool, train_fun, args,
                        num_executors=args.cluster_size,
                        input_mode=cluster.InputMode.FEED)
        c.train(data, num_epochs=args.epochs)
        c.shutdown()
    finally:
        pool.stop()
    print("model written to {}".format(args.model_dir))


if __name__ == "__main__":
    main()
