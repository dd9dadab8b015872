"""Universal image-classifier trainer over the port's model zoo (port of
``examples/slim/train_image_classifier.py``): any registry model
(``--model_name``) on a TFRecord dataset of ``image``/``label`` columns, or
of ``image/encoded`` JPEG bytes with ``--jpeg`` (host decode and
augmentation on the input pipeline, the style's numeric half on the device
as the Trainer's ``input_fn``). The optimizer is the JAX example's: global
norm clipping at 1.0 over the chosen optimizer under a cosine decay.

Run::

    python examples/torch/cifar10/cifar10_data_setup.py --output /tmp/data
    python examples/torch/slim/train_image_classifier.py \\
        --dataset_dir /tmp/data --model_name cifarnet --image_size 24 \\
        --num_classes 10 --model_dir /tmp/slim_model --steps 50
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import common  # noqa: E402


def build_parser():
    parser = common.add_common_args(argparse.ArgumentParser())
    parser.add_argument("--dataset_dir", required=True,
                        help="TFRecord dir with image/label columns")
    parser.add_argument("--model_name", default="cifarnet",
                        help="any registry model (models.factory.available())")
    parser.add_argument("--model_dir", default="slim_model")
    parser.add_argument("--image_size", type=int, default=24)
    parser.add_argument("--num_classes", type=int, default=10)
    parser.add_argument("--learning_rate", type=float, default=0.01)
    parser.add_argument("--optimizer", choices=["sgd", "momentum", "adam",
                                                "adamw", "rmsprop"],
                        default="momentum")
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--fsdp", type=int, default=1,
                        help="shard params/optimizer over this many "
                             "processes (the num_ps_tasks analog)")
    parser.add_argument("--jpeg", action="store_true",
                        help="dataset holds image/encoded JPEG shards "
                             "(imagenet_data_setup.py --jpeg)")
    parser.add_argument("--preprocessing", default="auto",
                        choices=["auto", "inception", "vgg", "cifarnet",
                                 "lenet"],
                        help="--jpeg preprocessing family; auto picks the "
                             "per-model default")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="microbatches accumulated per optimizer step")
    return parser


def make_optimizer(args):
    import torch

    lr = args.learning_rate
    base = {
        "sgd": lambda p: torch.optim.SGD(p, lr=lr),
        "momentum": lambda p: torch.optim.SGD(p, lr=lr, momentum=0.9),
        "adam": lambda p: torch.optim.Adam(p, lr=lr, eps=1e-8),
        "adamw": lambda p: torch.optim.AdamW(
            p, lr=lr, eps=1e-8, weight_decay=args.weight_decay or 1e-4),
        "rmsprop": lambda p: torch.optim.RMSprop(p, lr=lr, alpha=0.9,
                                                 momentum=0.9, eps=1e-8),
    }[args.optimizer]
    return common.clipped(base, common.cosine_decay(lr, max(args.steps, 1)))


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = common.use_device(args.device)

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.data import dfutil
    from tensorflowonspark_tpu_torch.data import image_preprocessing as ip
    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.train import Trainer
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.train.losses import (
        accuracy, softmax_cross_entropy)
    from tensorflowonspark_tpu_torch.train.metrics import MetricsWriter

    shape = (args.image_size, args.image_size, 3)
    model = common.image_model(args.model_name, args.num_classes,
                               args.image_size, device)
    style = (ip.preprocessing_factory(args.model_name)
             if args.preprocessing == "auto" else args.preprocessing)
    input_fn = ip.input_normalizer(style) if args.jpeg else None
    if args.jpeg:
        print("preprocessing style: {} ({})".format(
            style, "per-model default" if args.preprocessing == "auto"
            else "forced"))
    trainer = Trainer(
        model,
        optimizer=make_optimizer(args),
        mesh=MeshConfig(data=-1, fsdp=args.fsdp).build(),
        loss_fn=lambda logits, batch: softmax_cross_entropy(
            logits, batch["y"], batch.get("mask")),
        grad_accum=args.grad_accum,
        input_fn=input_fn,
        device=str(device),
    )
    state = trainer.init()
    model_dir = os.path.abspath(args.model_dir)
    ckpt = CheckpointManager(model_dir, save_interval_steps=500)
    state = ckpt.restore(state)
    writer = MetricsWriter(model_dir)

    rows = None
    if not args.jpeg:
        rows = dfutil.load_tfrecords(os.path.abspath(args.dataset_dir))

    def batches(start_step):
        if args.jpeg:
            from tensorflowonspark_tpu_torch.data.input_pipeline import (
                InputPipeline)

            # A restarted run cannot seek a streaming pipeline to the
            # consumed offset: seeding by the restored step gives it a
            # fresh permutation instead of replaying the trained prefix.
            pipe = InputPipeline(
                os.path.abspath(args.dataset_dir),
                columns={"image/encoded": ("bytes", 0),
                         "label": ("int64", 1)},
                batch_size=args.batch_size, epochs=None,
                shuffle_files=True, seed=start_step, prefetch=4,
                drop_remainder=True,
                transform=ip.batch_transform(
                    args.image_size, train=True, seed=start_step,
                    image_key="image/encoded", style=style),
            )
            yield from pipe
            return
        n = len(rows)
        i = start_step  # resume continues at the restored data offset
        while True:
            lo = (i * args.batch_size) % max(n - args.batch_size, 1)
            chunk = rows[lo:lo + args.batch_size]
            x = np.stack([
                np.asarray(r["image"], np.float32).reshape(shape)
                for r in chunk
            ])
            y = np.asarray([int(r["label"]) for r in chunk], np.int64)
            yield {"x": x, "y": y,
                   "mask": np.ones((len(chunk),), np.float32)}
            i += 1

    step = int(state.step)
    t0 = time.time()
    it = batches(step) if step < args.steps else iter(())
    while step < args.steps:
        batch = next(it)
        state, metrics = trainer.train_step(state, batch)
        step = int(state.step)
        if step % 10 == 0:
            loss = float(metrics["loss"])
            rate = 10 * args.batch_size / (time.time() - t0)
            t0 = time.time()
            print("{}: step {}, loss {:.3f} ({:.1f} examples/sec)".format(
                args.model_name, step, loss, rate))
            writer.write(step, loss=loss, examples_per_sec=rate)
        ckpt.save(state)

    ckpt.save(state, force=True)
    ckpt.close()
    # Final train-set accuracy snapshot (eval-path preprocessing in --jpeg
    # mode: central crop, no augmentation; only probe rows load).
    if args.jpeg:
        from tensorflowonspark_tpu_torch.data import batch_decode, tfrecord

        records = []
        for path in dfutil.tfrecord_files(os.path.abspath(args.dataset_dir)):
            for rec in tfrecord.read_records(path):
                records.append(rec)
                if len(records) >= 512:
                    break
            if len(records) >= 512:
                break
        cols = batch_decode.decode_batch(
            records, {"image/encoded": ("bytes", 0), "label": ("int64", 1)})
        x = np.stack([
            ip.preprocess_one(e, args.image_size, style=style)
            for e in cols["image/encoded"]
        ])
        y = cols["label"].astype(np.int64)
    else:
        probe = rows[:min(512, len(rows))]
        x = np.stack([
            np.asarray(r["image"], np.float32).reshape(shape)
            for r in probe
        ])
        y = np.asarray([int(r["label"]) for r in probe], np.int64)
    logits = trainer.predict(state, x)
    acc = float(accuracy(logits, torch.as_tensor(y, device=logits.device)))
    print("final accuracy {:.3f}".format(acc))
    writer.write(step, final_accuracy=acc)
    writer.close()


if __name__ == "__main__":
    main()
