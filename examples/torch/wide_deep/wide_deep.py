"""Wide & Deep CTR training on the port's cluster runtime (port of
``examples/wide_deep/wide_deep.py``): the same synthetic census-style
table (6 categorical + 3 numeric features, a label mixing a feature cross
with a numeric threshold), fed through the feed plane, Adam at 1e-2, then
a driver-side eval with accuracy and AUC. The port's ``WideDeep`` takes the
``(categorical, numeric)`` tuple itself, so the batch's ``"x"`` is that
tuple and no adapter module is needed.

Run::

    python examples/torch/wide_deep/wide_deep.py --steps 200
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import common  # noqa: E402

VOCABS = (16, 12, 8, 24, 6, 10)
NUM_NUMERIC = 3


def synthesize(n, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    cat = np.stack(
        [rng.randint(0, v, size=n) for v in VOCABS], axis=1
    ).astype(np.int32)
    num = rng.rand(n, NUM_NUMERIC).astype(np.float32)
    # Truth: a cross of features 0x1 plus a numeric threshold.
    cross = (cat[:, 0] * 3 + cat[:, 1]) % 7
    logit = (cross > 3).astype(np.float32) * 1.5 + (num[:, 0] > 0.6) * 1.0 - 1.2
    prob = 1.0 / (1.0 + np.exp(-logit))
    y = (rng.rand(n) < prob).astype(np.int32)
    return cat, num, y


def make_trainer(device):
    """One definition for the train and eval sides, so the checkpoint's
    names always match."""
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train.losses import softmax_cross_entropy

    model = factory.get_model(
        "wide_deep", vocab_sizes=VOCABS, embed_dim=8, deep_features=(64, 32),
        wide_hash_buckets=4096, num_numeric=NUM_NUMERIC, device=str(device))
    return Trainer(
        model, optimizer=trainer.adam(1e-2),
        mesh=MeshConfig(data=-1).build(),
        loss_fn=lambda logits, batch: softmax_cross_entropy(
            logits, batch["y"], batch.get("mask")),
        device=str(device))


def train_fun(args, ctx):
    import numpy as np

    from tensorflowonspark_tpu_torch.paths import strip_scheme
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    dist = ctx.initialize_distributed(device=args.device)
    device = ctx.device if dist else common.use_device(args.device)
    is_chief = ctx.task_index == 0

    trainer = make_trainer(device)
    state = trainer.init()
    ckpt = CheckpointManager(
        strip_scheme(ctx.absolute_path(args.model_dir)),
        save_interval_steps=200)
    state = ckpt.restore(state)

    feed = ctx.get_data_feed(
        train_mode=True,
        input_mapping={"cat": "a_cat", "num": "b_num", "label": "c_y"})
    example = {"a_cat": np.zeros((1, len(VOCABS)), np.int32),
               "b_num": np.zeros((1, NUM_NUMERIC), np.float32),
               "c_y": np.zeros((1,), np.int64)}
    step = int(state.step)
    for arrays, mask in feed.sync_batches(args.batch_size, example=example):
        batch = {
            "x": (np.asarray(arrays["a_cat"], np.int32),
                  np.asarray(arrays["b_num"], np.float32)),
            "y": np.asarray(arrays["c_y"], np.int64).reshape(-1),
            "mask": mask.astype(np.float32),
        }
        state, metrics = trainer.train_step(state, batch)
        step = int(state.step)
        if is_chief and step % 50 == 0:
            print("step {}: loss {:.4f}".format(step, float(metrics["loss"])))
        if dist or is_chief:
            ckpt.save(state)
        if step >= args.steps:
            feed.terminate()
            break
    if dist or is_chief:
        ckpt.save(state, force=True)
    ckpt.close()


def main(argv=None):
    parser = common.add_common_args(argparse.ArgumentParser())
    parser.add_argument("--model_dir", default="wide_deep_model")
    parser.add_argument("--num_examples", type=int, default=8192)
    parser.set_defaults(steps=200, batch_size=256, epochs=8)
    args = parser.parse_args(argv)
    device = common.use_device(args.device)

    import numpy as np

    from tensorflowonspark_tpu_torch import backend, cluster
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    args.model_dir = os.path.abspath(args.model_dir)
    cat, num, y = synthesize(args.num_examples)
    items = [(cat[i], num[i], int(y[i])) for i in range(len(y))]
    data = backend.Partitioned.from_items(items, 8)
    pool = backend.LocalBackend(args.cluster_size)
    try:
        c = cluster.run(pool, train_fun, args,
                        num_executors=args.cluster_size,
                        input_mode=cluster.InputMode.FEED)
        c.train(data, num_epochs=args.epochs)
        c.shutdown()
    finally:
        pool.stop()

    # Driver-side eval on a held-out sample: accuracy + AUC.
    trainer = make_trainer(device)
    cat, num, y = synthesize(4096, seed=123)
    mgr = CheckpointManager(args.model_dir)
    state = mgr.restore(trainer.init())
    mgr.close()
    logits = trainer.predict(state, (cat, num)).float().cpu().numpy()
    prob = np.exp(logits[:, 1]) / np.exp(logits).sum(axis=1)
    acc, auc = common.accuracy_auc(prob, y)
    print("accuracy = {:.4f}  AUC = {:.4f}".format(acc, auc))


if __name__ == "__main__":
    main()
