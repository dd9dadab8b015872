"""Criteo-style CTR on the port: hashed-cross-feature logistic regression
(port of ``examples/criteo/criteo.py``). The same synthetic rows with
Criteo's column layout (13 numeric + 26 categorical), hashed host-side into
2^18 buckets; the model is the wide path alone — an id-to-weight table and
a bias — trained through the feed plane with Adagrad at 0.2, then a
driver-side eval with accuracy and AUC.

Run::

    python examples/torch/criteo/criteo.py --steps 150
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import common  # noqa: E402

NUM_NUMERIC = 13
NUM_CATEGORICAL = 26
HASH_BUCKETS = 2 ** 18


def synthesize(n, seed=0):
    """Synthetic rows shaped like Criteo's: label + 13 ints + 26 cat ids."""
    import numpy as np

    rng = np.random.RandomState(seed)
    numeric = rng.exponential(1.0, size=(n, NUM_NUMERIC)).astype(np.float32)
    cards = [130] + [int(c) for c in
                     np.geomspace(20, 50000, NUM_CATEGORICAL - 1)]
    cat_raw = np.stack(
        [rng.randint(0, c, size=n) for c in cards], axis=1
    )
    logit = ((cat_raw[:, 0] % 13 > 6) * 1.2
             + (numeric[:, 1] > 1.0) * 0.8 - 1.0)
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int32)
    return numeric, cat_raw, y


def hash_features(numeric, cat_raw):
    """Host-side feature hashing: each categorical value and each
    bucketized numeric to one id in [0, buckets)."""
    import numpy as np

    cols = []
    for i in range(NUM_CATEGORICAL):
        cols.append((cat_raw[:, i] * 31 + i * 2654435761) % HASH_BUCKETS)
    for i in range(NUM_NUMERIC):
        b = np.minimum(np.log1p(numeric[:, i]) * 4, 15).astype(np.int64)
        cols.append((b * 97 + (NUM_CATEGORICAL + i) * 2654435761) % HASH_BUCKETS)
    return np.stack(cols, axis=1).astype(np.int32)


def make_trainer(device):
    """Logistic regression over hashed ids: one weight table (``table``,
    zeros at init) and a bias. One definition for the train and eval sides,
    so the checkpoint's names always match."""
    import torch

    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.train import Trainer
    from tensorflowonspark_tpu_torch.train.losses import softmax_cross_entropy

    class HashedLR(torch.nn.Module):
        def __init__(self, buckets):
            super().__init__()
            self.table = torch.nn.Parameter(torch.zeros(buckets, 2))
            self.bias = torch.nn.Parameter(torch.zeros(2))

        def reset_parameters(self, seed):
            with torch.no_grad():
                self.table.zero_()
                self.bias.zero_()

        def forward(self, ids):
            ids = torch.as_tensor(ids, device=self.table.device)
            return self.table[ids].sum(dim=1) + self.bias

    return Trainer(
        HashedLR(HASH_BUCKETS).to(device),
        optimizer=lambda p: torch.optim.Adagrad(
            p, lr=0.2, initial_accumulator_value=0.1, eps=1e-7),
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
    n_feats = NUM_NUMERIC + NUM_CATEGORICAL
    state = trainer.init()
    ckpt = CheckpointManager(
        strip_scheme(ctx.absolute_path(args.model_dir)),
        save_interval_steps=500)
    state = ckpt.restore(state)

    feed = ctx.get_data_feed(
        train_mode=True, input_mapping={"ids": "x", "label": "y"})
    example = {"x": np.zeros((1, n_feats), np.int32),
               "y": np.zeros((1,), np.int64)}
    step = int(state.step)
    for arrays, mask in feed.sync_batches(args.batch_size, example=example):
        batch = {
            "x": np.asarray(arrays["x"], np.int64),
            "y": np.asarray(arrays["y"], np.int64).reshape(-1),
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
    parser.add_argument("--model_dir", default="criteo_model")
    parser.add_argument("--num_examples", type=int, default=16384)
    parser.set_defaults(steps=400, batch_size=512, epochs=24)
    args = parser.parse_args(argv)
    device = common.use_device(args.device)

    import numpy as np

    from tensorflowonspark_tpu_torch import backend, cluster
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    args.model_dir = os.path.abspath(args.model_dir)
    numeric, cat_raw, y = synthesize(args.num_examples)
    ids = hash_features(numeric, cat_raw)
    items = [(ids[i], int(y[i])) for i in range(len(y))]
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

    # Driver-side eval: accuracy + AUC, the reference's reported metrics.
    trainer = make_trainer(device)
    numeric, cat_raw, y = synthesize(8192, seed=777)
    ids = hash_features(numeric, cat_raw)
    mgr = CheckpointManager(args.model_dir)
    state = mgr.restore(trainer.init())
    mgr.close()
    logits = trainer.predict(state, ids).float().cpu().numpy()
    prob = np.exp(logits[:, 1]) / np.exp(logits).sum(axis=1)
    acc, auc = common.accuracy_auc(prob, y)
    print("accuracy = {:.4f}  AUC = {:.4f}".format(acc, auc))


if __name__ == "__main__":
    main()
