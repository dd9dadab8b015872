"""Node programs and export functions for the port's Spark-ML pipeline
tests (``tests/test_torch_ml_pipeline.py``, ``tests/test_torch_tools.py``).

They live in a module of their own that imports only the port, numpy and
torch: the estimator pickles them to spawned executors, which import this
module to unpickle them, and a test module would bring JAX along.

``args`` is the estimator's merged :class:`~tensorflowonspark_tpu_torch.
pipeline.Namespace` (its params over the ``tf_args``): ``batch_size``,
``steps``, ``model_dir``, ``export_dir``, ``tfrecord_dir`` and ``device``
among them.
"""

import os

import numpy as np

LR = 0.5


def _trainer(device):
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train.losses import mse

    return Trainer(factory.get_model("linear_regression", device=device),
                   optimizer=trainer.sgd(LR),
                   mesh=MeshConfig(data=-1).build(),
                   loss_fn=lambda out, b: mse(out, b["y"], b.get("mask")),
                   device=device)


def _save(args, ctx, state):
    """The collective checkpoint, then (unless an ``export_fn`` exports)
    the export hook, which every rank reaches and rank 0 writes."""
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    if args.model_dir:
        ckpt = CheckpointManager(ctx.absolute_path(args.model_dir))
        ckpt.save(state, force=True)
        ckpt.close()
    if getattr(args, "export_dir", None) and not getattr(
            args, "use_export_fn", False):
        ctx.export_saved_model(args.export_dir, "linear_regression",
                               state=state)


def linreg_feed(args, ctx):
    """FEED mode: two-rank data-parallel linear regression (gloo) over the
    feed's lockstep batches of ``(x, y)`` rows."""
    import torch

    from tensorflowonspark_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    ctx.initialize_distributed(device=args.device)
    tr = _trainer(ctx.device)
    state = tr.init()
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping={"x": "x", "y": "y"})
    example = {"x": np.zeros((1, 2), np.float32),
               "y": np.zeros((1,), np.float32)}
    for arrays, mask in feed.sync_batches(args.batch_size, example=example):
        state, _ = tr.train_step(state, {
            "x": np.asarray(arrays["x"], np.float32),
            "y": np.asarray(arrays["y"], np.float32).reshape(-1, 1),
            "mask": mask.astype(np.float32)})
    _save(args, ctx, state)
    multihost.shutdown()


def linreg_files(args, ctx):
    """FILES mode: each rank reads its share of the TFRecord shards and
    takes ``args.steps`` full-batch data-parallel steps."""
    import torch

    from tensorflowonspark_tpu_torch.data import dfutil
    from tensorflowonspark_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    ctx.initialize_distributed(device=args.device)
    files = dfutil.tfrecord_files(args.tfrecord_dir)
    rows = []
    for path in files[ctx.task_index::ctx.num_workers]:
        rows.extend(dfutil.load_tfrecords(path))
    batch = {"x": np.asarray([r["x"] for r in rows], np.float32),
             "y": np.asarray([r["y"] for r in rows],
                             np.float32).reshape(-1, 1)}
    tr = _trainer(ctx.device)
    state = tr.init()
    for _ in range(args.steps):
        state, _ = tr.train_step(state, batch)
    _save(args, ctx, state)
    multihost.shutdown()


def export_linreg(args):
    """``export_fn``: the latest committed checkpoint to an export
    directory, on one executor."""
    from tensorflowonspark_tpu_torch import export
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(args.model_dir)
    try:
        params, model_state = mgr.restore_variables(split=True)
    finally:
        mgr.close()
    export.export_saved_model(args.export_dir, "linear_regression",
                              params=params, model_state=model_state)
    with open(os.path.join(args.export_dir, "export_fn.pid"), "w") as f:
        f.write(str(os.getpid()))


ALIAS = "linear_regression_alias"


def register_alias():
    """A ``model_registrar``: make ALIAS, a user name for the linear
    regression, resolvable in this process's model registry."""
    from tensorflowonspark_tpu_torch.models import factory

    factory.register(ALIAS, lambda **kw: factory.get_model(
        "linear_regression", **kw))
