"""Reusable node programs for chaos drills (the port's copy of the JAX
package's ``testing/programs.py``).

One canonical implementation of the supervision layer's node-program
contract — restore-if-present, checkpoint every step, poll the fault plan
after each step — so the contract cannot drift between the drills that
use it. The audit lines are the JAX programs' (``resume <step>``,
``step <step> <loss>``, ``reshape <epoch> world <n> step <step>``), so a
test holds either package to the same assertions.

Both programs train on ``args.get("device", "cuda")``: the card unless the
caller passes ``"cpu"``.
"""


def _linreg_trainer(device):
    import torch

    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train.losses import mse

    if device == "cpu":
        # A two-weight model: one thread each, so that a drill's processes
        # do not oversubscribe the host.
        torch.set_num_threads(1)
    return Trainer(
        factory.get_model("linear_regression", device=device, seed=0),
        optimizer=trainer.sgd(0.5),
        mesh=MeshConfig(data=-1).build(),
        loss_fn=lambda out, b: mse(out, b["y"], b.get("mask")),
        device=device,
    )


def _step(trainer, state, feed):
    """One step on the next feed batch, with the JAX program's telemetry;
    returns ``(state, loss)``, or ``(state, None)`` on an empty batch."""
    import time

    import numpy as np

    from tensorflowonspark_tpu_torch import telemetry

    t_wait = time.perf_counter()
    arrays, mask = feed.next_batch_arrays(16, pad_to_full=True)
    wait = time.perf_counter() - t_wait
    if not int(mask.sum()):
        return state, None
    t_step = time.perf_counter()
    state, m = trainer.train_step(state, {
        "x": np.asarray(arrays["x"], np.float32),
        "y": np.asarray(arrays["y"], np.float32).reshape(-1, 1),
        "mask": mask.astype(np.float32),
    })
    loss = float(m["loss"])
    step = int(state.step)
    dur = time.perf_counter() - t_step
    if wait >= 1e-3:
        telemetry.record_span("train/data_wait", wait, step=step)
    telemetry.record_span("train/step", dur, step=step, wait=round(wait, 6))
    telemetry.step_tick(step, wait=wait)
    telemetry.observe("train_step_seconds", dur)
    telemetry.observe("train_data_wait_seconds", wait)
    return state, loss


def supervised_linreg_fun(args, ctx):
    """Linear-regression trainer under supervision.

    ``args``: ``model_dir`` (checkpoint tree), ``plan_dir`` (armed
    :class:`~tensorflowonspark_tpu_torch.testing.faults.FaultPlan`),
    optional ``log`` — a path that receives ``resume <step>`` and
    ``step <step> <loss>`` audit lines so tests can verify the training
    line (resume-from-committed, no retrained committed steps) — and
    ``device``.
    """
    import os

    from tensorflowonspark_tpu_torch import telemetry
    from tensorflowonspark_tpu_torch.testing.faults import FaultPlan
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    def note(line):
        if args.get("log"):
            with open(args["log"], "a") as f:
                f.write(line + "\n")

    # Per-node span export under the model dir: every launch of this
    # node appends to model_dir/telemetry/node<id>.jsonl (a relaunch is a
    # fresh trace id in the same file).
    telemetry.configure(
        node_id="node{}".format(ctx.executor_id),
        export_dir=os.path.join(args["model_dir"], "telemetry"))
    plan = FaultPlan(args["plan_dir"])
    trainer = _linreg_trainer(args.get("device", "cuda"))
    state = trainer.init()
    ckpt = CheckpointManager(args["model_dir"], save_interval_steps=1,
                             max_to_keep=50)
    state = ckpt.restore(state)
    note("resume {}".format(int(state.step)))
    telemetry.event("train/resume", step=int(state.step))

    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping={"c0": "x", "c1": "y"})
    while not feed.should_stop():
        state, loss = _step(trainer, state, feed)
        if loss is None:
            continue
        step = int(state.step)
        ckpt.save(state, force=True)
        note("step {} {:.6f}".format(step, loss))
        plan.on_step(step, checkpoint_dir=args["model_dir"])


def elastic_linreg_fun(args, ctx):
    """Linear-regression trainer for ELASTIC membership drills.

    The elastic variant of :func:`supervised_linreg_fun`:

    * checkpoints under a per-node subtree ``model_dir/node<id>`` — drill
      nodes are independent single-device trainers, so each incarnation
      resumes ITS OWN committed line and two nodes never contend for one
      checkpoint tree;
    * polls :meth:`~tensorflowonspark_tpu_torch.node.NodeContext
      .poll_resize` every step: a resize directive is the barrier — the
      node rolls back to its last committed step and continues at the
      directive's world size, writing a ``reshape <epoch> world <n>``
      audit line and a ``cluster/reshape`` timeline marker;
    * optional ``step_sleep`` paces steps so a drill can reliably land a
      preemption mid-training.

    The JAX program's ``compile_cache`` argument has no counterpart: the
    persistent compile cache is ROADMAP A12.

    Audit lines go to ``<log_dir>/node<id>.log`` (append: relaunched
    incarnations share the file, so ``resume N`` lines tell the story).
    """
    import os
    import time

    from tensorflowonspark_tpu_torch import telemetry
    from tensorflowonspark_tpu_torch.testing.faults import FaultPlan
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    node_dir = os.path.join(args["model_dir"],
                            "node{}".format(ctx.executor_id))

    def note(line):
        if args.get("log_dir"):
            path = os.path.join(args["log_dir"],
                                "node{}.log".format(ctx.executor_id))
            with open(path, "a") as f:
                f.write(line + "\n")

    telemetry.configure(
        node_id="node{}".format(ctx.executor_id),
        export_dir=os.path.join(args["model_dir"], "telemetry"))
    plan = FaultPlan(args["plan_dir"])
    trainer = _linreg_trainer(args.get("device", "cuda"))
    state = trainer.init()
    ckpt = CheckpointManager(node_dir, save_interval_steps=1,
                             max_to_keep=50)
    state = ckpt.restore(state)
    note("resume {}".format(int(state.step)))
    telemetry.event("train/resume", step=int(state.step))

    step_sleep = float(args.get("step_sleep", 0.0))
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping={"c0": "x", "c1": "y"})
    while not feed.should_stop():
        directive = ctx.poll_resize()
        if directive:
            # The resize barrier: roll back to the last COMMITTED step
            # and continue at the directive's world size. The rollback is
            # what makes the reshape consistent — any step the departed
            # node contributed to but never committed is retrained by the
            # survivors, never half-applied.
            state = ckpt.restore(state)
            note("reshape {} world {} step {}".format(
                directive.get("epoch"), directive.get("world_size"),
                int(state.step)))
            telemetry.event(
                "cluster/reshape", epoch=directive.get("epoch"),
                world_size=directive.get("world_size"),
                reason=directive.get("reason"), step=int(state.step))
        state, loss = _step(trainer, state, feed)
        if loss is None:
            continue
        step = int(state.step)
        ckpt.save(state, force=True)
        note("step {} {:.6f}".format(step, loss))
        plan.on_step(step, checkpoint_dir=node_dir)
        if step_sleep:
            time.sleep(step_sleep)
