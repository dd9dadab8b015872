"""The trainer (port of ``train/trainer.py``): ``TrainState`` and
``Trainer`` with ``init``, ``train_step``, ``eval_step`` and ``predict``.

The JAX ``Trainer`` builds one jitted SPMD program over a device mesh. The
port trains on one device in PyTorch's own idiom: the model holds its
parameters, an optimizer built by a factory holds their moments, and a step
is forward, ``backward()`` and ``optimizer.step()``, updating both in place.
Gradient accumulation is a Python loop over microbatches where the JAX
package scans; a model's buffers (BatchNorm's running statistics) move in
place with each forward, in microbatch order, as the scan carries
``model_state``. :meth:`Trainer.fit` is the overlapped loop: device
prefetch, asynchronous metrics and checkpoints.

``mesh=MeshConfig(data=-1).build()`` trains data-parallel over the
``torch.distributed`` process group, one replica a process (see
:meth:`Trainer.train_step`); any other mesh axis, ``rules``, and a model
with BatchNorm under ``data > 1`` (the JAX package takes its statistics
over the global batch) are the later part of ROADMAP A10. The persistent
compile cache is ROADMAP A12; ``donate`` has no meaning without XLA
buffers.
"""

import dataclasses
import inspect
import logging
import time

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch import device_info, telemetry
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel import multihost
from tensorflowonspark_tpu_torch.train import checkpoint as checkpoint_lib
from tensorflowonspark_tpu_torch.train import losses as losses_lib
from tensorflowonspark_tpu_torch.train import metrics as metrics_lib
from tensorflowonspark_tpu_torch.train import prefetch as prefetch_lib

logger = logging.getLogger(__name__)


def sgd(learning_rate, momentum=None, nesterov=False):
    """Optimizer factory for ``torch.optim.SGD`` as ``optax.sgd``: with
    ``momentum`` the trace is ``g + momentum * trace`` from a zero trace,
    which torch's buffer (no dampening) equals from step 1; ``nesterov``
    steps along ``g + momentum * trace``. Without momentum, plain SGD."""
    return lambda params: torch.optim.SGD(
        params, lr=learning_rate, momentum=momentum or 0.0, dampening=0.0,
        nesterov=bool(nesterov and momentum))


def adam(learning_rate=1e-3):
    """Optimizer factory for ``torch.optim.Adam`` with ``optax.adam``'s
    defaults (betas 0.9/0.999, eps 1e-8)."""
    return lambda params: torch.optim.Adam(params, lr=learning_rate,
                                           betas=(0.9, 0.999), eps=1e-8)


def adamw(learning_rate, weight_decay=1e-4):
    """Optimizer factory for ``torch.optim.AdamW`` with ``optax.adamw``'s
    defaults. Their decay defaults differ: optax decays by 1e-4, torch by
    1e-2; this takes optax's, so ``adamw(3e-4)`` here trains as
    ``optax.adamw(3e-4)`` does there."""
    return lambda params: torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """The step count, the model's parameters (the live ``nn.Parameter``
    objects, by ``state_dict`` name), the optimizer over them, and the
    model's buffers by ``state_dict`` name (``model_state``: BatchNorm's
    running statistics, the counterpart of the JAX
    ``model_state["batch_stats"]``; empty for the transformer).

    Where the JAX state is an immutable pytree, ``train_step`` updates these
    tensors, the buffers and the optimizer's moments in place and returns a
    state whose ``step`` is one further; both states name the same
    tensors."""

    step: int
    params: dict
    optimizer: torch.optim.Optimizer
    model_state: dict = dataclasses.field(default_factory=dict)


class Trainer:
    """``train_step``/``eval_step``/``predict`` for a PyTorch model.

    ``loss_fn(outputs, batch) -> scalar`` consumes the model output and the
    whole batch dict; the model is applied to ``batch[input_key]``.
    ``optimizer`` is a factory ``params -> torch.optim.Optimizer`` (default
    :func:`adam` at 1e-3, the counterpart of ``optax.adam(1e-3)``).
    ``device`` defaults to the card and raises without one unless
    ``device="cpu"`` is passed; under a process group it is this rank's
    device (``ctx.device`` after ``ctx.initialize_distributed()``).

    ``mesh``: a :class:`~tensorflowonspark_tpu_torch.parallel.mesh.DataMesh`
    (``MeshConfig(data=-1).build()``, the default as in the JAX package)
    or its ``MeshConfig``. With a data axis above 1 every process holds
    one replica and feeds its own local batch; :meth:`init` broadcasts
    rank 0's weights, and :meth:`train_step` all-reduces the gradients so
    that the step is the JAX step on the global batch. ``eval_step`` and
    ``predict`` run on the rank's own batch.
    """

    def __init__(self, model, optimizer=None, mesh=None, rules=None,
                 loss_fn=None, input_key="x", label_key="y",
                 model_kwargs=None, grad_accum=1, remat=False,
                 input_fn=None, compile_cache=None, device="cuda"):
        if rules is not None:
            raise NotImplementedError(
                "rules: logical-axis sharding is the later part of ROADMAP "
                "A10; the port's mesh has a data axis only")
        if mesh is None:
            mesh = mesh_lib.MeshConfig().build()
        elif isinstance(mesh, mesh_lib.MeshConfig):
            mesh = mesh.build()
        if not isinstance(mesh, mesh_lib.DataMesh):
            raise NotImplementedError(
                "mesh {!r}: only the data-parallel mesh of "
                "MeshConfig(data=...).build() is ported; sharded meshes are "
                "the later part of ROADMAP A10".format(type(mesh).__name__))
        self.mesh = mesh
        # The data-parallel degree: one replica a process.
        self.data_parallel = mesh.data
        if self.data_parallel != multihost.process_count():
            raise ValueError(
                "mesh data axis {} does not match the {} process(es) of "
                "the group".format(self.data_parallel,
                                   multihost.process_count()))
        if self.data_parallel > 1 and any(
                "BatchNorm" in type(m).__name__ for m in model.modules()):
            raise NotImplementedError(
                "BatchNorm under data > 1: the JAX package takes the "
                "statistics over the global batch; the port does not yet "
                "(ROADMAP A10, global-batch BatchNorm)")
        if compile_cache is not None:
            raise NotImplementedError(
                "compile_cache is not ported (ROADMAP A12)")
        if grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        self.device = device_info.resolve_device(device)
        self.model = model
        self.optimizer_factory = optimizer or adam(1e-3)
        self.loss_fn = loss_fn or (
            lambda out, batch: losses_lib.softmax_cross_entropy(
                out, batch[label_key], batch.get("mask")))
        self.input_key = input_key
        # Optional input transform applied before the model (e.g. uint8
        # pixels to scaled floats on the device).
        self.input_fn = input_fn
        self.model_kwargs = dict(model_kwargs or {})
        # Each train_step splits the batch into grad_accum microbatches and
        # makes ONE optimizer update from their weighted gradients.
        self.grad_accum = int(grad_accum)
        # Without a per-block remat knob, remat checkpoints the whole
        # forward (the JAX package's fallback).
        self._whole_forward_remat = bool(remat) and not _enable_model_remat(
            model)
        params = inspect.signature(model.forward).parameters
        self._has_segment_kwarg = "segment_ids" in params
        self._has_positions_kwarg = "positions" in params
        self._placer = None

    @property
    def batch_placer(self):
        """The trainer's batch placement, shared with ``DevicePrefetch`` by
        :meth:`fit`: a prefetched batch's tensors already lie on the
        trainer's device, and ``train_step`` takes them without a copy."""
        if self._placer is None:
            self._placer = prefetch_lib.BatchPlacer(self.device)
        return self._placer

    # -- init ---------------------------------------------------------------

    def init(self, seed=None, params=None):
        """A fresh :class:`TrainState` at step 0 with a new optimizer. The
        weights are drawn again from ``seed``, or loaded from ``params`` (a
        ``state_dict``, e.g. ``convert.params_from_flax`` of a JAX model's
        parameters), or kept as the model was built when both are None; the
        model then moves to the trainer's device."""
        if seed is not None and params is not None:
            raise ValueError("init takes seed or params, not both")
        if params is not None:
            self.model.load_state_dict(params)
        elif seed is not None:
            self.model.reset_parameters(seed)
        self.model.to(self.device)
        if self.data_parallel > 1:
            # Identical replicas: every rank takes rank 0's weights and
            # buffers (the optimizer state is made fresh below, alike).
            by_dtype = {}
            for t in self.model.state_dict().values():
                by_dtype.setdefault(t.dtype, []).append(t)
            for tensors in by_dtype.values():
                _broadcast_from_rank0(tensors)
        named = dict(self.model.named_parameters())
        return TrainState(step=0, params=named,
                          optimizer=self.optimizer_factory(
                              list(named.values())),
                          model_state=dict(self.model.named_buffers()))

    # -- steps --------------------------------------------------------------

    def _place(self, batch):
        return {key: torch.as_tensor(val, device=self.device)
                for key, val in batch.items()}

    def _normalize_batch(self, batch):
        """Default the loss mask from ``segment_ids`` when absent: attention
        zeros padded activations, but the residual stream still emits
        logits there, and without a mask pad-position targets would enter
        the loss. Runs before any microbatch split, so grad-accum weighting
        sees the mask."""
        if (self._has_segment_kwarg and "segment_ids" in batch
                and "mask" not in batch):
            batch = dict(batch)
            batch["mask"] = (batch["segment_ids"] != 0).float()
        return batch

    def _outputs(self, batch):
        kwargs = dict(self.model_kwargs)
        if self._has_segment_kwarg and "segment_ids" in batch:
            kwargs["segment_ids"] = batch["segment_ids"]
        if self._has_positions_kwarg and "positions" in batch:
            # Packed rows carry per-document positions.
            kwargs["positions"] = batch["positions"]
        x = batch[self.input_key]
        if self.input_fn is not None:
            x = self.input_fn(x)
        if (self._whole_forward_remat and self.model.training
                and torch.is_grad_enabled()):
            return checkpoint(lambda inp: self.model(inp, **kwargs), x,
                              use_reentrant=False)
        return self.model(x, **kwargs)

    def _backward(self, batch, weight=None):
        """Forward and backward of one (micro)batch; returns the detached
        loss. Under the whole-forward checkpoint the backward runs the
        forward again, in train mode, and that would move the running
        statistics a second time; the JAX recompute re-applies no update.
        So the buffers as the first forward left them are put back after
        the backward."""
        loss = self.loss_fn(self._outputs(batch), batch)
        kept = ({name: buf.clone() for name, buf in
                 self.model.named_buffers()}
                if self._whole_forward_remat else {})
        (loss if weight is None else loss * weight).backward()
        if kept:
            with torch.no_grad():
                for name, buf in self.model.named_buffers():
                    buf.copy_(kept[name])
        return loss.detach()

    def _microbatches(self, batch):
        k = self.grad_accum
        bad = [tuple(v.shape) for v in batch.values()
               if v.dim() >= 1 and v.shape[0] % k]
        if bad:
            raise ValueError(
                "batch dims {} do not divide grad_accum={}".format(bad, k))
        # Scalars ride along whole; every other leaf splits on its leading
        # axis into k consecutive slices (the JAX reshape to (k, b // k)).
        return [{key: v if v.dim() == 0 else v.chunk(k)[i]
                 for key, v in batch.items()} for i in range(k)]

    def train_step(self, state, batch):
        """One optimizer step on ``batch`` (a dict of arrays or tensors).
        Returns ``(state, {"loss", "aux_loss"})`` with 0-d device tensors;
        ``aux_loss`` is 0, since the ported models add no auxiliary losses
        (MoE is ROADMAP A11). After the step each parameter's ``.grad``
        holds the gradient it applied.

        Data-parallel (a mesh with ``data > 1``), ``batch`` is this rank's
        local batch and the step is the JAX step on the global batch, the
        ranks' batches concatenated: the masked mean over the global batch
        divides by ``max(global mask sum, 1)``. Each rank back-propagates
        its masked *sum* (its masked mean times its mask sum, each
        microbatch's as a weight under ``grad_accum``); one SUM all-reduce
        carries the gradients, the weighted losses and the mask sums; the
        sums of gradients and losses are divided by the global mask sum
        (``max(., 1)``, or ``1e-6`` under ``grad_accum`` as the JAX scan
        clamps). A rank on a lockstep zero batch (mask all 0) adds nothing
        and counts nothing, where averaging local means (plain DDP) would
        count its zero mean and halve the step. Without a mask each
        (micro)batch weighs 1."""
        batch = self._normalize_batch(self._place(batch))
        state.optimizer.zero_grad(set_to_none=True)
        was_training = self.model.training
        self.model.train()
        try:
            if self.data_parallel > 1:
                loss = self._data_parallel_backward(state, batch)
            elif self.grad_accum == 1:
                loss = self._backward(batch)
            else:
                loss = self._accumulate(self._microbatches(batch))
            state.optimizer.step()
        finally:
            self.model.train(was_training)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return (dataclasses.replace(state, step=state.step + 1),
                {"loss": loss, "aux_loss": zero})

    def _weight(self, batch):
        if "mask" in batch:
            return batch["mask"].sum().float()
        return torch.ones((), dtype=torch.float32, device=self.device)

    def _data_parallel_backward(self, state, batch):
        micro = ([batch] if self.grad_accum == 1
                 else self._microbatches(batch))
        local_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        local_w = torch.zeros((), dtype=torch.float32, device=self.device)
        for mb in micro:
            w = self._weight(mb)
            local_loss = local_loss + self._backward(mb, w) * w
            local_w = local_w + w
        params = list(state.params.values())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [local_loss.reshape(1), local_w.reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        total = torch.clamp_min(flat[-1],
                                1.0 if self.grad_accum == 1 else 1e-6)
        offset = 0
        for p, g in zip(params, grads):
            n = g.numel()
            p.grad = (flat[offset:offset + n] / total).view_as(p).to(p.dtype)
            offset += n
        return flat[-2] / total

    def _accumulate(self, micro):
        """Backward through each microbatch with weight w_i / sum(w): w_i is
        its mask sum (1 without a mask), so uneven masks reproduce the
        full-batch masked mean. Returns the weighted mean loss."""
        one = torch.ones((), dtype=torch.float32, device=self.device)
        weights = [mb["mask"].sum().float() if "mask" in mb else one
                   for mb in micro]
        total = torch.clamp_min(torch.stack(weights).sum(), 1e-6)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for mb, w in zip(micro, weights):
            loss = loss + self._backward(mb, w / total) * w
        return loss / total

    @torch.no_grad()
    def eval_step(self, state, batch):
        """Forward pass and loss without parameter updates: ``{"loss",
        "outputs"}``. The weights are the model's, which ``state.params``
        names."""
        batch = self._normalize_batch(self._place(batch))
        was_training = self.model.training
        self.model.eval()
        try:
            out = self._outputs(batch)
            return {"loss": self.loss_fn(out, batch), "outputs": out}
        finally:
            self.model.train(was_training)

    @torch.no_grad()
    def predict(self, state, inputs):
        """Model outputs for a raw input array (no loss)."""
        x = torch.as_tensor(inputs, device=self.device)
        if self.input_fn is not None:
            x = self.input_fn(x)
        was_training = self.model.training
        self.model.eval()
        try:
            return self.model(x, **self.model_kwargs)
        finally:
            self.model.train(was_training)

    # -- training loop ------------------------------------------------------

    def fit(self, state, batches, steps=None, hooks=(), depth=None,
            flush_every=16, metrics=None, checkpoint=None,
            checkpoint_every=0):
        """Overlapped training loop: device prefetch and async metrics.

        ``batches`` is any host batch iterable (a generator, a data
        pipeline) or an existing
        :class:`~tensorflowonspark_tpu_torch.train.prefetch.DevicePrefetch`.
        A plain iterable is wrapped in a DevicePrefetch of ``depth``
        batches sharing :attr:`batch_placer`, so the copy of batch N+1 to
        the card overlaps the step on batch N; ``depth=0`` places on this
        thread. ``depth`` defaults to 2 in one process and to 0 under a
        multi-process group: a source that runs collectives of its own
        (``sync_batches``'s end-of-feed agreement) must not run them from
        a second thread beside the step's. Pass ``depth`` to overlap a
        collective-free source.

        Step metrics stay on the device and reach the host in one transfer
        every ``flush_every`` steps (:class:`~tensorflowonspark_tpu_torch
        .train.metrics.AsyncStepMetrics`). ``hooks`` are called
        ``hook(step, scalars)`` at flush time, for this call only; pass
        ``metrics=`` to share a buffer across calls.

        Stops after ``steps`` optimizer steps (None: run the iterator dry;
        ``steps <= 0`` returns at once). Returns ``(state, history)``,
        ``history`` the ``{"step": int, **scalars}`` dicts flushed through
        the end. On a ``steps``-capped exit the source stays open, so
        chunked training over one source works; batches the wrapper had
        prefetched past the cap are dropped (pass your own DevicePrefetch
        across chunks to keep them).

        ``checkpoint`` (a ``CheckpointManager`` or a directory path) makes
        the loop durable: the state is saved every ``checkpoint_every``
        steps (0: only at exit) and once, forced, when the loop exits,
        an exit by exception included, so a relaunch resumes from the
        last completed step.

        Each step reports to the telemetry plane as the JAX loop does: the
        ``train_step`` gauge and steps/s (``telemetry.step_tick``, which
        a node's heartbeats carry to ``cluster_stats()``), the
        ``train_step_seconds`` and ``train_data_wait_seconds`` histograms,
        and ``train/step`` and ``train/data_wait`` spans when a recorder
        is configured. ``train/step`` times the host's call: the launch
        of the step's kernels, not the card's compute.
        """
        if depth is None:
            depth = 0 if multihost.is_multiprocess() else 2
        own = not isinstance(batches, prefetch_lib.DevicePrefetch)
        buf = (metrics if metrics is not None
               else metrics_lib.AsyncStepMetrics(flush_every=flush_every))
        # Hooks registered for THIS call only: a buffer shared across
        # chunked fit() calls must not collect duplicates.
        added_hooks = []
        for hook in hooks:
            if hook not in buf.hooks:
                buf.hooks.append(hook)
                added_hooks.append(hook)
        if steps is not None and steps <= 0:
            for hook in added_hooks:
                buf.hooks.remove(hook)
            return state, buf.history
        # Made only past the early return, so a path-valued checkpoint
        # never leaks an unclosed manager.
        ckpt, own_ckpt = checkpoint, False
        if ckpt is not None and not hasattr(ckpt, "save"):
            ckpt, own_ckpt = checkpoint_lib.CheckpointManager(ckpt), True
        pf = (prefetch_lib.DevicePrefetch(batches, depth=depth,
                                          placer=self.batch_placer)
              if own else batches)
        step0 = int(state.step)
        n = 0
        capped = False
        # On the way out the save of the last COMPLETED step comes first,
        # and no cleanup step may replace fit's own error as the one
        # raised: ``fit_exc`` (not sys.exc_info(), which is set when fit is
        # called inside an outer except block) says whether fit failed.
        fit_exc = None
        perf = time.perf_counter
        it = iter(pf)
        try:
            while True:
                t_wait = perf()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                wait = perf() - t_wait
                t_step = perf()
                state, m = self.train_step(state, batch)
                dur = perf() - t_step
                step_no = step0 + n
                buf.push(step_no, m)
                n += 1
                telemetry.step_tick(step_no + 1, wait=wait)
                telemetry.observe("train_step_seconds", dur)
                telemetry.observe("train_data_wait_seconds", wait)
                # A data-wait slice only when it shows on a timeline.
                if wait >= 1e-3:
                    telemetry.record_span("train/data_wait", wait,
                                          step=step_no)
                telemetry.record_span("train/step", dur, step=step_no,
                                      wait=round(wait, 6))
                if ckpt is not None and checkpoint_every and \
                        n % checkpoint_every == 0:
                    ckpt.save(state)
                if steps is not None and n >= steps:
                    capped = True
                    break
        except BaseException as e:
            fit_exc = e
            raise
        finally:
            cleanup_errors = []

            def cleanup(what, fn):
                # Every step runs; the first error is raised at the end
                # only when fit itself succeeded.
                try:
                    fn()
                except Exception as e:
                    logger.exception("%s failed on fit() exit", what)
                    cleanup_errors.append(e)

            if ckpt is not None:
                if n:
                    # force covers a step the save interval declines.
                    cleanup("exit-path checkpoint save", lambda: (
                        ckpt.save(state, force=True), ckpt.wait()))
                if own_ckpt:
                    cleanup("checkpoint close", ckpt.close)
            # A buffer fit() made is closed; a caller's shared buffer is
            # only flushed (it may span chunked fit calls).
            cleanup("metrics flush",
                    buf.flush if metrics is not None else buf.close)
            for hook in added_hooks:
                buf.hooks.remove(hook)
            if own:
                cleanup("prefetch close",
                        lambda: pf.close(close_source=not capped))
            if cleanup_errors and fit_exc is None:
                raise cleanup_errors[0]
        return state, buf.history


def _broadcast_from_rank0(tensors):
    """Rank 0's values of ``tensors`` (one dtype) on every rank, in place:
    one broadcast of one flat buffer."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, src=0)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def _enable_model_remat(model):
    """Turn on the model's own per-block remat (``cfg.remat``) if it has the
    knob: every module that shares the model's config gets a copy with
    ``remat=True``. Returns False for a model without it (the trainer then
    checkpoints the whole forward)."""
    cfg = getattr(model, "cfg", None)
    if cfg is None or not hasattr(cfg, "remat"):
        return False
    if not cfg.remat:
        new = dataclasses.replace(cfg, remat=True)
        for module in model.modules():
            if getattr(module, "cfg", None) is cfg:
                module.cfg = new
    return True
