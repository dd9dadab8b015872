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

``mesh=MeshConfig(data=, fsdp=, pipe=, expert=, seq=, tensor=).build()``
trains over the ``torch.distributed`` process group, one device a
process, as the JAX ``Trainer`` trains over the same mesh: the batch
shards over ``data x fsdp``, parameters and optimizer state over
``fsdp``, ``tensor``, ``pipe`` (the pipelined LM's stages) and ``expert``
(the MoE LM's experts) through the logical-axis ``rules``
(:mod:`..parallel.sharding`), and the sequence over ``seq``. BatchNorm
takes global-batch statistics (``models/resnet.py``). See
:meth:`Trainer.train_step` for the reduction. A model that sows auxiliary
losses (the MoE LM's load-balance terms, ``model.pop_aux_losses()``)
trains on the task loss plus their sum, as the JAX trainer adds the
``"losses"`` collection; eval leaves them out. A batch's ``"x"`` may be a
tuple of arrays (wide & deep's ``(categorical, numeric)``), placed, split
into microbatches and handed to the model as a tuple. Dropout draws its
masks from a generator the step seeds from ``(seed, step)`` (``seed`` is
``init``'s, 0 by default; under ``grad_accum=k`` microbatch ``i`` of step
``s`` draws as step ``s * k + i``), as the JAX trainer folds the step into
its dropout key: a relaunch from a checkpoint draws the same masks. Under a
mesh every rank draws from the same seed.
The persistent compile cache is ROADMAP A12; ``donate`` has no meaning
without XLA buffers.
"""

import contextlib
import dataclasses
import inspect
import logging
import time

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch import device_info, telemetry
from tensorflowonspark_tpu_torch.models import layers
from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel import multihost
from tensorflowonspark_tpu_torch.parallel import sharding as sharding_lib
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
    ``model_state["batch_stats"]``; empty for the transformer). Under a
    mesh that shards parameters, ``params`` and the optimizer's moments
    are this rank's shards and ``sharding`` (a
    :class:`~tensorflowonspark_tpu_torch.parallel.sharding.ModelSharding`)
    maps them to the full tensors checkpoints hold.

    Where the JAX state is an immutable pytree, ``train_step`` updates these
    tensors, the buffers and the optimizer's moments in place and returns a
    state whose ``step`` is one further; both states name the same
    tensors."""

    step: int
    params: dict
    optimizer: torch.optim.Optimizer
    model_state: dict = dataclasses.field(default_factory=dict)
    sharding: object = None


class Trainer:
    """``train_step``/``eval_step``/``predict`` for a PyTorch model.

    ``loss_fn(outputs, batch) -> scalar`` consumes the model output and the
    whole batch dict; the model is applied to ``batch[input_key]``.
    ``optimizer`` is a factory ``params -> torch.optim.Optimizer`` (default
    :func:`adam` at 1e-3, the counterpart of ``optax.adam(1e-3)``).
    ``device`` defaults to the card and raises without one unless
    ``device="cpu"`` is passed; under a process group it is this rank's
    device (``ctx.device`` after ``ctx.initialize_distributed()``).

    ``mesh``: a :class:`~tensorflowonspark_tpu_torch.parallel.mesh.
    ProcessMesh` (``MeshConfig(...).build()``; the default
    ``MeshConfig().build()`` is data-parallel, as in the JAX package) or
    its ``MeshConfig``; ``rules``: the logical-axis rules (default
    ``DEFAULT_RULES``). A batch handed to a step holds this rank's rows
    (the global batch's rows of its ``data x fsdp`` coordinate; ranks
    that differ only in ``tensor`` or ``seq`` hold the same rows) at the
    full sequence length; the step cuts the rank's sequence chunk
    (:attr:`batch_placer`). :meth:`init` broadcasts rank 0's weights and
    then keeps each rank's shard. ``eval_step`` returns the global-batch
    loss and this rank's outputs (its rows and chunk, all of the
    vocabulary); ``predict`` this rank's outputs.
    """

    def __init__(self, model, optimizer=None, mesh=None, rules=None,
                 loss_fn=None, input_key="x", label_key="y",
                 model_kwargs=None, grad_accum=1, remat=False,
                 input_fn=None, compile_cache=None, device="cuda"):
        if mesh is None:
            mesh = mesh_lib.MeshConfig().build()
        elif isinstance(mesh, mesh_lib.MeshConfig):
            mesh = mesh.build()
        if not isinstance(mesh, mesh_lib.ProcessMesh):
            raise TypeError("mesh must be a MeshConfig or its built "
                            "ProcessMesh, got {!r}".format(mesh))
        if mesh.size != multihost.process_count():
            raise ValueError(
                "mesh {} spans {} processes; the group has {}".format(
                    mesh.shape, mesh.size, multihost.process_count()))
        self.mesh = mesh
        self.rules = rules or mesh_lib.DEFAULT_RULES
        shape = mesh.shape
        (batch,) = mesh_lib.resolve_spec(shape, ("batch",), self.rules)
        (seq,) = mesh_lib.resolve_spec(shape, ("sequence",), self.rules)
        batch_axes = mesh_lib.spec_axes(batch)
        seq_axes = mesh_lib.spec_axes(seq)
        if not set(batch_axes) <= {"data", "fsdp"} or \
                not set(seq_axes) <= {"seq"}:
            raise NotImplementedError(
                "rules shard the batch over {} and the sequence over {}; "
                "the port's trainer takes data/fsdp and seq".format(
                    batch_axes, seq_axes))
        if shape["fsdp"] > 1 and "fsdp" not in batch_axes:
            raise NotImplementedError(
                "fsdp={} with a batch that does not shard over fsdp "
                "(rules {!r})".format(shape["fsdp"], self.rules["batch"]))
        if shape["seq"] > 1 and not hasattr(model, "param_axes"):
            raise NotImplementedError(
                "seq={}: {} takes no sequence chunks".format(
                    shape["seq"], type(model).__name__))
        # Each rank's loss is its summand of the global loss over these
        # axes; tensor ranks compute the same summand.
        loss_axes = batch_axes + seq_axes
        self._loss_group = mesh.group(*loss_axes)
        # An fsdp-gathered parameter's gradient arrives summed over fsdp
        # (the gather's reduce-scatter); the rest still needs that sum.
        self._sharded_grad_group = mesh.group(
            *(a for a in loss_axes if a != "fsdp"))
        self._sharding = None
        if compile_cache is not None:
            raise NotImplementedError(
                "compile_cache is not ported (ROADMAP A12)")
        if grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        self.device = device_info.resolve_device(device)
        self.model = model
        # The dropout key of the JAX trainer: init(seed=) replaces it.
        self.dropout_seed = 0
        self.optimizer_factory = optimizer or adam(1e-3)
        self.label_key = label_key
        self.loss_fn = loss_fn or self._cross_entropy
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

    def _cross_entropy(self, out, batch):
        """The default loss: softmax cross-entropy, vocab-parallel when the
        model's logits are a tensor group's slabs."""
        slab = getattr(self.model, "vocab_slab", None)
        group, start = slab() if slab is not None else (None, 0)
        if group is None:
            return losses_lib.softmax_cross_entropy(
                out, batch[self.label_key], batch.get("mask"))
        return losses_lib.vocab_parallel_cross_entropy(
            out, batch[self.label_key], group, start, batch.get("mask"))

    @property
    def batch_placer(self):
        """The trainer's batch placement (a ``parallel.mesh.BatchPlacer``:
        the rank's sequence chunk cut, tensors on the trainer's device),
        shared with ``DevicePrefetch`` by :meth:`fit`: a prefetched batch
        passes through ``train_step`` without a second placement."""
        if self._placer is None:
            self._placer = mesh_lib.BatchPlacer(self.mesh, self.rules,
                                                self.device)
        return self._placer

    def _scope(self):
        """The ambient mesh and rules of a step (``jax.set_mesh`` and
        ``use_rules`` in the JAX trainer)."""
        stack = contextlib.ExitStack()
        stack.enter_context(mesh_lib.use_mesh(self.mesh))
        stack.enter_context(mesh_lib.use_rules(self.rules))
        return stack

    # -- init ---------------------------------------------------------------

    def init(self, seed=None, params=None):
        """A fresh :class:`TrainState` at step 0 with a new optimizer. The
        weights are drawn again from ``seed``, or loaded from ``params`` (a
        ``state_dict``, e.g. ``convert.params_from_flax`` of a JAX model's
        parameters), or kept as the model was built when both are None; the
        model then moves to the trainer's device."""
        if seed is not None and params is not None:
            raise ValueError("init takes seed or params, not both")
        if self._sharding is not None:
            # A second init starts from the full parameters again.
            self._sharding.unshard_model(self.model)
            self._sharding = None
        if params is not None:
            self.model.load_state_dict(params)
        elif seed is not None:
            self.model.reset_parameters(seed)
        if seed is not None:
            self.dropout_seed = int(seed)
        self.model.to(self.device)
        if self.mesh.size > 1:
            # Identical replicas: every rank takes rank 0's weights and
            # buffers (the optimizer state is made fresh below, alike),
            # then keeps its own shard of each sharded parameter.
            by_dtype = {}
            for t in self.model.state_dict().values():
                by_dtype.setdefault(t.dtype, []).append(t)
            for tensors in by_dtype.values():
                _broadcast_from_rank0(tensors)
            self._sharding = sharding_lib.ModelSharding(
                self.model, self.mesh, self.rules)
            self._sharding.shard_model(self.model)
        named = dict(self.model.named_parameters())
        return TrainState(step=0, params=named,
                          optimizer=self.optimizer_factory(
                              list(named.values())),
                          model_state=dict(self.model.named_buffers()),
                          sharding=self._sharding)

    # -- steps --------------------------------------------------------------

    def _tensors(self, val):
        """``val`` as tensors on the trainer's device, a tuple leaf by
        leaf."""
        if isinstance(val, (tuple, list)):
            return tuple(self._tensors(v) for v in val)
        if isinstance(val, torch.Tensor):
            return val
        return torch.as_tensor(val, device=self.device)

    def _place(self, batch):
        batch = self.batch_placer(batch)
        return {key: self._tensors(val) for key, val in batch.items()}

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

    def _sown(self):
        """The sum of the auxiliary losses the model sowed in its last
        forward (``model.pop_aux_losses()``), or None."""
        pop = getattr(self.model, "pop_aux_losses", None)
        terms = pop() if pop is not None else []
        if not terms:
            return None
        return torch.stack([t.float() for t in terms]).sum()

    def _seed_dropout(self, draw):
        """Seed dropout for forward number ``draw`` of this run."""
        layers.seed_dropout(self.model,
                            layers.step_seed(self.dropout_seed, draw))

    def _backward(self, batch, weight=None, aux_weight=None):
        """Forward and backward of one (micro)batch: back-propagates the
        task loss times ``weight`` plus the sown auxiliary losses times
        ``aux_weight`` (default ``weight``); returns both, detached (the
        auxiliary 0 without any). Under the whole-forward checkpoint the
        backward runs the forward again, in train mode, and that would move
        the running statistics a second time; the JAX recompute re-applies
        no update. So the buffers as the first forward left them are put
        back after the backward."""
        self._sown()  # drop what a forward outside a step left behind
        loss = self.loss_fn(self._outputs(batch), batch)
        aux = self._sown()
        kept = ({name: buf.clone() for name, buf in
                 self.model.named_buffers()}
                if self._whole_forward_remat else {})
        objective = loss if weight is None else loss * weight
        if aux is not None:
            w = weight if aux_weight is None else aux_weight
            objective = objective + (aux if w is None else aux * w)
        objective.backward()
        if kept:
            with torch.no_grad():
                for name, buf in self.model.named_buffers():
                    buf.copy_(kept[name])
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return loss.detach(), zero if aux is None else aux.detach()

    def _microbatches(self, batch):
        k = self.grad_accum
        leaves = [t for v in batch.values()
                  for t in (v if isinstance(v, tuple) else (v,))]
        bad = [tuple(v.shape) for v in leaves
               if v.dim() >= 1 and v.shape[0] % k]
        if bad:
            raise ValueError(
                "batch dims {} do not divide grad_accum={}".format(bad, k))

        # Scalars ride along whole; every other leaf splits on its leading
        # axis into k consecutive slices (the JAX reshape to (k, b // k)).
        def part(v, i):
            if isinstance(v, tuple):
                return tuple(part(t, i) for t in v)
            return v if v.dim() == 0 else v.chunk(k)[i]

        return [{key: part(v, i) for key, v in batch.items()}
                for i in range(k)]

    def train_step(self, state, batch):
        """One optimizer step on ``batch`` (a dict of arrays or tensors).
        Returns ``(state, {"loss", "aux_loss"})`` with 0-d device tensors:
        ``aux_loss`` is the sum of the auxiliary losses the model sowed
        (the MoE LM's load-balance terms; 0 for a model without any) and
        ``loss`` the task loss plus it, the objective the step descended,
        as the JAX trainer reports them (under ``grad_accum`` both are the
        microbatches' weighted means). Nothing of them is kept in the
        state. After the step each parameter's ``.grad`` holds the gradient
        it applied.

        Over a mesh of more than one process, ``batch`` holds this rank's
        rows (see the class docstring) and the step is the JAX step on the
        global batch: the masked mean over the global batch's tokens
        divides by ``max(global mask sum, 1)``. Each rank back-propagates
        its masked *sum* (its masked mean times its mask sum, each
        microbatch's as a weight under ``grad_accum``) — its own summand
        of the global loss, which ranks of a tensor group share. The
        collectives inside the model (fsdp gathers, whose backward sums
        over fsdp; the tensor pairs; the ring's exchanges) deliver each
        rank the gradient of the summands it touched; then one SUM
        all-reduce over the ``data x fsdp x seq`` group (``data x seq``
        for fsdp-gathered shards; never over ``pipe`` or ``expert``, whose
        ranks hold other stages or experts, or are replicas that computed
        the same gradient) sums the gradients, and the losses and
        mask sums are summed alike; gradients and loss are divided by
        the global mask sum (``max(., 1)``, or ``1e-6`` under
        ``grad_accum`` as the JAX scan clamps). A rank on a lockstep zero
        batch (mask all 0) adds nothing and counts nothing, where
        averaging local means (plain DDP) would count its zero mean and
        halve the step. Without a mask each (micro)batch weighs 1. The
        auxiliary terms are the global batch's (``models/moe.py``), the
        same on every rank, so each rank back-propagates them times the
        global weight: summed over the group and divided by it, each
        rank's share of their gradient counts once."""
        batch = self._normalize_batch(self._place(batch))
        state.optimizer.zero_grad(set_to_none=True)
        was_training = self.model.training
        self.model.train()
        try:
            if self.mesh.size > 1:
                with self._scope():
                    loss, aux = self._sharded_backward(state, batch)
            elif self.grad_accum == 1:
                self._seed_dropout(state.step)
                loss, aux = self._backward(batch)
            else:
                loss, aux = self._accumulate(state,
                                             self._microbatches(batch))
            state.optimizer.step()
        finally:
            self.model.train(was_training)
        return (dataclasses.replace(state, step=state.step + 1),
                {"loss": loss + aux, "aux_loss": aux})

    def _weight(self, batch):
        if "mask" in batch:
            return batch["mask"].sum().float()
        return torch.ones((), dtype=torch.float32, device=self.device)

    def _sharded_backward(self, state, batch):
        micro = ([batch] if self.grad_accum == 1
                 else self._microbatches(batch))
        local_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        local_w = torch.zeros((), dtype=torch.float32, device=self.device)
        aux_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        weights = [self._weight(mb) for mb in micro]
        # Each microbatch's global weight, for the auxiliary terms.
        global_w = (coll.sum_(torch.stack(weights), self._loss_group)
                    if hasattr(self.model, "pop_aux_losses") else None)
        for i, (mb, w) in enumerate(zip(micro, weights)):
            aw = None if global_w is None else global_w[i]
            self._seed_dropout(state.step * len(micro) + i)
            loss, aux = self._backward(mb, w, aux_weight=aw)
            local_loss = local_loss + loss * w
            local_w = local_w + w
            if aw is not None:
                aux_sum = aux_sum + aux * aw
        sums = coll.sum_(torch.stack([local_loss, local_w]),
                         self._loss_group)
        total = torch.clamp_min(sums[1],
                                1.0 if self.grad_accum == 1 else 1e-6)
        sharding = state.sharding
        buckets = {}
        for name, p in state.params.items():
            gathered = sharding is not None and sharding.fsdp_sharded(name)
            group = self._sharded_grad_group if gathered \
                else self._loss_group
            buckets.setdefault(id(group), (group, []))[1].append(p)
        for group, params in buckets.values():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            flat = coll.sum_(torch.cat([g.reshape(-1).float()
                                        for g in grads]), group)
            offset = 0
            for p, g in zip(params, grads):
                n = g.numel()
                p.grad = (flat[offset:offset + n] / total).view_as(p).to(
                    p.dtype)
                offset += n
        return sums[0] / total, aux_sum / total

    def _accumulate(self, state, micro):
        """Backward through each microbatch with weight w_i / sum(w): w_i is
        its mask sum (1 without a mask), so uneven masks reproduce the
        full-batch masked mean. Returns the weighted mean task and
        auxiliary losses."""
        one = torch.ones((), dtype=torch.float32, device=self.device)
        weights = [mb["mask"].sum().float() if "mask" in mb else one
                   for mb in micro]
        total = torch.clamp_min(torch.stack(weights).sum(), 1e-6)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, (mb, w) in enumerate(zip(micro, weights)):
            self._seed_dropout(state.step * len(micro) + i)
            task, sown = self._backward(mb, w / total)
            loss = loss + task * w
            aux = aux + sown * w
        return loss / total, aux / total

    @torch.no_grad()
    def eval_step(self, state, batch):
        """Forward pass and loss without parameter updates: ``{"loss",
        "outputs"}``. The weights are the model's, which ``state.params``
        names. Over a mesh the loss is the global batch's masked mean and
        the outputs this rank's rows and sequence chunk over the whole
        vocabulary."""
        batch = self._normalize_batch(self._place(batch))
        was_training = self.model.training
        self.model.eval()
        try:
            with self._scope():
                out = self._outputs(batch)
                loss = self.loss_fn(out, batch)
                if self.mesh.size > 1:
                    w = self._weight(batch)
                    loss = losses_lib.global_masked_mean(
                        loss * w, w, self._loss_group)
                return {"loss": loss, "outputs": self._whole_vocab(out)}
        finally:
            self.model.train(was_training)

    @torch.no_grad()
    def predict(self, state, inputs):
        """Model outputs for a raw input array (no loss): over a mesh,
        ``inputs`` are this rank's rows at the full sequence length and
        the outputs its rows and chunk over the whole vocabulary."""
        x = self.batch_placer(self._tensors(inputs))
        if self.input_fn is not None:
            x = self.input_fn(x)
        was_training = self.model.training
        self.model.eval()
        try:
            with self._scope():
                return self._whole_vocab(self.model(x, **self.model_kwargs))
        finally:
            self.model.train(was_training)

    def _whole_vocab(self, out):
        """Vocab-parallel logits gathered over the tensor group (slabs
        padded to the first slab's width, the padding dropped)."""
        slab = getattr(self.model, "vocab_slab", None)
        group = slab()[0] if slab is not None else None
        if group is None:
            return out
        vocab = self.model.cfg.vocab_size
        layout = self._sharding.layouts["embed.embedding"]
        width = layout.chunk[0] * (self.mesh.shape["fsdp"]
                                   if "fsdp" in layout.spec[0] else 1)
        if out.shape[-1] < width:
            out = torch.nn.functional.pad(out, (0, width - out.shape[-1]))
        return coll.gather_cat(out.contiguous(), group,
                               out.dim() - 1)[..., :vocab]

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
