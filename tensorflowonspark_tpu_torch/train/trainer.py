"""The trainer (port of ``train/trainer.py``): ``TrainState`` and
``Trainer`` with ``init``, ``train_step``, ``eval_step`` and ``predict``.

The JAX ``Trainer`` builds one jitted SPMD program over a device mesh. The
port trains on one device in PyTorch's own idiom: the model holds its
parameters, an optimizer built by a factory holds their moments, and a step
is forward, ``backward()`` and ``optimizer.step()``, updating both in place.
Gradient accumulation is a Python loop over microbatches where the JAX
package scans; a model's buffers (BatchNorm's running statistics) move in
place with each forward, in microbatch order, as the scan carries
``model_state``. Sharded training (``mesh``/``rules``) is ROADMAP A10, the
persistent compile cache A12, and ``fit`` with device prefetch and
asynchronous metrics A4b; ``donate`` has no meaning without XLA buffers.
"""

import dataclasses
import inspect

import torch
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch.train import losses as losses_lib


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
    ``device="cpu"`` is passed.
    """

    def __init__(self, model, optimizer=None, mesh=None, rules=None,
                 loss_fn=None, input_key="x", label_key="y",
                 model_kwargs=None, grad_accum=1, remat=False,
                 input_fn=None, compile_cache=None, device="cuda"):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "mesh/rules: sharded training is not ported yet (ROADMAP "
                "A10); the port's Trainer trains on one device")
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
        holds the gradient it applied."""
        batch = self._normalize_batch(self._place(batch))
        state.optimizer.zero_grad(set_to_none=True)
        was_training = self.model.training
        self.model.train()
        try:
            if self.grad_accum == 1:
                loss = self._backward(batch)
            else:
                loss = self._accumulate(self._microbatches(batch))
            state.optimizer.step()
        finally:
            self.model.train(was_training)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return (dataclasses.replace(state, step=state.step + 1),
                {"loss": loss, "aux_loss": zero})

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
