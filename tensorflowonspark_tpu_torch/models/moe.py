"""Mixture-of-Experts transformer LM (port of ``models/moe.py``).

Every ``moe_every``-th block's MLP is a bank of ``num_experts`` expert
MLPs behind a router. Routing is the JAX package's: token-choice top-k
(k=2 by default) in f32, first-index ties, per-row capacity ``C =
ceil(k * S * capacity_factor / E)``; tokens past an expert's capacity are
dropped (their dispatch row is zero, so they ride the residual path).
Decode and prefill route uncapped (``C = S``), so a generation step never
drops a token. Dispatch and combine are dense products against one-hot
capacity buffers (``torch.einsum``, as JAX computes them outside any
kernel), and attention is the dense LM's: B1-B3 on the flash route, B4 on
the paged decode step.

The load-balance loss (Switch eq. 4: ``E * sum_e f_e p_e`` times
``aux_loss_weight``, ``f_e`` the share of routing decisions, post-capacity,
landing on expert ``e``, ``p_e`` its mean router probability) is *sown*:
in train mode each MoE layer keeps the value of its last forward, and
:meth:`MoETransformerLM.pop_aux_losses` hands them to the trainer, which
adds their sum to the task loss (eval adds nothing). Under a batch-sharded
mesh ``f`` and ``p`` are the global batch's means: the rank's means summed
over the batch group forward, with an identity backward, since every rank
computes the same aux term.

Expert parallelism: under ``expert > 1`` the expert weights (logical axis
``expert``, dim 0) shard over the mesh ``expert`` axis and the batch does
not, so every expert rank routes the same rows. Each rank runs its own
experts, and the combine's contraction over experts is a sum over the
expert group — Megatron's pair again: the expert path's input and router
probabilities enter through ``copy_to_group`` (their cotangents summed
over the group) and the partial outputs leave through
``reduce_from_group``. Router, attention and embedding gradients come out
identical on every expert rank; expert gradients stay local.
"""

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.initializers import truncated_normal_
from tensorflowonspark_tpu_torch.models import transformer as transformer_lib
from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel.sharding import weight


@dataclasses.dataclass(frozen=True)
class MoEConfig(transformer_lib.TransformerConfig):
    num_experts: int = 8
    num_selected: int = 2          # top-k experts per token
    capacity_factor: float = 1.25
    moe_every: int = 2             # every Nth block is MoE (rest dense MLP)
    aux_loss_weight: float = 0.01


def is_moe_layer(cfg, i):
    """Whether layer ``i`` of a ``cfg`` model is a MoE block: every
    ``moe_every``-th, when there are experts."""
    return cfg.num_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


def _one_hot(idx, n, dtype):
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row
    (``F.one_hot`` raises on it), which is how a token past capacity
    vanishes from the dispatch."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_routing(probs, k, capacity, picks=None):
    """Greedy top-k token-choice routing with per-expert capacity.

    ``probs``: (B, S, E) router probabilities. Returns ``dispatch`` (B, S,
    E, C), the one-hot buffer assignment, and ``combine`` (B, S, E, C),
    the gating weights. A token beyond an expert's capacity is dropped:
    its dispatch row is all zero. ``picks``, if given, is a sequence of
    ``k`` (B, S) index tensors, the experts chosen in each round in place
    of the argmax (teacher-forced routing: two forwards that round apart
    route every token alike, and only their gates differ)."""
    b, s, e = probs.shape
    remaining = probs
    # Tokens already buffered per expert.
    count = probs.new_zeros((b, 1, e))
    dispatch = probs.new_zeros((b, s, e, capacity))
    combine = probs.new_zeros((b, s, e, capacity))
    total_gate = probs.new_zeros((b, s))
    for i in range(k):
        idx = torch.argmax(remaining, dim=-1) if picks is None \
            else picks[i]                                      # first max
        gate = remaining.gather(-1, idx[..., None])[..., 0]
        mask = _one_hot(idx, e, probs.dtype)                   # (B, S, E)
        remaining = remaining * (1.0 - mask)
        # Position of each token in its chosen expert's buffer: tokens of
        # earlier routing iterations plus earlier sequence positions.
        pos = (torch.cumsum(mask, dim=1) - 1.0) * mask + count * mask
        within = (pos < capacity).to(probs.dtype) * mask
        count = count + within.sum(dim=1, keepdim=True)
        slot = _one_hot(pos.sum(dim=-1).to(torch.int32), capacity,
                        probs.dtype)                           # (B, S, C)
        d = within[..., None] * slot[:, :, None, :]            # (B, S, E, C)
        dispatch = dispatch + d
        combine = combine + d * gate[..., None, None]
        total_gate = total_gate + gate * within.sum(dim=-1)
    if k == 1:
        # Switch-style top-1 keeps the raw gate probability as the combine
        # weight: renormalizing would make it exactly 1.0 and cut the
        # router out of the forward gradient path.
        return dispatch, combine
    # Renormalize the kept gates so each routed token's weights sum to 1.
    combine = combine / torch.clamp_min(total_gate, 1e-9)[..., None, None]
    return dispatch, combine


class MoEMLP(nn.Module):
    """Expert MLP bank (drop-in for the dense ``MLPBlock``): ``router.
    kernel`` (embed, E), ``w_up`` (E, embed, mlp), ``w_down`` (E, mlp,
    embed). Under expert parallelism ``w_up``/``w_down`` hold this rank's
    experts ``[expert_start, expert_start + E / expert)``."""

    # The expert group under expert parallelism (None: every expert here).
    ep_group = None
    expert_start = 0

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.router = transformer_lib.Dense(cfg.embed_dim, cfg.num_experts,
                                            torch.float32)
        e, m = cfg.num_experts, cfg.embed_dim
        self.w_up = nn.Parameter(torch.empty(e, m, cfg.mlp_dim))
        self.w_down = nn.Parameter(torch.empty(e, cfg.mlp_dim, m))
        self.aux_loss = None

    def forward(self, x, decode=False):
        cfg = self.cfg
        b, s, _ = x.shape
        e = cfg.num_experts
        if decode:
            # Uncapped: a generation step never drops a token to the
            # residual path, and a batched prefill routes as the stepwise
            # one does.
            capacity = s
        else:
            capacity = max(1, math.ceil(
                cfg.num_selected * s * cfg.capacity_factor / e))
        # The router in f32 for a stable softmax and argmax.
        probs = torch.softmax(self.router(x.float()), dim=-1)   # (B, S, E)
        group = self.ep_group
        routed = coll.copy_to_group(probs, group)
        dispatch, combine = _top_k_routing(routed, cfg.num_selected,
                                           capacity)
        self.aux_loss = None
        if self.training and not decode and torch.is_grad_enabled():
            self.aux_loss = self._load_balance(dispatch, probs)
        dt = cfg.dtype
        w_up = weight(self, "w_up").to(dt)
        w_down = weight(self, "w_down").to(dt)
        local = slice(self.expert_start, self.expert_start + w_up.shape[0])
        xe = coll.copy_to_group(x, group).to(dt)
        expert_in = torch.einsum("bsec,bsm->ebcm",
                                 dispatch[:, :, local].to(dt), xe)
        h = F.gelu(torch.einsum("ebcm,emh->ebch", expert_in, w_up),
                   approximate="tanh")
        expert_out = torch.einsum("ebch,ehm->ebcm", h, w_down)
        y = torch.einsum("bsec,ebcm->bsm", combine[:, :, local].to(dt),
                         expert_out)
        return transformer_lib._tp_sum(y, group)

    def _load_balance(self, dispatch, probs):
        cfg = self.cfg
        # Dividing by k keeps aux == aux_loss_weight at perfect balance.
        f = dispatch.sum(dim=-1).mean(dim=(0, 1)) / cfg.num_selected
        p = probs.mean(dim=(0, 1))                               # (E,)
        group = _batch_group()
        n = coll.size(group)
        if n > 1:
            # The global batch's means: every rank holds as many rows.
            f = coll.sum_(f.clone(), group) / n
            p = coll.reduce_from_group(p, group) / n
        return cfg.aux_loss_weight * cfg.num_experts * torch.sum(f * p)


def _batch_group():
    """The ambient mesh's batch group (the rules' ``batch`` axes)."""
    mesh = mesh_lib.current_mesh()
    if mesh is None:
        return None
    (spec,) = mesh_lib.resolve_spec(mesh.shape, ("batch",),
                                    mesh_lib.active_rules())
    axes = mesh_lib.spec_axes(spec)
    return mesh.group(*axes) if axes else None


class MoEBlock(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.ln1 = transformer_lib.LayerNorm(cfg.embed_dim, cfg.dtype)
        self.attn = transformer_lib.Attention(cfg)
        self.ln2 = transformer_lib.LayerNorm(cfg.embed_dim, cfg.dtype)
        self.moe = MoEMLP(cfg)

    def forward(self, x, segment_ids=None, decode=False, pages=None,
                seq_lens=None, cache=None, verify=False):
        x = x + self.attn(self.ln1(x), segment_ids, decode, pages=pages,
                          seq_lens=seq_lens, cache=cache, verify=verify)
        return x + self.moe(self.ln2(x), decode=decode)


class MoETransformerLM(transformer_lib.TransformerLM):
    """Decoder-only LM with MoE blocks every ``moe_every`` layers (the rest
    dense); the scaffold is :class:`TransformerLM`'s. Initializers are the
    JAX model's: the router N(0, 0.02), the experts he-normal over the
    fan-in ``E * embed`` of ``(E, embed, mlp)`` (flax counts the expert
    axis in), ``E * mlp`` for ``w_down``."""

    def block_for_layer(self, i):
        return MoEBlock if is_moe_layer(self.cfg, i) \
            else transformer_lib.Block

    def moe_layers(self):
        return [b.moe for b in self.blocks() if isinstance(b, MoEBlock)]

    @torch.no_grad()
    def reset_parameters(self, seed):
        super().reset_parameters(seed)
        gen = torch.Generator().manual_seed(int(seed) + 1)
        for moe in self.moe_layers():
            nn.init.normal_(moe.router.kernel, 0.0, 0.02, generator=gen)
            for w in (moe.w_up, moe.w_down):
                e, fan_in = w.shape[0], w.shape[1]
                truncated_normal_(w, 2.0 / (e * fan_in), gen)

    def pop_aux_losses(self):
        """The load-balance terms sown by the last train-mode forward, one
        a MoE layer, each cleared as it is handed over."""
        out = []
        for moe in self.moe_layers():
            if moe.aux_loss is not None:
                out.append(moe.aux_loss)
                moe.aux_loss = None
        return out

    def param_axes(self):
        axes = super().param_axes()
        for i, block in enumerate(self.blocks()):
            if not isinstance(block, MoEBlock):
                continue
            p = "block_{}.".format(i)
            for name in ("mlp.up.kernel", "mlp.down.kernel"):
                axes.pop(p + name)
            axes[p + "moe.router.kernel"] = ("embed", None)
            axes[p + "moe.w_up"] = ("expert", "embed", "mlp")
            axes[p + "moe.w_down"] = ("expert", "mlp", "embed")
        return axes

    def apply_sharding(self, sharding):
        for moe in self.moe_layers():
            moe.__dict__.pop("ep_group", None)
            moe.__dict__.pop("expert_start", None)
        if sharding is not None and sharding.mesh.shape["seq"] > 1:
            # Capacity positions count along the whole row: a sequence
            # chunk would route differently.
            raise NotImplementedError(
                "moe_transformer under seq={}: routing over sequence "
                "chunks is not held against the JAX package yet (ROADMAP "
                "A11c)".format(sharding.mesh.shape["seq"]))
        for i, block in enumerate(self.blocks()):
            if not isinstance(block, MoEBlock) or sharding is None:
                continue
            p = "block_{}.moe.".format(i)
            for name in (p + "router.kernel", p + "w_up", p + "w_down"):
                if sharding.tensor_dims(name) or sharding.fsdp_sharded(name):
                    raise NotImplementedError(
                        "{}: MoE weights shard over expert only (rules "
                        "{})".format(name, sharding.rules))
            spec = sharding.layouts[p + "w_up"].spec[0]
            if "expert" in spec:
                n = sharding.mesh.shape["expert"]
                if self.cfg.num_experts % n:
                    raise ValueError("expert={} does not divide {} "
                                     "experts".format(n, self.cfg.num_experts))
                block.moe.ep_group = sharding.mesh.group("expert")
                block.moe.expert_start = (sharding.mesh.coords["expert"]
                                          * self.cfg.num_experts // n)
        super().apply_sharding(sharding)
