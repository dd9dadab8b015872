"""Differentiable collectives over the mesh's process groups.

``torch.distributed`` collectives carry no autograd. Each function here is
a ``torch.autograd.Function`` whose backward is the transposed collective,
as JAX transposes ``ppermute``, ``all_to_all`` and ``all_gather`` inside a
``shard_map``:

* :func:`ppermute` — send to the next rank of the group's ring, receive
  from the previous one; backward sends the cotangents the other way;
* :func:`all_to_all` — split one dimension across the group and
  concatenate another (``lax.all_to_all(..., tiled=True)``); backward is
  the all-to-all with the two dimensions swapped;
* :func:`all_gather` — concatenate the group's shards along a dimension;
  backward is the reduce-scatter (the sum over the group, sliced);
* :func:`all_reduce` — the sum over the group, whose backward is the sum
  again: each rank's result feeds that rank's own summand of the global
  loss (global-batch BatchNorm's statistics);
* :func:`reduce_from_group` and :func:`copy_to_group` — the
  tensor-parallel pair: the sum with an identity backward, and the
  identity with a summed backward (Megatron's ``g`` and ``f``). Ranks of
  a tensor group compute the *same* loss, so a value they all hold is
  differentiated once, not once a rank.

Every function is the identity when ``group`` is None (a family of size
1). Transport: NCCL takes CUDA tensors. Gloo takes CPU tensors for every
collective here, but not CUDA tensors for all of them (send/recv,
all-to-all and reduce-scatter), so a CUDA tensor on a gloo group is staged
through host memory explicitly (:func:`_staged`): copied to the host, sent,
and copied back to its card. That is the transport of ranks that share one
card (NCCL refuses two ranks on one card), not a fallback: nothing is
computed on the host.

Ordering: ranks must issue collectives over one group in one order. Every
caller here issues them in program order, the same on every rank; the
ring's blocks travel together in one :func:`ppermute` a step, so the
backward, too, is one exchange a step whose order the ring's chain of
data dependencies fixes.
"""

import torch
import torch.distributed as dist

# Bytes moved by the collectives of this module since the last reset,
# by kind (what this rank sent) and calls; the shard phase reads them.
traffic = {"calls": 0, "bytes": 0}


def reset_traffic():
    traffic["calls"] = 0
    traffic["bytes"] = 0


def _count(*tensors):
    traffic["calls"] += 1
    traffic["bytes"] += sum(t.numel() * t.element_size() for t in tensors)


def size(group):
    return 1 if group is None else dist.get_world_size(group)


def rank(group):
    return 0 if group is None else dist.get_rank(group)


def _staged(group, t):
    """``(tensor to hand the backend, device to return to or None)``."""
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu(), t.device
    return t, None


def _home(t, dev):
    return t if dev is None else t.to(dev, non_blocking=False)


# -- plain collectives (no autograd) ---------------------------------------------


def sum_(t, group):
    """In-place sum of ``t`` over ``group``; returns ``t``."""
    if size(group) == 1:
        return t
    x, dev = _staged(group, t)
    _count(x)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    if dev is not None or x.data_ptr() != t.data_ptr():
        t.copy_(_home(x, dev))
    return t


def max_(t, group):
    """In-place maximum of ``t`` over ``group``; returns ``t``."""
    if size(group) == 1:
        return t
    x, dev = _staged(group, t)
    _count(x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    if dev is not None or x.data_ptr() != t.data_ptr():
        t.copy_(_home(x, dev))
    return t


def gather_cat(t, group, dim):
    """The group's tensors (equal shapes) concatenated along ``dim`` in
    group-rank order."""
    n = size(group)
    if n == 1:
        return t
    x, dev = _staged(group, t)
    _count(x)
    if dist.get_backend(group) == "nccl":
        moved = x.movedim(dim, 0).contiguous()
        out = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
        dist.all_gather_into_tensor(out, moved, group=group)
        return out.movedim(0, dim)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return _home(torch.cat(parts, dim=dim), dev)


def gather_world(t):
    """Every rank's ``t`` (equal shapes), as a list in rank order, over
    the default group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [t]
    x, dev = _staged(None, t)
    _count(x)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return [_home(p, dev) for p in parts]


def scatter_sum(t, group, dim):
    """The sum of the group's tensors, this rank's ``1/n`` slice of it
    along ``dim`` (the reduce-scatter)."""
    n = size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError("reduce-scatter of dim {} ({}) over {} "
                         "ranks".format(dim, t.shape[dim], n))
    x, dev = _staged(group, t)
    _count(x)
    per = x.shape[dim] // n
    if dist.get_backend(group) == "nccl":
        moved = x.movedim(dim, 0).contiguous()
        out = moved.new_empty((per,) + moved.shape[1:])
        dist.reduce_scatter_tensor(out, moved, group=group)
        return out.movedim(0, dim)
    # Gloo: the sum, then this rank's slice (on a copy: the caller's
    # tensor stays as it was).
    if dev is None:
        x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return _home(x.narrow(dim, rank(group) * per, per).contiguous(), dev)


def exchange(t, group, split_dim, concat_dim):
    """All-to-all: ``t`` split in ``n`` along ``split_dim``, part ``j``
    sent to group rank ``j``; the parts received concatenated along
    ``concat_dim`` in group-rank order."""
    n = size(group)
    if n == 1:
        return t
    if t.shape[split_dim] % n:
        raise ValueError("all-to-all split of dim {} ({}) over {} "
                         "ranks".format(split_dim, t.shape[split_dim], n))
    x, dev = _staged(group, t)
    _count(x)
    parts = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return _home(torch.cat(out.unbind(0), dim=concat_dim), dev)


def shift(tensors, group, step=1):
    """Each tensor sent ``step`` ranks along the group's ring; returns the
    tensors received from ``-step`` ranks back (``lax.ppermute`` with the
    permutation ``j -> j + step``)."""
    n = size(group)
    if n == 1:
        return list(tensors)
    me = rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    staged = [_staged(group, t) for t in tensors]
    outs = [torch.empty_like(x) for x, _ in staged]
    ops = []
    for i, ((x, _), out) in enumerate(zip(staged, outs)):
        _count(x)
        ops.append(dist.P2POp(dist.isend, x, dst, group=group, tag=i))
        ops.append(dist.P2POp(dist.irecv, out, src, group=group, tag=i))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_home(out, dev) for out, (_, dev) in zip(outs, staged)]


# -- autograd collectives --------------------------------------------------------


class _Shift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, step, *tensors):
        ctx.group, ctx.step = group, step
        return tuple(shift(tensors, group, step))

    @staticmethod
    def backward(ctx, *grads):
        # Unused outputs arrive as zeros (materialized cotangents).
        return (None, None) + tuple(shift(grads, ctx.group, -ctx.step))


def ppermute(tensors, group, step=1):
    """Differentiable :func:`shift` of a list of tensors (the K/V blocks
    of one ring step travel together). Each output must reach the loss
    on every rank, or the backward's exchange would wait for a rank that
    never runs it: a ring anchors its last blocks with :func:`anchor`."""
    if size(group) == 1:
        return list(tensors)
    return list(_Shift.apply(group, step, *tensors))


class _Anchor(torch.autograd.Function):
    """Identity on ``x`` that makes ``tensors`` inputs of the graph: their
    cotangent is zero, so every collective that produced them runs its
    backward on every rank, used or not."""

    @staticmethod
    def forward(ctx, x, *tensors):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tensors]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=v)
                            for s, d, v in ctx.shapes)


def anchor(x, *tensors):
    tensors = [t for t in tensors if t is not None and t.requires_grad]
    if not tensors or not torch.is_grad_enabled():
        return x
    return _Anchor.apply(x, *tensors)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return exchange(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x, group, split_dim, concat_dim):
    if size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return scatter_sum(g, group, dim), None, None


def all_gather(x, group, dim):
    if size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return sum_(g.clone(), ctx.group), None


def all_reduce(x, group):
    if size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_group(x, group):
    """The group's sum forward, the identity backward."""
    if size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


class _CopyToGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_(g.clone(), ctx.group), None


def copy_to_group(x, group):
    """The identity forward, the group's sum backward."""
    if size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)
