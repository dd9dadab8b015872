"""Pipeline parallelism over the mesh ``pipe`` axis (port of
``parallel/pipeline.py``).

The JAX package runs the pipeline as one SPMD program: stage parameters
stacked on a leading axis sharded over ``pipe``, a ``lax.scan`` over the
schedule's steps under ``shard_map``, activations handed on with
``lax.ppermute``, and ``jax.grad`` reversing the scan. The port runs one
process per pipe rank, so the schedule is an explicit loop and its
backward is written out: :func:`pipeline` is one autograd node whose
backward walks the same steps in reverse.

Two schedules, as in JAX:

* ``num_rounds=1`` — GPipe: each rank holds a contiguous block of stages;
  ``m + s - 1`` steps for ``m`` microbatches on ``s`` ranks, bubble
  fraction ``(s-1)/(m+s-1)`` each way.
* ``num_rounds=v>1`` — interleaved: rank ``d`` holds the strided stage
  chunks ``d, s+d, 2s+d, ...`` (the FACTORED layout of
  :func:`factor_stage_params`) and every microbatch rides the ring ``v``
  times; ``v*m + s - 1`` steps, bubble ``(s-1)/(v*m+s-1)``.

Both are one loop: at step ``t`` rank ``d`` makes visit ``i = t - d``,
valid when ``0 <= i < v*m``, of round ``c = i // m`` and microbatch ``j =
i % m`` (GPipe is ``v = 1``). Rank 0 takes a fresh microbatch in round 0
and, later, the value the last rank sent around the ring ``m - s`` steps
before (banked in a slot per microbatch); every other rank takes what its
predecessor sent last step. The last rank's round ``v-1`` outputs are the
pipeline's output.

**Exchanges.** Every step ends with one :func:`~.collectives.shift` of
the step's output one rank along the group's ring (GPipe's last rank sends
to rank 0, which ignores it, where JAX's permutation sends nothing). A
rank skips a stage's compute on a bubble step (it sends zeros) but never an
exchange: every rank issues the same ``T`` exchanges forward and the same
``T`` transposed exchanges backward (cotangents one rank back), in step
order and then in reverse, or a peer would wait forever. The backward is
the node's own, not autograd's walk over per-step nodes, whose order
would follow each rank's own graph.

**Launches.** A rank computes its stages once for each valid visit: ``v *
m`` visits of ``g`` stage groups, so each layer's forward runs ``m`` times
a step for every layer the rank holds (``m x num_layers / s``: B1 counts
``m x local layers`` a step on the flash route, and B2 and B3 the same in
the backward; ``remat`` adds a second B1 for each).

**Boundaries.** The batch enters through :func:`~.collectives.
copy_to_group` (identity forward, sum backward: only rank 0's stages read
it, so the sum hands every rank rank 0's cotangent) and the output leaves
through :func:`~.collectives.reduce_from_group` of the last rank's outputs
and everyone else's zeros (sum forward, identity backward: the cotangent
reaches the last stage once). A plain all-reduce at the exit would
multiply every stage gradient by the pipe degree. So parameters that every
pipe rank holds whole (embedding, final norm, head) end with identical,
true gradients on every rank, and each rank's stage parameters with its
own stages' gradients.
"""

import torch
from torch.utils import _pytree as pytree

from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib


def stack_stage_params(stage_params_list):
    """Stack per-stage parameter trees onto a leading stage axis: leaves
    ``(num_stages, ...)``, logical axis ``"stage"`` (mesh axis ``pipe``)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *stage_params_list)


def factor_stage_params(stacked, num_rounds, pipe_n):
    """Canonically stacked ``(S, ...)`` leaves as the interleaved layout
    ``(num_rounds, pipe_n, S/(v*n), ...)``: a pure reshape. Element ``[c,
    d, k]`` is canonical stage ``(c*n + d)*g + k``, so sharding axis 1 over
    ``pipe`` hands rank ``d`` its strided chunks, and flattening the three
    leading axes gives canonical depth order back
    (:func:`unfactor_stage_params`)."""
    v, n = int(num_rounds), int(pipe_n)

    def factor(a):
        s = a.shape[0]
        if s % (v * n):
            raise ValueError(
                "num_stages={} must be a multiple of num_rounds ({}) x "
                "pipe ({})".format(s, v, n))
        return a.reshape((v, n, s // (v * n)) + tuple(a.shape[1:]))

    return pytree.tree_map(factor, stacked)


def unfactor_stage_params(factored):
    """Inverse of :func:`factor_stage_params`: canonical ``(num_stages,
    ...)`` depth order (pure reshape)."""
    return pytree.tree_map(
        lambda a: a.reshape((-1,) + tuple(a.shape[3:])), factored)


def pipeline(stage_fn, stage_params, batch, num_microbatches,
             axis_name="pipe", num_rounds=1, factored=False):
    """Run ``stage_fn(params, x) -> y`` (``y`` shaped as ``x``) as a
    microbatched pipeline over the ambient mesh's ``axis_name`` group.

    ``batch``: a tensor whose leading dimension divides into
    ``num_microbatches``; every rank of the pipe group passes the same
    batch. ``stage_params``: a tree of tensors,

    * ``factored=False``: canonically stacked ``(num_stages, ...)``
      leaves, the whole stack on every rank (GPipe only); a rank computes
      with its block of stages, and its gradient holds that block (zeros
      elsewhere: the gradient is their sum over the group);
    * ``factored=True``: ``(num_rounds, n, g, ...)`` leaves
      (:func:`factor_stage_params`), either whole, or the rank's shard
      ``(num_rounds, 1, g, ...)`` that sharding axis 1 over ``pipe`` gives
      it (``parallel.sharding``): each rank then holds its schedule chunks
      and no parameter moves in the step.

    With no mesh, or a ``pipe`` axis of size 1, this is a sequential loop
    over the stages in canonical depth order on the whole batch. Returns
    the output batch, the same on every rank of the group."""
    v = int(num_rounds)
    if v < 1:
        raise ValueError("num_rounds must be >= 1")
    mesh = mesh_lib.current_mesh()
    pipe_n = mesh.shape.get(axis_name, 1) if mesh is not None else 1
    if pipe_n <= 1:
        seq = unfactor_stage_params(stage_params) if factored \
            else stage_params
        for k in range(pytree.tree_leaves(seq)[0].shape[0]):
            batch = stage_fn(pytree.tree_map(lambda a: a[k], seq), batch)
        return batch
    group = mesh.group(axis_name)
    idx = coll.rank(group)
    lead = tuple(pytree.tree_leaves(stage_params)[0].shape[:2])
    if factored:
        whole = lead == (v, pipe_n)
        if not whole and lead != (v, 1):
            raise ValueError(
                "factored stage params have leading axes {} but the "
                "schedule needs (num_rounds, {!r} size) = {}".format(
                    lead, axis_name, (v, pipe_n)))
        # This rank's chunks as (v*g, ...) rows: row c*g + k is its
        # round-c chunk's stage k (a view; the gradient lands in place).
        local = pytree.tree_map(
            lambda a: (a.narrow(1, idx, 1) if whole else a).reshape(
                (-1,) + tuple(a.shape[3:])), stage_params)
    else:
        num_stages = lead[0]
        if num_stages % (pipe_n * v):
            raise ValueError(
                "num_stages={} must be a multiple of {!r} axis size {} x "
                "num_rounds {}".format(num_stages, axis_name, pipe_n, v))
        if v > 1:
            raise ValueError(
                "the interleaved schedule needs the factored parameter "
                "layout (factor_stage_params / factored=True): reordering "
                "a contiguously-sharded stage axis inside the step would "
                "all-gather every stage parameter each step")
        per = num_stages // pipe_n
        local = pytree.tree_map(lambda a: a.narrow(0, idx * per, per),
                                stage_params)
    m = int(num_microbatches)
    if v > 1 and m < pipe_n:
        raise ValueError(
            "interleaved schedule needs num_microbatches ({}) >= the "
            "{!r} axis size ({}): a round-(r+1) activation re-enters "
            "stage 0 only {} steps after leaving it".format(
                m, axis_name, pipe_n, pipe_n))
    if batch.shape[0] % m:
        raise ValueError("batch dim {} not divisible by {} "
                         "microbatches".format(batch.shape[0], m))
    leaves, spec = pytree.tree_flatten(local)
    sched = _Schedule(stage_fn, spec, group, idx, pipe_n, v, m)
    x = coll.copy_to_group(batch, group)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in leaves)):
        out = _Pipeline.apply(sched, x, *leaves)
    else:
        out, _ = sched.forward(x, leaves, record=False)
    # Only the last rank's outputs are real; the others hold zeros. The
    # sum runs in f32, as the tensor group's sums do (exact: one term).
    return coll.reduce_from_group(out.float(), group).to(out.dtype)


class _Schedule:
    """The static schedule of one rank: which input each step reads, which
    steps compute, which write an output."""

    def __init__(self, stage_fn, spec, group, idx, s, v, m):
        self.stage_fn, self.spec, self.group = stage_fn, spec, group
        self.idx, self.s, self.v, self.m = idx, s, v, m
        self.steps = v * m + s - 1
        # The exchanges whose received value some step reads.
        self.read = {src[1] for src in map(self.source, range(self.steps))
                     if src is not None and src[0] == "recv"}

    def visit(self, t):
        """``(valid, round, microbatch)`` of this rank's step ``t``."""
        i = t - self.idx
        if not 0 <= i < self.v * self.m:
            return False, None, None
        return True, i // self.m, i % self.m

    def source(self, t):
        """Where step ``t``'s input comes from: ``("batch", j)``,
        ``("recv", t')`` (the value received by the exchange of step
        ``t'``), or None on a bubble step."""
        valid, c, j = self.visit(t)
        if not valid:
            return None
        if self.idx != 0:
            return ("recv", t - 1)
        if c == 0:
            return ("batch", j)
        # Rank 0, round c > 0: the last rank's round-(c-1) output of
        # microbatch j, sent at its visit (c-1)*m + j, step (c-1)*m + j +
        # s - 1, received by that step's exchange.
        return ("recv", (c - 1) * self.m + j + self.s - 1)

    def done(self, t):
        """The microbatch whose final output step ``t`` makes, or None."""
        valid, c, j = self.visit(t)
        if valid and self.idx == self.s - 1 and c == self.v - 1:
            return j
        return None

    def chunk(self, leaves, t):
        """The stage rows of step ``t``'s round, as parameter trees."""
        _, c, _ = self.visit(t)
        g = leaves[0].shape[0] // self.v
        return [pytree.tree_unflatten([a[c * g + k] for a in leaves],
                                      self.spec) for k in range(g)]

    def apply(self, rows, x):
        for p in rows:
            x = self.stage_fn(p, x)
        return x

    def forward(self, x, leaves, record):
        """Run the schedule. With ``record``, each computed step keeps its
        graph: ``(x_in, rows, y)`` on detached leaves, for the backward."""
        xs = x.chunk(self.m)
        outputs = [torch.zeros_like(xs[0]) for _ in range(self.m)]
        recv, tape = {}, {}
        for t in range(self.steps):
            src = self.source(t)
            if src is None:
                y = torch.zeros_like(xs[0])
            else:
                kind, key = src
                x_in = xs[key] if kind == "batch" else recv.pop(key)
                if record:
                    x_in = x_in.detach().requires_grad_()
                    with torch.enable_grad():
                        rows = self.chunk(leaves, t)
                        y = self.apply(rows, x_in)
                    tape[t] = (x_in, rows, y)
                    y = y.detach()
                else:
                    y = self.apply(self.chunk(leaves, t), x_in)
            j = self.done(t)
            if j is not None:
                outputs[j] = y
            (got,) = coll.shift([y], self.group)
            if t in self.read:
                recv[t] = got
        return torch.cat(outputs), tape

    def backward(self, grad_out, leaves, tape, batch_grad):
        g_out = grad_out.chunk(self.m)
        g_x = [None] * self.m
        g_recv = {}
        g_leaves = [torch.zeros_like(a) for a in leaves]
        g = leaves[0].shape[0] // self.v
        for t in reversed(range(self.steps)):
            # The transposed exchange of step t: this rank's received
            # value's cotangent goes back to the predecessor, the cotangent
            # of what it sent comes from the successor.
            send = g_recv.pop(t, None)
            if send is None:
                send = torch.zeros_like(g_out[0])
            (g_y,) = coll.shift([send], self.group, step=-1)
            if t not in tape:
                continue
            j = self.done(t)
            if j is not None:
                g_y = g_y + g_out[j]
            x_in, rows, y = tape.pop(t)
            inputs = [x_in] + [r for p in rows
                               for r in pytree.tree_leaves(p)]
            wants = [i for i, r in enumerate(inputs) if r.requires_grad]
            grads = torch.autograd.grad(y, [inputs[i] for i in wants], g_y,
                                        allow_unused=True)
            got = dict(zip(wants, grads))
            _, c, _ = self.visit(t)
            n = len(leaves)
            for k in range(len(rows)):
                for li in range(n):
                    gr = got.get(1 + k * n + li)
                    if gr is not None:
                        g_leaves[li][c * g + k] += gr
            gx = got.get(0)
            if gx is None:
                continue
            kind, key = self.source(t)
            if kind == "batch":
                g_x[key] = gx if g_x[key] is None else g_x[key] + gx
            else:
                g_recv[key] = gx if key not in g_recv else g_recv[key] + gx
        g_batch = torch.cat([gx if gx is not None else torch.zeros_like(
            g_out[0]) for gx in g_x]) if batch_grad else None
        return g_batch, g_leaves


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sched, x, *leaves):
        ctx.sched = sched
        ctx.batch_grad = x.requires_grad
        ctx.leaf_grad = [p.requires_grad for p in leaves]
        detached = [p.detach().requires_grad_(p.requires_grad)
                    for p in leaves]
        out, ctx.tape = sched.forward(x.detach(), detached, record=True)
        ctx.leaves = detached
        return out

    @staticmethod
    def backward(ctx, grad_out):
        sched = ctx.sched
        g_batch, g_leaves = sched.backward(
            grad_out.contiguous(), ctx.leaves, ctx.tape, ctx.batch_grad)
        ctx.tape = ctx.leaves = None
        return (None, g_batch) + tuple(
            gl if need else None
            for gl, need in zip(g_leaves, ctx.leaf_grad))
