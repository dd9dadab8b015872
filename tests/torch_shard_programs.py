"""Rank groups for the sharded-mesh tests of the port, and their shared
inputs (jax-free: spawned ranks import this module).

:func:`run_group` spawns ``world`` processes that join one gloo group on
the CPU over a loopback TCP store, hold torch to one thread each, run one
program (``ring_attention_cases``, ``trainer_cases``, ``bn_cases``) and
save each rank's results with ``torch.save``. A program runs every case of
its test module in one group; a case that raises records its traceback
instead of its results, so one failing case fails its own test only. The
tests compute the JAX side in the test process from the same numpy-seeded
inputs (:func:`attention_inputs`, :func:`lm_batches`, :func:`bn_batch`).

:func:`cached_group` runs a group once per pytest session, whichever
xdist worker asks first: the results go to a directory under the
session's shared temporary root, behind a file lock, and no two groups
run at once.
"""

import datetime
import os
import socket
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


# -- the group ----------------------------------------------------------------


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, program, args, outdir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, HERE)
    try:
        dist.init_process_group(
            "gloo", init_method="tcp://127.0.0.1:{}".format(port),
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=120))
        results = globals()[program](rank, world, args)
        results["_forbidden"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax",
                                   "tensorflowonspark_tpu"))
        torch.save(results, os.path.join(outdir, "rank{}.pt".format(rank)))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, "rank{}.err".format(rank)), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_group(world, program, args, outdir, timeout=240.0):
    """Run ``program`` on ``world`` gloo ranks; returns the list of the
    ranks' results. Raises with a rank's traceback if one failed."""
    import multiprocessing as mp

    import torch

    os.makedirs(outdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, program, args, outdir),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    errors = []
    for r in range(world):
        path = os.path.join(outdir, "rank{}.err".format(r))
        if os.path.exists(path):
            errors.append("rank {}:\n{}".format(r, open(path).read()))
    if alive or errors:
        raise RuntimeError("{} group failed ({} rank(s) timed out)\n{}".format(
            program, len(alive), "\n".join(errors)))
    return [torch.load(os.path.join(outdir, "rank{}.pt".format(r)),
                       weights_only=False) for r in range(world)]


def cached_group(tmp_path_factory, key, world, program, args=None,
                 prepare=None, timeout=240.0):
    """:func:`run_group` once per session under ``key``; every caller
    gets the same results. ``prepare(outdir)`` runs first (in the caller)
    and returns extra arguments for the program."""
    import filelock
    import torch

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    outdir = os.path.join(str(root), "shard-" + key)
    os.makedirs(outdir, exist_ok=True)
    with filelock.FileLock(outdir + ".lock"):
        done = os.path.join(outdir, "results.pt")
        if not os.path.exists(done):
            # One group at a time in the session: groups run side by side
            # keep every core busy, and then the JAX package's tests on
            # the 8-device CPU mesh can miss XLA's 40 s collective
            # rendezvous, which aborts their worker.
            with filelock.FileLock(os.path.join(str(root),
                                                "shard-groups.lock")):
                try:
                    args = dict(args or {}, outdir=outdir)
                    if prepare is not None:
                        args.update(prepare(outdir))
                    saved = {"args": args, "ranks": run_group(
                        world, program, args, os.path.join(outdir, "ranks"),
                        timeout)}
                except Exception:
                    # Later callers fail with this error and do not run
                    # the group again, each up to its timeout.
                    saved = {"error": traceback.format_exc()}
            torch.save(saved, done)
        saved = torch.load(done, weights_only=False)
    if "error" in saved:
        raise RuntimeError("the {} group failed in this session:\n{}".format(
            key, saved["error"]))
    return saved


def case_result(ranks, case):
    """Each rank's result of ``case``; raises with a rank's traceback when
    the case failed there."""
    out = []
    for r, results in enumerate(ranks):
        res = results[case]
        if isinstance(res, str):
            raise AssertionError("case {} failed on rank {}:\n{}".format(
                case, r, res))
        out.append(res)
    return out


def _cases(names, fn):
    results = {}
    for name in names:
        try:
            results[name] = fn(name)
        except Exception:
            results[name] = traceback.format_exc()
    return results


def _numpy(t):
    return t.detach().cpu().numpy().copy()


# -- attention ------------------------------------------------------------------

ATTN_B, ATTN_S, ATTN_D = 2, 32, 8
# Four-rank seq meshes; GQA on every route that takes it.
ATTN_CASES = {
    "ring_seg_gqa": dict(impl="ring", h=4, h_kv=2),
    "ulysses_seg_gqa": dict(impl="ulysses", h=8, h_kv=4),
    "ring_flash_seg_gqa": dict(impl="ring_flash", h=4, h_kv=2),
    "ring_flash_zigzag_seg": dict(impl="ring_flash", h=4, h_kv=4,
                                  layout="zigzag"),
}
ATTN_WORLD = 4


def attn_segments(b=ATTN_B, s=ATTN_S):
    """Row 0: one document then padding; row 1: two packed documents, the
    second crossing a chunk boundary, then padding."""
    seg = np.zeros((b, s), np.int32)
    seg[0, :5 * s // 8] = 1
    for bi in range(1, b):
        seg[bi, :3 * s // 8] = 1
        seg[bi, 3 * s // 8:7 * s // 8] = 2
    return seg


def attention_inputs(case, zigzag_fn=None):
    """``(q, k, v, seg, cotangent)`` of a case, float32 numpy, in the
    sequence layout the ranks cut (zigzag-permuted by ``zigzag_fn`` for a
    zigzag case)."""
    c = ATTN_CASES[case]
    rs = np.random.RandomState(sorted(ATTN_CASES).index(case) + 40)
    b, s, d = ATTN_B, ATTN_S, ATTN_D
    q = rs.randn(b, s, c["h"], d).astype(np.float32)
    k = rs.randn(b, s, c["h_kv"], d).astype(np.float32)
    v = rs.randn(b, s, c["h_kv"], d).astype(np.float32)
    g = rs.randn(b, s, c["h"], d).astype(np.float32)
    seg = attn_segments()
    if c.get("layout") == "zigzag":
        q, k, v, g, seg = (zigzag_fn(x, ATTN_WORLD) for x in (q, k, v, g,
                                                              seg))
    return q, k, v, seg, g


def ring_attention_cases(rank, world, args):
    import torch

    from tensorflowonspark_tpu_torch.ops import attention
    from tensorflowonspark_tpu_torch.parallel import MeshConfig

    mesh = MeshConfig(data=1, seq=world).build()
    group = mesh.group("seq")

    def run(case):
        c = ATTN_CASES[case]
        q, k, v, seg, g = attention_inputs(case, attention.zigzag_layout)
        per = ATTN_S // world
        cut = slice(rank * per, (rank + 1) * per)
        q, k, v, g = (torch.tensor(x[:, cut], requires_grad=i < 3)
                      for i, x in enumerate((q, k, v, g)))
        out = attention.causal_attention(
            q, k, v, impl=c["impl"], segment_ids=torch.tensor(seg[:, cut]),
            ring_layout=c.get("layout", "contiguous"), group=group)
        (out * g).sum().backward()
        return {"out": _numpy(out), "dq": _numpy(q.grad),
                "dk": _numpy(k.grad), "dv": _numpy(v.grad)}

    results = _cases(ATTN_CASES, run)

    def ulysses_error(_):
        q = torch.zeros(1, 4, 6, 8)
        k = torch.zeros(1, 4, 2, 8)
        try:
            attention.ulysses_causal_attention(q, k, k, group)
        except ValueError as e:
            return {"message": str(e)}
        return {"message": None}

    results.update(_cases(["ulysses_error"], ulysses_error))
    return results


# -- the sharded trainer ----------------------------------------------------------

LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False)
TRAIN_B, TRAIN_S = 4, 32
TRAIN_LR = 1e-3
TRAIN_STEPS = 3
TRAIN_WORLD = 4
# Mesh and the model's attention route of each trainer case.
TRAIN_CASES = {
    "data2_fsdp2": (dict(data=2, fsdp=2), dict(attention_impl="dense")),
    "data2_tensor2": (dict(data=2, tensor=2), dict(attention_impl="dense")),
    "fsdp2_tensor2": (dict(data=1, fsdp=2, tensor=2),
                      dict(attention_impl="pallas")),
    "seq4_ring_flash_zigzag": (dict(data=1, seq=4),
                               dict(attention_impl="ring_flash",
                                    ring_layout="zigzag")),
    "seq2_tensor2_ulysses": (dict(data=1, seq=2, tensor=2),
                             dict(attention_impl="ulysses")),
    "data2_tensor2_accum_remat": (dict(data=2, tensor=2),
                                  dict(attention_impl="dense")),
    "data2_tensor2_gqa": (dict(data=2, tensor=2),
                          dict(attention_impl="dense", num_kv_heads=2)),
}


def init_key(case):
    """The initial weights of a case: the MHA init, or the GQA one."""
    return "params_gqa" if "num_kv_heads" in TRAIN_CASES[case][1] \
        else "params"


# Trainer options of a case (both sides), and the case whose trained
# state also runs eval_step and predict.
TRAIN_OPTIONS = {"data2_tensor2_accum_remat": dict(grad_accum=2, remat=True)}
EVAL_CASE = "data2_tensor2_accum_remat"


def packed_positions(seg):
    """Per-document positions of packed rows (numpy ``_packed_positions``)."""
    pos = np.zeros_like(seg)
    for r in range(seg.shape[0]):
        start = 0
        for i in range(seg.shape[1]):
            if i and seg[r, i] != seg[r, i - 1]:
                start = i
            pos[r, i] = i - start
    return pos


def lm_batches(case, zigzag_fn=None, steps=TRAIN_STEPS):
    """The global batches of a trainer case: packed rows with a padded
    tail; the zigzag case carries its (permuted) positions."""
    out = []
    zigzag = TRAIN_CASES[case][1].get("ring_layout") == "zigzag"
    for step in range(steps):
        rs = np.random.RandomState(100 + step)
        toks = rs.randint(1, LM_KW["vocab_size"], size=(TRAIN_B, TRAIN_S + 1))
        seg = np.ones((TRAIN_B, TRAIN_S), np.int32)
        seg[:, 11:] = 2
        seg[:, -3:] = 0
        seg[1, 20:] = 0
        batch = {"x": toks[:, :-1].astype(np.int32),
                 "y": toks[:, 1:].astype(np.int32), "segment_ids": seg}
        if zigzag:
            n = TRAIN_CASES[case][0]["seq"]
            batch["positions"] = packed_positions(seg).astype(np.int32)
            batch = {k: zigzag_fn(v, n) for k, v in batch.items()}
        out.append(batch)
    return out


def _lm(impl_kw, params):
    import torch

    from tensorflowonspark_tpu_torch.models import factory

    model = factory.get_model("transformer", device="cpu",
                              dtype=torch.float32, **LM_KW, **impl_kw)
    model.load_state_dict(params)
    return model


def trainer_cases(rank, world, args):
    import torch

    from tensorflowonspark_tpu_torch.ops import attention
    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.train import checkpoint, trainer

    inits = {key: torch.load(args[key], weights_only=True)
             for key in ("params", "params_gqa")}

    def run(case):
        mesh_kw, impl_kw = TRAIN_CASES[case]
        mesh = MeshConfig(**mesh_kw).build()
        tr = trainer.Trainer(_lm(impl_kw, inits[init_key(case)]),
                             optimizer=trainer.adamw(TRAIN_LR), mesh=mesh,
                             device="cpu", **TRAIN_OPTIONS.get(case, {}))
        state = tr.init()
        rows = tr.batch_placer.rows(TRAIN_B)
        losses = []
        for batch in lm_batches(case, attention.zigzag_layout):
            state, m = tr.train_step(
                state, {k: v[rows] for k, v in batch.items()})
            losses.append(float(m["loss"]))
        full = {k: _numpy(v) for k, v in
                state.sharding.full_state_dict(dict(state.params)).items()}
        out = {"losses": losses, "params": full,
               "local_bytes": sum(p.numel() * 4
                                  for p in state.params.values())}
        if case == EVAL_CASE:
            batch = lm_batches(case, steps=1)[0]
            ev = tr.eval_step(state, {k: v[rows] for k, v in batch.items()})
            out["eval_loss"] = float(ev["loss"])
            out["eval_outputs"] = _numpy(ev["outputs"])
            out["predict"] = _numpy(tr.predict(state, batch["x"][rows]))
        if case == "fsdp2_tensor2":
            mgr = checkpoint.CheckpointManager(
                os.path.join(args["outdir"], "ckpt_sharded"))
            mgr.save(state, force=True)
            mgr.close()
            # Every rank exports (the shards are gathered); rank 0 writes.
            from tensorflowonspark_tpu_torch import export

            export.export_saved_model(
                os.path.join(args["outdir"], "export_sharded"),
                "transformer", state=state,
                model_kwargs=dict(LM_KW, dtype="float32", **impl_kw))
            # A step saved by one process under data=1, restored here.
            fresh = tr.init()
            mgr = checkpoint.CheckpointManager(args["ckpt_data1"])
            fresh = mgr.restore(fresh)
            mgr.close()
            out["restored_step"] = fresh.step
            out["restored"] = {
                k: _numpy(v) for k, v in
                fresh.sharding.full_state_dict(dict(fresh.params)).items()}
            opt = checkpoint._optimizer_tree(
                fresh, fresh.optimizer.state_dict(), fresh.sharding.full)
            out["restored_moments"] = {
                i: {k: _numpy(v) for k, v in per.items()
                    if isinstance(v, torch.Tensor) and v.dim()}
                for i, per in opt["state"].items()}
        return out

    return _cases(TRAIN_CASES, run)


# -- global-batch BatchNorm -------------------------------------------------------

BN_KW = dict(num_classes=10, width=8)
BN_B, BN_HW = 4, 64
BN_WORLD = 2
BN_LR = 0.1


def bn_batch():
    x = np.random.RandomState(7).rand(BN_B, BN_HW, BN_HW, 3).astype(
        np.float32)
    y = (np.arange(BN_B, dtype=np.int32) * 3 + 1) % BN_KW["num_classes"]
    return {"x": x, "y": y}


def bn_model(params):
    import torch

    from tensorflowonspark_tpu_torch.models import factory

    model = factory.get_model("resnet18", device="cpu", dtype=torch.float32,
                              **BN_KW)
    model.load_state_dict(params)
    return model


def bn_cases(rank, world, args):
    import torch

    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.train import trainer

    variables = torch.load(args["variables"], weights_only=True)

    def run(_):
        tr = trainer.Trainer(bn_model(variables),
                             optimizer=trainer.sgd(BN_LR),
                             mesh=MeshConfig(data=world).build(),
                             device="cpu")
        state = tr.init()
        batch = bn_batch()
        rows = tr.batch_placer.rows(BN_B)
        state, m = tr.train_step(state, {k: v[rows]
                                         for k, v in batch.items()})
        return {"loss": float(m["loss"]),
                "grads": {k: _numpy(p.grad)
                          for k, p in state.params.items()},
                "params": {k: _numpy(p) for k, p in state.params.items()},
                "stats": {k: _numpy(b)
                          for k, b in state.model_state.items()}}

    return _cases(["data2"], run)


# -- pipeline parallelism ---------------------------------------------------------

PP_S, PP_D, PP_B = 4, 8, 16
# pipeline() cases: (pipe size, stages, rounds, microbatches, layout). A
# four-rank group runs every case; a pipe of 2 leaves data 2 beside it.
PIPELINE_CASES = {
    "gpipe_pipe4": (4, 4, 1, 4, "stacked"),
    "grouped_pipe2": (2, 4, 1, 4, "stacked"),
    "interleaved_pipe2_mb2": (2, 4, 2, 2, "factored"),
    "interleaved_pipe2_mb4": (2, 4, 2, 4, "factored"),
    "interleaved_pipe2_shard": (2, 8, 2, 4, "shard"),
}
PIPELINE_WORLD = 4
# The JAX ValueErrors a pipe group raises, each a call that trips one.
PIPELINE_ERRORS = ("not_multiple", "interleaved_stacked",
                   "too_few_microbatches", "indivisible", "factored_lead")

PP_LM_KW = dict(vocab_size=64, num_layers=4, num_heads=2, embed_dim=32,
                mlp_dim=64, max_seq_len=16, remat=False)
PP_TRAIN_B, PP_TRAIN_S = 8, 16
# Trainer cases: (mesh, model) over four ranks, and over two.
PP_TRAIN_CASES = {
    "data2_pipe2_gpipe": (dict(data=2, pipe=2),
                          dict(num_stages=2, num_microbatches=4)),
}
PP_INTERLEAVED_CASES = {
    "pipe2_interleaved": (dict(data=1, pipe=2),
                          dict(num_stages=4, num_rounds=2,
                               num_microbatches=4)),
}
PP_INTERLEAVED_WORLD = 2


def pipeline_inputs(stages):
    """``(per-stage params [{"w", "b"}], x, cotangent seed)``, numpy f32."""
    rs = np.random.RandomState(stages)
    params = [{"w": (rs.randn(PP_D, PP_D) * 0.3).astype(np.float32),
               "b": (rs.randn(PP_D) * 0.1).astype(np.float32)}
              for _ in range(stages)]
    x = rs.randn(PP_B, PP_D).astype(np.float32)
    return params, x


def pp_stage_fn(p, x):
    import torch

    return torch.tanh(x @ p["w"] + p["b"])


def pp_lm_batches(steps=TRAIN_STEPS):
    out = []
    for step in range(steps):
        rs = np.random.RandomState(200 + step)
        toks = rs.randint(0, PP_LM_KW["vocab_size"],
                          size=(PP_TRAIN_B, PP_TRAIN_S + 1))
        out.append({"x": toks[:, :-1].astype(np.int32),
                    "y": toks[:, 1:].astype(np.int32)})
    return out


def _pp_lm(model_kw, params):
    import torch

    from tensorflowonspark_tpu_torch.models import factory

    model = factory.get_model("pipelined_transformer", device="cpu",
                              dtype=torch.float32, **PP_LM_KW, **model_kw)
    model.load_state_dict(params)
    return model


def _train_case(build, mesh_kw, batches, params, outdir=None):
    """Three AdamW steps of ``build(params)`` under ``mesh_kw``: each
    rank's losses, aux losses, full final parameters and the bytes of the
    parameters it holds by name; the state is saved under ``outdir``."""
    import torch

    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.train import checkpoint, trainer

    mesh = MeshConfig(**mesh_kw).build()
    tr = trainer.Trainer(build(params), optimizer=trainer.adamw(TRAIN_LR),
                         mesh=mesh, device="cpu")
    state = tr.init()
    rows = tr.batch_placer.rows(batches[0]["x"].shape[0])
    losses, aux = [], []
    for batch in batches:
        state, m = tr.train_step(state, {k: v[rows]
                                         for k, v in batch.items()})
        losses.append(float(m["loss"]))
        aux.append(float(m["aux_loss"]))
    full = {k: _numpy(v) for k, v in
            state.sharding.full_state_dict(dict(state.params)).items()}
    out = {"losses": losses, "aux": aux, "params": full,
           "held": {k: p.numel() * p.element_size()
                    for k, p in state.params.items()}}
    if outdir is not None:
        mgr = checkpoint.CheckpointManager(outdir)
        mgr.save(state, force=True)
        mgr.close()
    return out


def pipeline_cases(rank, world, args):
    import torch

    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
    from tensorflowonspark_tpu_torch.parallel import pipeline as pp

    def run(case):
        pipe, stages, rounds, mb, layout = PIPELINE_CASES[case]
        mesh = MeshConfig(data=world // pipe, pipe=pipe).build()
        params, x = pipeline_inputs(stages)
        stacked = pp.stack_stage_params(
            [{k: torch.tensor(v) for k, v in p.items()} for p in params])
        if layout != "stacked":
            stacked = pp.factor_stage_params(stacked, rounds, pipe)
        if layout == "shard":
            d = mesh.coords["pipe"]
            stacked = {k: v[:, d:d + 1].clone() for k, v in stacked.items()}
        leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        xt = torch.tensor(x, requires_grad=True)
        with mesh_lib.use_mesh(mesh):
            out = pp.pipeline(pp_stage_fn, leaves, xt, mb, num_rounds=rounds,
                              factored=layout != "stacked")
        (out ** 2).sum().backward()
        return {"out": _numpy(out), "dx": _numpy(xt.grad),
                "grads": {k: _numpy(v.grad) for k, v in leaves.items()},
                "pipe_index": mesh.coords["pipe"]}

    results = _cases(PIPELINE_CASES, run)

    def error(name):
        mesh = MeshConfig(data=world // 2, pipe=2).build()
        params, x = pipeline_inputs(4)
        stacked = pp.stack_stage_params(
            [{k: torch.tensor(v) for k, v in p.items()} for p in params])
        xt = torch.tensor(x)
        call = {
            "not_multiple": lambda: pp.pipeline(
                pp_stage_fn, {k: v[:3] for k, v in stacked.items()}, xt, 4),
            "interleaved_stacked": lambda: pp.pipeline(
                pp_stage_fn, stacked, xt, 4, num_rounds=2),
            "too_few_microbatches": lambda: pp.pipeline(
                pp_stage_fn, pp.factor_stage_params(stacked, 2, 2), xt, 1,
                num_rounds=2, factored=True),
            "indivisible": lambda: pp.pipeline(pp_stage_fn, stacked, xt, 3),
            "factored_lead": lambda: pp.pipeline(
                pp_stage_fn, pp.factor_stage_params(stacked, 1, 4), xt, 4,
                num_rounds=1, factored=True),
        }[name]
        with mesh_lib.use_mesh(mesh):
            try:
                call()
            except ValueError as e:
                return {"message": str(e)}
        return {"message": None}

    results.update(_cases(PIPELINE_ERRORS, error))
    params = torch.load(args["params"], weights_only=True)

    def train(case):
        mesh_kw, model_kw = PP_TRAIN_CASES[case]
        return _train_case(lambda p: _pp_lm(model_kw, p), mesh_kw,
                           pp_lm_batches(), params)

    results.update(_cases(PP_TRAIN_CASES, train))
    return results


def interleaved_cases(rank, world, args):
    import torch

    params = torch.load(args["params"], weights_only=True)

    def train(case):
        mesh_kw, model_kw = PP_INTERLEAVED_CASES[case]
        return _train_case(lambda p: _pp_lm(model_kw, p), mesh_kw,
                           pp_lm_batches(), params,
                           os.path.join(args["outdir"], "ckpt_" + case))

    return _cases(PP_INTERLEAVED_CASES, train)


# -- expert parallelism -----------------------------------------------------------

MOE_LM_KW = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32,
                 mlp_dim=64, max_seq_len=64, num_experts=4, moe_every=2,
                 remat=False)
MOE_TRAIN_B, MOE_TRAIN_S = 8, 16
MOE_WORLD = 4
MOE_CASES = {"data2_expert2": dict(data=2, expert=2)}


def moe_batches(steps=TRAIN_STEPS):
    out = []
    for step in range(steps):
        rs = np.random.RandomState(300 + step)
        out.append({
            "x": rs.randint(0, MOE_LM_KW["vocab_size"],
                            size=(MOE_TRAIN_B, MOE_TRAIN_S)).astype(np.int32),
            "y": rs.randint(0, MOE_LM_KW["vocab_size"],
                            size=(MOE_TRAIN_B, MOE_TRAIN_S)).astype(np.int32)})
    return out


def moe_lm(params, **kw):
    import torch

    from tensorflowonspark_tpu_torch.models import factory

    model = factory.get_model("moe_transformer", device="cpu",
                              dtype=torch.float32, **dict(MOE_LM_KW, **kw))
    model.load_state_dict(params)
    return model


def moe_cases(rank, world, args):
    import torch

    params = torch.load(args["params"], weights_only=True)

    def train(case):
        return _train_case(moe_lm, MOE_CASES[case], moe_batches(), params,
                           os.path.join(args["outdir"], "ckpt_" + case))

    return _cases(MOE_CASES, train)
