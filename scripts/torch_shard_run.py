"""Sharded training of the port on four cards, one rank a card over NCCL.

    python3 scripts/torch_shard_run.py [--out DIR] [--cases ...]

GPT-2-small at full width (12 layers, 12 heads, embed 768, vocab 50257),
bf16 compute over f32 weights, AdamW 3e-4, one global batch trained on
four times, through ``Trainer.train_step`` over
``MeshConfig(...).build()``:

* ``fsdp_tensor`` — (i) ``fsdp=2, tensor=2``, flash route, b8 x s1024;
* ``seq_zigzag``  — (ii) ``seq=4``, ``ring_flash`` with the zigzag layout,
  b1 x s4096 (``max_seq_len`` raised to 4096: the ring is there for long
  sequences; widths are unchanged);
* ``seq_ulysses`` — (iii) ``seq=4``, Ulysses, b1 x s4096;
* ``pipe_gpipe``, ``pipe_interleaved`` — (iv) ``pipe=4``,
  ``pipelined_transformer`` on the flash route, b8 x s1024, 8
  microbatches: GPipe over 4 stages, and interleaved over 12 stages in 3
  rounds;
* ``moe_expert``  — (v) ``bench.py``'s ``bench_moe`` model (8 experts,
  every other layer MoE, flash route) under ``expert=4``, b8 x s1024;
* ``pipe_tensor`` — (vi) ``pipe=2, tensor=2``, ``pipelined_transformer``
  on the flash route, b8 x s1024, GPipe over 2 stages with 8
  microbatches: each stage's blocks Megatron's column/row pair on 6 heads
  and 1536 MLP columns a rank.

For each case every rank records its losses (finite and falling is
required), its step time by CUDA events, its peak memory, its B1-B3
launches a step, and one profiled step (``torch.profiler``): the share
of the card's kernel time in NCCL kernels. Then every rank takes step 1
again on the same mesh with the model in f32. Once the ranks have left,
the launching process takes step 1 on the same global batch with the
one-card trainer (flash route) in bf16 and in f32: the bf16 losses are
held to a bf16 tolerance, and the f32 loss and gradient norms of
parameters every rank holds whole to f32 tolerances. In bf16 those
gradient norms are recorded, not held: the head's backward GEMM reduces
over the whole vocabulary, and cuBLAS's bf16 reductions there round
differently at each shape (a rank's token count, a tensor rank's
vocabulary slab), so the layer norm before the head reads a few percent
apart. Every rank writes ``<out>/rank<r>.json`` (``--out``, default the
git-ignored ``build/shard_run``); the script prints one summary line a
case, the card's name and power limit, and a JSON object of all of it
last. Exit 0 only when every check held; 2 without four cards. The
one-card reference of (iv) is the pipelined LM's sequential path on the
same seeded weights.
"""

import argparse
import json
import os
import socket
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GPT2_SMALL = dict(vocab_size=50257, num_layers=12, num_heads=12,
                  embed_dim=768, mlp_dim=3072, max_seq_len=1024, remat=False)
CASES = {
    "fsdp_tensor": dict(mesh=dict(data=1, fsdp=2, tensor=2),
                        model=dict(attention_impl="pallas"), batch=8,
                        seq=1024),
    "seq_zigzag": dict(mesh=dict(data=1, seq=4),
                       model=dict(attention_impl="ring_flash",
                                  ring_layout="zigzag", max_seq_len=4096),
                       batch=1, seq=4096),
    "seq_ulysses": dict(mesh=dict(data=1, seq=4),
                        model=dict(attention_impl="ulysses",
                                   max_seq_len=4096),
                        batch=1, seq=4096),
    "pipe_gpipe": dict(mesh=dict(data=1, pipe=4),
                       name="pipelined_transformer",
                       model=dict(attention_impl="pallas", num_stages=4,
                                  num_microbatches=8),
                       batch=8, seq=1024),
    "pipe_interleaved": dict(mesh=dict(data=1, pipe=4),
                             name="pipelined_transformer",
                             model=dict(attention_impl="pallas",
                                        num_stages=12, num_rounds=3,
                                        num_microbatches=8),
                             batch=8, seq=1024),
    "moe_expert": dict(mesh=dict(data=1, expert=4), name="moe_transformer",
                       model=dict(attention_impl="pallas", num_experts=8,
                                  moe_every=2),
                       batch=8, seq=1024),
    # The vocabulary splits over tensor: its norm is a rank's slab's.
    "pipe_tensor": dict(mesh=dict(data=1, pipe=2, tensor=2),
                        name="pipelined_transformer",
                        model=dict(attention_impl="pallas", num_stages=2,
                                   num_microbatches=8),
                        batch=8, seq=1024,
                        norms=("ln_f.scale", "pos_embed")),
}
LR = 3e-4
# Step 1 against the one-card trainer: the bf16 loss; in f32 the loss and
# the gradient norms of parameters every rank holds whole (summation
# order apart).
LOSS_RTOL = 5e-3
F32_LOSS_RTOL = 1e-5
F32_GRAD_NORM_RTOL = 1e-3
NORM_PARAMS = ("ln_f.scale", "block_0.ln1.scale", "block_11.ln2.bias")
# Every rank holds these whole in the pipelined and the MoE LM.
CASE_NORM_PARAMS = {
    "pipelined_transformer": ("ln_f.scale", "embed.embedding", "pos_embed"),
    "moe_transformer": NORM_PARAMS + ("block_1.moe.router.kernel",),
}


def _norm_params(c):
    return c.get("norms") or CASE_NORM_PARAMS.get(c.get("name"), NORM_PARAMS)


def log(*args):
    print(*args, flush=True)


def lm_batch(batch, seq, vocab):
    tokens = np.random.RandomState(0).randint(
        1, vocab, size=(batch, seq)).astype(np.int32)
    return {"x": tokens, "y": tokens}


def _lm(torch, c, kw, dtype=None):
    from tensorflowonspark_tpu_torch.models import factory

    return factory.get_model(c.get("name", "transformer"),
                             dtype=dtype or torch.bfloat16, device="cuda",
                             seed=0, **dict(GPT2_SMALL, **kw))


def _step1(torch, trainer_kw, c, kw, dtype, feed):
    """Loss and gradient norms of step 1 on ``feed`` in ``dtype``."""
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    tr = Trainer(_lm(torch, c, kw, dtype), optimizer=trainer.adamw(LR),
                 device="cuda", **trainer_kw)
    st = tr.init()
    st, m = tr.train_step(st, feed(tr))
    out = (float(m["loss"]), {n: float(st.params[n].grad.float().norm())
                              for n in _norm_params(c)})
    del tr, st
    torch.cuda.empty_cache()
    return out


def _nccl_share(prof):
    total = nccl = 0.0
    for ev in prof.events():
        if (str(getattr(ev, "device_type", "")).endswith("CUDA")
                and not getattr(ev, "is_user_annotation", False)):
            ms = ev.self_device_time_total / 1e3
            total += ms
            if "nccl" in ev.name.lower():
                nccl += ms
    return nccl, total


def run_case(torch, name, rank):
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.ops import attention
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.parallel import collectives as coll
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    c = CASES[name]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = MeshConfig(**c["mesh"]).build()
    tr = Trainer(_lm(torch, c, c["model"]), optimizer=trainer.adamw(LR),
                 mesh=mesh, device="cuda")
    state = tr.init()
    batch = lm_batch(c["batch"], c["seq"], tr.model.cfg.vocab_size)
    if c["model"].get("ring_layout") == "zigzag":
        batch = {k: attention.zigzag_layout(v, c["mesh"]["seq"])
                 for k, v in batch.items()}
    rows = tr.batch_placer.rows(c["batch"])
    fed = {k: v[rows] for k, v in batch.items()}
    losses, ms, launches = [], [], []
    for step in range(4):
        before = dict(fa.launches)
        coll.reset_traffic()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = tr.train_step(state, fed)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        launches.append({k: fa.launches[k] - before[k] for k in before})
        if step == 0:
            norms = {n: float(state.params[n].grad.float().norm())
                     for n in _norm_params(c)}
    traffic = dict(coll.traffic)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = tr.train_step(state, fed)
        torch.cuda.synchronize()
    nccl_ms, kernel_ms = _nccl_share(prof)
    out = {"losses": losses, "ms": ms, "launches": launches,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in state.params.values()),
           "nccl_ms": nccl_ms, "kernel_ms": kernel_ms,
           "collective_calls": traffic["calls"],
           "collective_bytes": traffic["bytes"], "norms": norms}
    del tr, state
    torch.cuda.empty_cache()
    out["f32_loss"], out["f32_norms"] = _step1(
        torch, {"mesh": mesh}, c, c["model"], torch.float32, lambda t: fed)
    dist.barrier()
    return out


def reference(torch, name):
    """Step 1 of the one-card trainer (flash route) on the case's global
    batch, in the launching process once the ranks have left: ``{dtype: (loss,
    norms)}`` for bf16 and f32."""
    c = CASES[name]
    kw = dict(c["model"], attention_impl="pallas", ring_layout="contiguous")
    return {str(dtype).split(".")[-1]: _step1(
        torch, {}, c, kw, dtype,
        lambda t: lm_batch(c["batch"], c["seq"], t.model.cfg.vocab_size))
        for dtype in (torch.bfloat16, torch.float32)}


def rank_main(rank, port, cases, out):
    import torch
    import torch.distributed as dist

    try:
        sys.path.insert(0, ROOT)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl", init_method="tcp://127.0.0.1:{}".format(port),
            world_size=WORLD, rank=rank,
            device_id=torch.device("cuda", rank))
        doc = {"rank": rank, "device": torch.cuda.get_device_name(rank),
               "cases": {}}
        for name in cases:
            t0 = time.perf_counter()
            doc["cases"][name] = run_case(torch, name, rank)
            doc["cases"][name]["seconds"] = time.perf_counter() - t0
        with open(os.path.join(out, "rank{}.json".format(rank)), "w") as f:
            json.dump(doc, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, "rank{}.err".format(rank)), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def check(name, docs, refs):
    """The case's summary and its failures."""
    from tensorflowonspark_tpu_torch.ops import attention

    c = CASES[name]
    fails = []
    r0 = docs[0]["cases"][name]
    for d in docs:
        got = d["cases"][name]
        if got["losses"] != r0["losses"]:
            fails.append("rank {} losses {} differ from rank 0's".format(
                d["rank"], got["losses"]))
    losses = r0["losses"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fails.append("losses not finite and falling: {}".format(losses))
    ref_loss, ref_norms = refs["bfloat16"]
    if abs(losses[0] - ref_loss) > LOSS_RTOL * abs(ref_loss):
        fails.append("step-1 loss {} against one card's {}".format(
            losses[0], ref_loss))
    f32_loss, f32_norms = refs["float32"]
    for d in docs:
        got = d["cases"][name]
        if abs(got["f32_loss"] - f32_loss) > F32_LOSS_RTOL * abs(f32_loss):
            fails.append("rank {} f32 step-1 loss {} against {}".format(
                d["rank"], got["f32_loss"], f32_loss))
        for n, ref in f32_norms.items():
            if abs(got["f32_norms"][n] - ref) > F32_GRAD_NORM_RTOL * abs(ref):
                fails.append("rank {} f32 step-1 gradient norm of {} {} "
                             "against {}".format(d["rank"], n,
                                                 got["f32_norms"][n], ref))
    layers = GPT2_SMALL["num_layers"]
    impl = c["model"]["attention_impl"]
    for d in docs:
        if impl == "ulysses":
            want = 0
        elif c.get("name") == "pipelined_transformer":
            # Each rank runs its layers once a microbatch.
            want = c["model"]["num_microbatches"] * layers \
                // c["mesh"]["pipe"]
        elif impl == "ring_flash":
            want = attention.ring_flash_launches(
                WORLD, c["model"]["ring_layout"])[d["rank"]] * layers
        else:
            want = layers
        for counts in d["cases"][name]["launches"]:
            if set(counts.values()) != {want}:
                fails.append("rank {} launched {} a step; want {}".format(
                    d["rank"], counts, want))
    summary = {
        "mesh": c["mesh"], "model": c.get("name", "transformer"),
        "batch": c["batch"], "seq": c["seq"],
        "attention_impl": impl, "losses": losses,
        "ref_step1_loss": ref_loss, "ref_step1_norms": ref_norms,
        "step1_norms": r0["norms"], "f32_step1": [r0["f32_loss"],
                                                  r0["f32_norms"]],
        "ref_f32_step1": [f32_loss, f32_norms],
        "step_ms": [d["cases"][name]["ms"] for d in docs],
        "step_ms_median_steps_2_4": float(np.median(
            [x for d in docs for x in d["cases"][name]["ms"][1:]])),
        "peak_bytes": [d["cases"][name]["peak_bytes"] for d in docs],
        "param_bytes": [d["cases"][name]["param_bytes"] for d in docs],
        "nccl_share": [d["cases"][name]["nccl_ms"]
                       / max(d["cases"][name]["kernel_ms"], 1e-9)
                       for d in docs],
        "nccl_ms": [d["cases"][name]["nccl_ms"] for d in docs],
        "kernel_ms": [d["cases"][name]["kernel_ms"] for d in docs],
        "collective_bytes": [d["cases"][name]["collective_bytes"]
                             for d in docs],
        "flash_launches_a_step": [d["cases"][name]["launches"][0]
                                  for d in docs],
        "seconds": r0["seconds"]}
    return summary, fails


def main():
    import subprocess

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=list(CASES))
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "shard_run"),
                    help="directory for each rank's JSON record")
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print("torch_shard_run: needs {} CUDA devices, found {}".format(
            WORLD, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tensorflowonspark_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().replace("\n", "; ")
    log("cards:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    _build.build_all()
    log("build {:.1f} s".format(time.perf_counter() - t0))
    out = args.out
    os.makedirs(out, exist_ok=True)
    for r in range(WORLD):
        for ext in (".json", ".err"):
            path = os.path.join(out, "rank{}{}".format(r, ext))
            if os.path.exists(path):
                os.unlink(path)
    import multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, port, args.cases, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 780
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [open(os.path.join(out, "rank{}.err".format(r))).read()
              for r in range(WORLD)
              if os.path.exists(os.path.join(out, "rank{}.err".format(r)))]
    if errors or any(p.exitcode != 0 for p in procs):
        log("ranks failed (exit codes {}):".format(
            [p.exitcode for p in procs]))
        log("\n".join(errors))
        return 1
    docs = [json.load(open(os.path.join(out, "rank{}.json".format(r))))
            for r in range(WORLD)]
    report, failures = {}, []
    for name in args.cases:
        summary, fails = check(name, docs, reference(torch, name))
        report[name] = summary
        failures += ["{}: {}".format(name, f) for f in fails]
        log("{}: mesh {} b{} s{} {}: losses {} (one card step 1 {:.5f}); "
            "f32 step 1 {:.6f} against {:.6f}; step ms a rank (median of "
            "steps 2-4) {:.2f}; peak GB a rank {}; NCCL share {}; B1 "
            "launches a step a rank {}".format(
                name, summary["mesh"], summary["batch"], summary["seq"],
                summary["attention_impl"],
                ["{:.5f}".format(x) for x in summary["losses"]],
                summary["ref_step1_loss"], summary["f32_step1"][0],
                summary["ref_f32_step1"][0],
                summary["step_ms_median_steps_2_4"],
                ["{:.2f}".format(b / 2 ** 30) for b in summary["peak_bytes"]],
                ["{:.3f}".format(x) for x in summary["nccl_share"]],
                [x["flash_fwd"] for x in summary["flash_launches_a_step"]]))
    log("cards:", card)
    for f in failures:
        log("FAILED", f)
    log(json.dumps({"ok": not failures, "cards": card, "cases": report}))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
