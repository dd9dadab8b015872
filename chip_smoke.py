"""Smoke run of the PyTorch/H100 port on one card: ``python3 chip_smoke.py``.

Drives ``tensorflowonspark_tpu_torch`` through the entry points a user
calls and fails (non-zero exit) if any phase fails:

1. device   — requires CUDA; prints the card's name and power limit;
2. kernels  — builds every CUDA kernel from ``tensorflowonspark_tpu_torch/
               csrc`` and holds each against its plain PyTorch version on
               the card, at the repo's bench shapes and the main path's
               shapes, timing kernel, plain version and a PyTorch yardstick:
               the paged decode step (B4: the bench and main shapes as
               f32, bf16, int8, int8_bf16 and GQA f32; GQA and MQA bf16,
               head widths 32 and 128, edge rows, one long row, a wide
               table, d = 8 int8 and token-tiled f32 pages; every case
               called twice and held bitwise equal to itself; over a
               verify window of 13 queries a row, ``paged_attention_window``'s
               one launch bitwise equal to 13 one-token calls, at the main
               shape and its GQA variant), and the flash-attention forward,
               dQ and dK/dV kernels (B1-B3) at the training shapes, packed,
               GQA, f32, ragged (s 1000) and non-causal rectangular, at
               GPT-2-small's width split into head widths 32 and 128 (SDPA's
               forward, and its backward alone, timed at each width), and
               at the mesh paths' per-call batches b1, b2 and b4;
3. serve    — ``ServingEngine`` at GPT-2-small width (bf16, random seeded
               weights, page_size 128, decode_horizon 1, no sharing, no
               preemption) serves mixed requests, once with a bf16 pool and
               once with an int8 pool; every decode step of every layer must
               launch B4; then a profiler window over steady decode steps
               says where a step's time goes (device busy, kernels a step,
               B4's share);
   serve_default — the engine at its defaults (decode horizon 8, prefix
               sharing, swap preemption) on ``bench.py``'s serving model
               (GPT-2-small widths, context 512, chunked cache attention)
               and ``bench_serving_continuous``'s load (24 requests, 12
               slots, page 64, 49 pages), bf16 and int8 pools: B4 launched
               decode calls x 8 x 12 times, streams bitwise those of the
               same load at horizon 1; a prefix burst (8 requests on one
               256-token prompt, 7 prefix hits) against a no-sharing run;
               a preemption drill in swap (streams bitwise the
               uninterrupted run's) and recompute mode; swap-out and
               swap-in times a page;
   spec     — speculative decoding: (a) ``bench_serving_speculative``'s
               latency regime (``serve_default``'s model as the stem-sharing
               target and ``gpt2-draft`` pair, one slot, page 64, k 12,
               horizon 8; prompts of 24-64 tokens, 64 new each) against the
               same engine without a draft: tok/s, acceptance rate, rounds;
               (b) a random-init draft at 8 rows, k 4 (every round rolls
               back), bf16, f32 and int8 pools, against the same load
               without a draft; every stream held against the baseline's
               one-token paged steps teacher-forced (near ties excepted),
               B4 launched verify calls x 12 + draft steps x 2 (+ decode
               calls x 8 x 12) times, no page left;
   fleet    — the serving fleet plane at ``serve_default``'s geometry and
               load: (a) a prefill-role and a decode-role engine behind
               ``ServingFleet`` (the pages crossing through the handoff
               wire codec) against one colocated engine, bf16 and int8
               pools: streams bitwise, every handoff taken, no fallback,
               no page left, B4 launched only by the decode engine (its
               decode calls x 8 x 12); (b) the decode engine behind a
               ``MetricsServer`` as a ``RemoteEngine``, 4 requests over
               ``POST /v1/migrate``, streams equal (a)'s; (c) a drain
               with ``migrate_requests`` between two stepped engines,
               migrated streams bitwise, ledgers balanced; (d) the
               ``Autoscaler`` from 1 replica to 2 under queue pressure
               (``spawn_fn`` builds and warms an engine) and back to 1
               through a drain with migration, its ledger audit holding;
               handoff bytes a request, kv-transfer medians, TTFT
               p50/p95 disaggregated against colocated, migration ms a
               page, scale-up and drain seconds;
4. train    — ``Trainer.train_step`` at GPT-2-small width (``bench.py``'s
               ``_lm_trainer``: b8 x s1024, bf16 compute, f32 weights,
               ``attention_impl="pallas"``, AdamW 3e-4) takes 4 steps with
               the loss falling and B1, B2 and B3 each launched 12 times a
               step; a remat step (24 B1 launches), a packed step, step 1
               against the dense attention route, and a profiled window;
               then step 1 at ``examples/transformer/train_lm.py``'s
               geometry (head width 32) against the dense route;
   whole    — the main path whole at the same width: ``Trainer.fit`` over
               CPU batches (``DevicePrefetch`` copies them; B1-B3 12 launches
               each a step) with a checkpoint every 2 steps; step 4
               committed and every retained manifest valid; step 5 of the
               live trainer bitwise equal to that of a fresh trainer
               restored from the checkpoint; ``restore_variables`` served
               by a bf16 ``ServingEngine`` (B4 every decode step), its
               greedy streams equal to the live weights' streams and to
               solo decode (teacher-forced, near ties excepted); an async
               save bitwise equal to its snapshot after two more steps;
               step bytes, save/restore seconds and ``fit``'s step time;
   export   — the export and Spark-ML inference plane: (a) GPT-2-small
               (bf16, flash route) trained 2 steps at b8 x s1024, its
               checkpoint committed, ``export_saved_model`` with the
               ``torch.export`` serving artifact traced at tokens (2, 128),
               and again from CPU tensors; ``load_saved_model(prefer_aot=
               False)`` and ``load_from_checkpoint`` predict b4 x s256
               bitwise the live forward, B1 12 launches a call; both
               artifacts served on the card at batches 1 and 4 by a fresh
               interpreter that loads no ``models`` module, against the
               live weights' dense route (limit 0.1); ``generate`` greedy
               bitwise the live model's; ``serving_engine()`` at the JAX
               defaults on 8 requests of ``serve_default``'s shapes,
               streams bitwise an engine built on the live model, B4
               decode calls x 8 x 12, no page left; (b) ``TFEstimator(
               train_fn, export_fn)`` in FEED mode on two executors sharing
               the card (2 layers at GPT-2-small width, vocab 512, data=2
               over gloo; the fit runs beside (a), the serving child beside
               (a)'s checks), then ``TFModel.transform`` over 64 rows on the
               same executors with a ``model_registrar``, bitwise the
               in-process ``predict`` on the same batches; fit, export_fn
               and transform seconds;
5. resnet   — the fused ResNet bottleneck: B5 (1x1 conv + statistics, with
               and without the bn+relu prologue) and B6 (3x3 conv +
               statistics) against their plain versions at the JAX test
               shape (bf16 and f32), ``scripts/block_bench.py``'s two b256
               blocks, timed beside their bound and their library
               renditions (``torch.matmul``/``F.conv2d`` + sums),
               ResNet-50's stages 2 and 4 at b16 and a ragged block, every
               call bitwise equal to a second one; ``bottleneck_forward``
               at both blocks (B5 twice and B6 once a call) against the
               port's ``BottleneckBlock`` in train mode, ``reference_forward``
               and each per-slot library swap; then ``bench.py``'s
               ``bench_resnet50`` through ``Trainer.train_step`` (ResNet-50,
               b256 224x224 bf16, SGD 0.1 momentum 0.9: 4 steps on one
               batch, finite and falling losses, running statistics moved,
               images/s) and a profiled window;
6. cluster  — the README's Quickstart on the port: ``cluster.run`` over
               ``LocalBackend`` executors in FEED mode, ``c.train``,
               ``c.inference``, ``c.shutdown``. (a) one executor trains
               GPT-2-small width (b8 x s1024 bf16, ``attention_impl=
               "pallas"``, AdamW 3e-4) 6 steps through ``sync_batches``,
               B1-B3 launched 12 times a step in the executor, every
               step's loss equal to the driver's in-process trainer on the
               same batch; (c) ``c.inference`` answers one greedy token per
               item, by partition, equal to in-process ``predict`` (B1 12
               launches a batch); (b) two executors share the card, data=2
               over gloo (NCCL refuses two ranks on one card), 2 layers at
               GPT-2-small width: replicas bitwise equal after every step,
               one rank on a lockstep zero batch, losses and the update
               against one in-process trainer on the concatenated global
               batches; (d) the executor's step (CUDA events) against the
               in-process step, the feed wait a step, each rank's peak
               memory, and ``cluster.run`` to the first step;
   files    — the FILES-mode data tier: (a) GPT-2-small at ``_lm_trainer``'s
               geometry (12 layers, b8 x s1024 a rank, bf16, AdamW 3e-4,
               flash route) from 320 seeded token documents (lengths
               log-uniform over 16-3072) written by
               ``dfutil.save_as_tfrecords`` into 8 shards, read by two
               FILES-mode executors on the card (data=2 over gloo), each
               through ``InputPipeline(shard=(2, i), reader_threads=1)``,
               a transform that strips each document's padding and
               ``packing.packed_batches``, into ``Trainer.fit`` for 6
               steps: each rank's batches bitwise the driver's inline
               pipeline for its shard, losses finite and falling,
               replicas bitwise after every step, step 1 against one
               trainer on the global batch (``TRAIN_LOSS_RTOL``), B1-B3
               12 launches a step a rank; then a step with a row of
               padding alone through B1-B3 and their plain versions (and
               with that row's tokens changed: no gradient moves); (b)
               ``bench_resnet50_piped``'s feed (1024 uint8 224x224x3
               records in 8 shards, b256) through a two-worker decode pool
               (shared memory) with a batch cache into ResNet-50 (SGD
               0.1/0.9) under ``DevicePrefetch``, normalised on the card by
               ``input_normalizer``: a worker SIGKILLed in epoch 1, the
               epoch bitwise an inline run's, epoch 2 replayed from the
               cache bitwise epoch 1, no shared-memory segment left;
               feed-only, cache-replay and trained images/s and the data
               wait; the native codecs must load;
   recover  — supervised relaunch, elastic membership and remote agents:
               (a) ``cluster.run(..., restart_policy=RestartPolicy(
               max_restarts=1), checkpoint_dir=...)`` trains GPT-2-small
               width at 2 layers (the cluster phase's b8 x s1024) 6 steps
               with a commit every 2 and ``FaultPlan.crash_at_step(4)``:
               one restart, the relaunch resumes at committed step 4 and
               discards the fed batches already trained, B1-B3 8 + 4
               launches over the two incarnations, the committed step-6 weights bitwise
               those of an in-process trainer on the same 6 batches, and
               the card's free memory before the relaunch builds its
               model within 1 GiB of the reading before the first
               attempt; (b) a hang at step 2 (2 layers, heartbeats
               dropped) classified hung within 5 s, the hung child and its
               CUDA context gone before the relaunch, resumed at step 2;
               (c) two executors under ``elastic=dict(min_nodes=1,
               rejoin_delay=1.0)``, each training its own 2-layer model,
               a spot preemption after step 3 with a grace of twice (b)'s
               step and commit: no restart, a departure, a rejoin from a
               committed step above 0, world size 2 at the end, B1-B3 in
               both incarnations; (d) the Quickstart over
               ``RemoteBackend(2)`` and two ``tools/agent.py`` agents
               (data=2 over gloo, 2 layers): 3 steps, then
               ``c.inference`` equal to in-process ``predict`` on the
               trained weights; (e) seconds from each fault to its
               detection, to the end of teardown and to the relaunch's
               first step, restore seconds, the memory readings, the grace
               and the agents' bring-up;
   shard    — sharded meshes, two ranks sharing the card over gloo (every
               collective staged through host memory), GPT-2-small width
               at 2 layers, bf16, AdamW 3e-4: (a) ``tensor=2`` on the
               flash route, 3 steps against the one-rank trainer, B1-B3
               2 launches a step a rank; (b) ``seq=2`` ``ring_flash``
               contiguous and zigzag at b2 x s2048: step 1's bf16 loss,
               and in f32 its loss and gradients, against the one-rank
               flash route, B1-B3 launches a rank equal to the ring
               schedule's; (c) ``fsdp=2`` against ``data=2``: parameter,
               optimizer and peak bytes a rank; (d) ResNet-50 f32 with
               global-batch BatchNorm under ``data=2`` against one
               process on the concatenated batch, running statistics
               equal on both ranks; then B1-B3 at the ring's block shapes
               (a 512 x 512 zigzag stripe pair, a fully masked held
               block) against their plain versions;
   moe      — ``bench.py``'s ``bench_moe`` model (GPT-2-small widths, 8
               experts, every other layer MoE, flash route, b8 x s1024
               bf16, AdamW 3e-4): (a) 4 steps through ``Trainer.train_step``,
               losses falling, B1-B3 12 launches a step, the load-balance
               term above 0 (its balance ``aux / (0.01 x 6)`` printed),
               step 1's loss and gradient norms in bf16 against B1-B3's
               plain versions on the card with routing teacher-forced
               (the dense route read beside them), and in f32 against the
               dense attention route, step ms, peak memory and a profiled
               window; (b) the trained weights served
               by a bf16 engine at horizon 8 and 1 on ``serve_default``'s
               load: every request finished, no page left, B4 launched
               decode calls x horizon x 12 times, horizon 8's streams
               bitwise horizon 1's and solo decode's teacher-forced to near
               ties; (c) ``expert=2`` over two gloo ranks on the card at 2
               layers (layer 1 MoE): f32 step 1's loss and gradients
               against one rank, bf16 losses falling, each rank holding
               half of every expert weight;
   pipe     — ``pipelined_transformer`` at GPT-2-small width, 4 layers,
               b8 x s1024 global, flash route, over four gloo ranks on the
               card: GPipe (2 stages) and interleaved (4 stages, 2 rounds)
               under (data 2, pipe 2), and GPipe under (pipe 2, tensor 2),
               (fsdp 2, pipe 2) and (pipe 2, seq 2), 4 microbatches each:
               f32 step 1's loss and gradients (rebuilt whole from the
               shards) against one rank on the same weights (the
               sequential path), bf16 losses falling, B1-B3 launches a
               rank = microbatches x local layers a step, each stage
               parameter's share a rank, step ms and collective bytes a
               rank;
7. greedy   — engine streams equal solo ``generate`` bitwise at the toy
               fp32 geometry (horizon 1; and horizon 4 with a joining
               request, prefix sharers, a COW duplicate, a swap and a
               recompute resume), and teacher-forced at full width in
               fp32;
8. http     — ``POST /v1/generate`` from a separate process over TCP.

The B1-B3 rows' ``launches`` add the export phase's and the executors'
launches of the export, cluster, files, recover, shard, moe and pipe
phases (each executor resets its counts before its loop and reports them;
a recover incarnation appends its counts to its audit log at every step,
since a crashed one returns nothing) to the train phase's; the B4 row adds
the spec, export and moe phases' serving. The last two lines of standard output are the ``kernels`` JSON
record and ``{"ok": true, "device": {...}}``. In the record, ``ms`` and
``library_ms`` are device times (:func:`device_ms`: the call's kernels
alone, timed with the card held busy until the host has queued the call);
``call_ms`` and ``plain_ms`` are CUDA events around the whole call
(:func:`time_cold`), the wrapper's host work included.
"""

import contextlib
import glob
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

GPT2_SMALL = dict(vocab_size=50257, num_layers=12, num_heads=12,
                  embed_dim=768, mlp_dim=3072, max_seq_len=1024, remat=False)
TOY = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32, mlp_dim=64,
           max_seq_len=128, remat=False)
# Kernel tolerances: those of the JAX package's kernel tests.
TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 1e-4, "int8_bf16": 2e-2}
# Flash kernels (B1-B3) against their plain versions, by output. Largest
# readings over two runs (NVIDIA H100 80GB HBM3, 700 W): bf16 out and dq
# 7.8e-3 (one bf16 rounding flipped where the f32 sums' order differs, at
# values up to 4; 0.07-0.14% of the values differ at all), dk and dv (f32
# sums of bf16 products, where such a flipped P or dS enters) 3.5e-3, lse
# 9.5e-7; f32 cases 4.8e-7 for out, 9.5e-7 for lse, the backward bitwise.
# Limits: about twice the largest reading of each kind.
FLASH_TOL = {
    "bf16": {"out": 1.6e-2, "lse": 2e-6, "dq": 1.6e-2, "dk": 8e-3,
             "dv": 8e-3},
    "f32": {"out": 1e-6, "lse": 2e-6, "dq": 1e-6, "dk": 1e-6, "dv": 1e-6},
}
# Step 1 of the flash route against the dense route on the same weights
# and batch, relative differences. Readings (same card): loss 1.7e-6,
# gradient norms of GRAD_NORM_PARAMS at most 9.3e-5 — dense rounds its
# scores to bf16 before the softmax, flash keeps them in f32.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_NORM_RTOL = 4e-4
# A bf16 output is also held bit for bit: the kernel rounds where the plain
# version rounds (scores, p, each page's PV partial), so only the order of
# its f32 sums may flip an output's last bit. At most this share of the
# outputs may differ at all; a walk that skips one of those roundings
# differs in far more (tests/test_torch_paged_attention.py holds that).
BF16_MAX_DIFFERING = 0.01
L2_FLUSH_BYTES = 128 << 20   # > the H100's 50 MB L2


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# -- kernel phase --------------------------------------------------------------


def paged_case(torch, seed, dtype, quant, h, h_kv, d, ps, tw, lens):
    """Operands of one decode step on the card: b = len(lens) rows, each
    holding tw pages of a permuted pool table; garbage in every page."""
    g = torch.Generator().manual_seed(seed)
    b = len(lens)
    n_pages = b * tw + 1
    table = (torch.randperm(n_pages - 1, generator=g)[:b * tw] + 1).reshape(
        b, tw).to(torch.int32)
    q = torch.randn(b, 1, h, d, generator=g).to(dtype)
    if quant:
        kp = torch.randint(-127, 128, (n_pages, ps, h_kv, d), generator=g)
        vp = torch.randint(-127, 128, (n_pages, ps, h_kv, d), generator=g)
        kp, vp = kp.to(torch.int8), vp.to(torch.int8)
        ks = torch.rand(n_pages, ps, h_kv, generator=g) * 0.02 + 1e-3
        vs = torch.rand(n_pages, ps, h_kv, generator=g) * 0.02 + 1e-3
    else:
        kp = torch.randn(n_pages, ps, h_kv, d, generator=g).to(dtype)
        vp = torch.randn(n_pages, ps, h_kv, d, generator=g).to(dtype)
        ks = vs = None
    dev = lambda t: None if t is None else t.cuda()  # noqa: E731
    return dict(q=dev(q), k_pages=dev(kp), v_pages=dev(vp),
                page_table=dev(table),
                seq_lens=dev(torch.tensor(lens, dtype=torch.int32)),
                page_size=ps, k_scales=dev(ks), v_scales=dev(vs))


def call(fn, c):
    return fn(c["q"], c["k_pages"], c["v_pages"], c["page_table"],
              c["seq_lens"], page_size=c["page_size"], k_scales=c["k_scales"],
              v_scales=c["v_scales"])


def time_cold(torch, fn, reps=20, warmup=3):
    """Median milliseconds of ``fn()`` with L2 flushed before each call
    (a decode step finds each layer's pool cold: the weights stream
    through L2 between layers). The flush READS a buffer larger than L2,
    so no dirty lines are left to write back during the timed call. CUDA
    events around each call."""
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                       device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(torch, fn, reps=20, warmup=3, spin_cycles=4_000_000):
    """Device milliseconds of one ``fn()``: CUDA events around the call
    while a spin kernel (``torch.cuda._sleep``, about 2 ms) holds the card
    until the host has queued the whole call, so the wrapper's host work
    does not count, only the call's kernels and the gaps between them; L2
    flushed by a read before each call, as in :func:`time_cold`; the
    median of ``reps`` calls. A call that the card reached before the host
    had queued it (its start event already passed) is timed again with
    twice the spin. The same reading serves a kernel and its library
    yardstick. (``torch.profiler`` windows this short lost device
    activities on the card: 51 of 60 in one window, all in another.)"""
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                       device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < reps:
        flush.sum()
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        if start.query():
            spin_cycles *= 2
            if spin_cycles > 256_000_000:
                raise AssertionError("device_ms: the host cannot queue the "
                                     "call within a 128 ms spin")
            continue
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def paged_bound_ms(torch, c, peak_bw, peak_ops_fn):
    """Least time of the step: the bytes it must move (visible K/V tokens
    and their scales, q, out, table, lengths — each once) over the memory
    rate, or its FLOPs (QK and PV) over the operand type's peak, the
    larger of the two."""
    b, _, h, d = c["q"].shape
    h_kv = c["k_pages"].shape[2]
    tokens = int((c["seq_lens"].long() + 1).sum())
    kv_bytes = 2 * tokens * h_kv * d * c["k_pages"].element_size()
    if c["k_scales"] is not None:
        kv_bytes += 2 * tokens * h_kv * 4
    io_bytes = 2 * c["q"].numel() * c["q"].element_size()
    io_bytes += c["page_table"].numel() * 4 + b * 4
    flops = 4 * tokens * h * d
    kind = "bf16" if c["q"].dtype == torch.bfloat16 else "f32"
    t_bytes = (kv_bytes + io_bytes) / peak_bw
    t_ops = flops / peak_ops_fn(kind)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_yardstick(torch, c):
    """``F.scaled_dot_product_attention`` over the same K/V pre-gathered
    into contiguous (b, h, L, d) form with a per-row visibility mask — a
    timing yardstick only; the port never calls it."""
    import torch.nn.functional as F

    q, tw = c["q"], c["page_table"].shape[1]
    b, _, h, d = q.shape
    ps = c["page_size"]
    h_kv = c["k_pages"].shape[2]
    k = c["k_pages"][c["page_table"].long()].reshape(b, tw * ps, h_kv, d)
    v = c["v_pages"][c["page_table"].long()].reshape(b, tw * ps, h_kv, d)
    length = int(c["seq_lens"].max()) + 1
    k = k[:, :length].transpose(1, 2).contiguous()
    v = v[:, :length].transpose(1, 2).contiguous()
    mask = (torch.arange(length, device="cuda")[None, :]
            <= c["seq_lens"].long()[:, None])[:, None, None, :]
    qt = q.transpose(1, 2).contiguous()

    def run():
        return F.scaled_dot_product_attention(qt, k, v, attn_mask=mask,
                                              enable_gqa=h != h_kv)
    return run


PAGED_BENCH = dict(h=12, h_kv=12, d=64, ps=64, tw=8,
                   lens=[5, 60, 64, 130, 200, 300, 450, 511])
PAGED_MAIN = dict(h=12, h_kv=12, d=64, ps=128, tw=8,
                  lens=[96, 200, 333, 512, 640, 777, 900, 1023])
# B4 cases beyond the five kinds at the bench and main shapes: (name, kind,
# dtype name, quant, shape). GQA and MQA; head widths 32 and 128, where
# scale is no power of two and a fused multiply-subtract would round once
# instead of twice; edge rows (empty but for the new token, one short of a
# page, a page, one past it, the whole table); one long row alone; a wide
# table whose rows use few of its slots; d = 8 int8 (rows of 8 bytes: the
# element path); f32 pages of 256 tokens at d = 128, walked in token tiles.
PAGED_EXTRA = [
    ("main", "gqa_bf16", "bfloat16", False, dict(PAGED_MAIN, h_kv=4)),
    ("main", "mqa_bf16", "bfloat16", False, dict(PAGED_MAIN, h_kv=1)),
    ("main_d128", "bf16", "bfloat16", False,
     dict(PAGED_MAIN, h=6, h_kv=6, d=128)),
    ("main_d32", "bf16", "bfloat16", False,
     dict(PAGED_MAIN, h=24, h_kv=24, d=32)),
    ("edges", "bf16", "bfloat16", False,
     dict(PAGED_MAIN, lens=[0, 127, 128, 129, 8 * 128 - 1])),
    ("edges", "int8_bf16", "bfloat16", True,
     dict(PAGED_MAIN, lens=[0, 127, 128, 129, 8 * 128 - 1])),
    ("one_row", "bf16", "bfloat16", False, dict(PAGED_MAIN, lens=[1023])),
    ("tw16", "bf16", "bfloat16", False,
     dict(PAGED_BENCH, tw=16, lens=[3, 64, 200, 700, 1023, 130])),
    ("toy_d8", "int8", "float32", True,
     dict(h=4, h_kv=4, d=8, ps=16, tw=8, lens=[0, 15, 16, 40, 127])),
    ("tiled", "f32", "float32", False,
     dict(h=4, h_kv=2, d=128, ps=256, tw=4, lens=[5, 255, 256, 700])),
]


def paged_check(torch, pa, shape_name, kind, c):
    """B4 against its plain version on case ``c``: the largest difference
    within ``TOL``, in bf16 at most ``BF16_MAX_DIFFERING`` of the outputs
    differing at all, and a second call bitwise equal to the first."""
    got = call(pa.paged_attention, c)
    again = call(pa.paged_attention, c)
    torch.cuda.synchronize()
    ref = call(pa.paged_attention_reference, c)
    err = float((got.float() - ref.float()).abs().max())
    differing = float((got != ref).float().mean())
    tol = TOL[kind.split("_", 1)[1] if kind[:4] in ("gqa_", "mqa_")
              else kind]
    log("kernel paged_decode {:9s} {:10s} max_abs_err {:.3e} (tol {:g}) "
        "differing {:.4f}".format(shape_name, kind, err, tol, differing))
    if not err <= tol:
        raise AssertionError("paged_decode {} {} disagrees with its plain "
                             "version: {} > {}".format(shape_name, kind, err,
                                                       tol))
    if got.dtype == torch.bfloat16 and not differing <= BF16_MAX_DIFFERING:
        raise AssertionError(
            "paged_decode {} {}: {:.4f} of the bf16 outputs differ from the "
            "plain version (limit {})".format(shape_name, kind, differing,
                                              BF16_MAX_DIFFERING))
    if not torch.equal(got, again):
        raise AssertionError("paged_decode {} {}: two calls on the same "
                             "operands differ".format(shape_name, kind))
    return err


def window_check(torch, pa, w=13):
    """B4 over a verify window (``paged_attention_window``: one launch over
    b * W virtual rows) against W one-token calls at ``seq_len = lens + j``,
    bitwise: a row's output depends only on its query, table and length.
    W = 13 (the spec phase's k = 12), bf16 at the main shape and at its GQA
    variant, each row's window ending inside its table."""
    for name, h_kv in (("main", PAGED_MAIN["h_kv"]), ("gqa", 4)):
        kw = dict(PAGED_MAIN, h_kv=h_kv)
        lens = [max(0, n - w) for n in kw["lens"]]
        c = paged_case(torch, 100 + h_kv, torch.bfloat16, False, kw["h"],
                       h_kv, kw["d"], kw["ps"], kw["tw"], lens)
        b = len(lens)
        g = torch.Generator().manual_seed(h_kv)
        q = torch.randn(b, w, kw["h"], kw["d"], generator=g).to(
            torch.bfloat16).cuda()
        args = (c["k_pages"], c["v_pages"], c["page_table"])
        before = pa.launches
        got = pa.paged_attention_window(q, *args, c["seq_lens"],
                                        page_size=c["page_size"])
        if pa.launches != before + 1:
            raise AssertionError("paged_attention_window launched {} "
                                 "kernels".format(pa.launches - before))
        differ = 0
        for j in range(w):
            one = pa.paged_attention(q[:, j:j + 1].contiguous(), *args,
                                     c["seq_lens"] + j,
                                     page_size=c["page_size"])
            differ += int((got[:, j:j + 1] != one).sum())
        torch.cuda.synchronize()
        log("kernel paged_decode window {:4s} W {} rows {}: {} of {} "
            "outputs differ from the one-token calls".format(
                name, w, b * w, differ, got.numel()))
        if differ:
            raise AssertionError("paged_attention_window {} differs from "
                                 "one-token calls".format(name))


def kernel_phase(torch, pa, device_info):
    cases = []
    for shape_name, shape in (("bench", PAGED_BENCH), ("main", PAGED_MAIN)):
        for kind, dtype, quant, h_kv in (
                ("f32", torch.float32, False, shape["h_kv"]),
                ("bf16", torch.bfloat16, False, shape["h_kv"]),
                ("int8", torch.float32, True, shape["h_kv"]),
                ("int8_bf16", torch.bfloat16, True, shape["h_kv"]),
                ("gqa_f32", torch.float32, False, 4)):
            kw = dict(shape, h_kv=h_kv)
            c = paged_case(torch, len(cases), dtype, quant, kw["h"], h_kv,
                           kw["d"], kw["ps"], kw["tw"], kw["lens"])
            cases.append((shape_name, kind, c,
                          paged_check(torch, pa, shape_name, kind, c)))
    for shape_name, kind, dtype, quant, kw in PAGED_EXTRA:
        c = paged_case(torch, len(cases), getattr(torch, dtype), quant,
                       kw["h"], kw["h_kv"], kw["d"], kw["ps"], kw["tw"],
                       kw["lens"])
        cases.append((shape_name, kind, c,
                      paged_check(torch, pa, shape_name, kind, c)))
    window_check(torch, pa, SPEC_K + 1)
    peak_bw = device_info.peak_bandwidth()
    if peak_bw is None:
        raise RuntimeError("no bandwidth figure for this card: {}".format(
            torch.cuda.get_device_name(0)))
    timings = {}
    for shape_name, kind, c, _ in cases:
        if (shape_name not in ("bench", "main")
                or kind not in ("bf16", "int8_bf16")):
            continue
        kernel = lambda: call(pa.paged_attention, c)  # noqa: E731
        ms = device_ms(torch, kernel)
        call_ms = time_cold(torch, kernel)
        plain_ms = time_cold(torch,
                             lambda: call(pa.paged_attention_reference, c))
        lib_ms = (device_ms(torch, sdpa_yardstick(torch, c))
                  if kind == "bf16" else None)
        bound_ms, bound_by = paged_bound_ms(torch, c, peak_bw,
                                            device_info.peak_ops)
        timings[(shape_name, kind)] = dict(
            ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        log("time   paged_decode {:5s} {:10s} kernel {:.4f} ms (call {:.4f}) "
            " plain {:.4f} ms  sdpa {}  bound {:.4f} ms ({})".format(
                shape_name, kind, ms, call_ms, plain_ms,
                "-" if lib_ms is None else "{:.4f} ms".format(lib_ms),
                bound_ms, bound_by))
    return max(err for *_, err in cases), timings


# -- flash-attention kernels (B1-B3) -------------------------------------------


def lm_segments(batch, seq):
    """``bench.py``'s packed layout: two documents per row and a padded
    last eighth."""
    seg = np.ones((batch, seq), np.int32)
    seg[:, seq // 2:] = 2
    seg[:, -seq // 8:] = 0
    return seg


def ragged_segments(batch, seq):
    """Two documents per row with a row-dependent boundary, and a padded
    tail on odd rows only (37 tokens times the row): at a length that is
    not a multiple of 64, even rows use their partial last tile, and the
    boundaries and padding fall inside tiles."""
    seg = np.ones((batch, seq), np.int32)
    for i in range(batch):
        seg[i, seq // 2 + 13 * i:] = 2
        if i % 2:
            seg[i, seq - 37 * i:] = 0
    return seg


SEGMENTS = {"none": lambda b, s: np.ones((b, s), np.int32),
            "packed": lm_segments, "ragged": ragged_segments}


def flash_case(torch, fa, seed, b, s, h, h_kv, dtype, segments, s_k=None,
               causal=True, d=64):
    """Head-major operands of one attention call on the card, with its
    segment ids and the lengths the kernels take."""
    s_k = s_k or s
    g = torch.Generator().manual_seed(seed)
    dev = lambda t: t.to(dtype).cuda()  # noqa: E731
    c = dict(q=dev(torch.randn(b, h, s, d, generator=g)),
             k=dev(torch.randn(b, h_kv, s_k, d, generator=g)),
             v=dev(torch.randn(b, h_kv, s_k, d, generator=g)),
             do=dev(torch.randn(b, h, s, d, generator=g)), causal=causal)
    c["q_seg"] = torch.as_tensor(SEGMENTS[segments](b, s)).cuda()
    c["k_seg"] = (c["q_seg"] if s_k == s else
                  torch.as_tensor(SEGMENTS[segments](b, s_k)).cuda())
    c["lens"] = fa._lengths(c["q_seg"], c["k_seg"])
    return c


def flash_calls(fa, c, route):
    """The three calls on ``c`` by route: ``"kernel"`` the public wrappers
    (lengths computed in the call), ``"launch"`` the kernels alone with
    the case's lengths (as one attention call's forward and backward
    reach them), ``"plain"`` the plain versions. The backward calls take
    the plain forward's lse and delta, so each kernel is held against its
    plain version on the same inputs."""
    args = (c["q"], c["k"], c["v"])
    segs = (c["q_seg"], c["k_seg"])
    grads = (c["do"], c["lse"], c["delta"])
    causal = c["causal"]
    if route == "launch":
        opts = (c["lens"], causal, None, None)
        return {
            "flash_fwd": lambda: fa._forward(*args, *segs, *opts),
            "flash_bwd_dq": lambda: fa._bwd_dq(*args, *grads, *segs, *opts),
            "flash_bwd_dkv": lambda: fa._bwd_dkv(*args, *grads, *segs,
                                                 *opts),
        }
    fwd, dq, dkv = ((fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
                    if route == "kernel" else
                    (fa.flash_forward_reference, fa.flash_bwd_dq_reference,
                     fa.flash_bwd_dkv_reference))
    return {
        "flash_fwd": lambda: fwd(*args, *segs, causal=causal),
        "flash_bwd_dq": lambda: dq(*args, *grads, *segs, causal=causal),
        "flash_bwd_dkv": lambda: dkv(*args, *grads, *segs, causal=causal),
    }


def flash_bound_ms(torch, c, name, peak_bw, peak_ops):
    """Least time of one kernel call on this run's data: its matmul FLOPs
    over the visible (query, key) pairs (2 d per pair per product: QK^T
    and PV forward; QK^T, dO V^T and dS K for dQ; those and P^T dO, dS^T Q
    for dK/dV without dS K) at the bf16 peak, or the bytes it must move
    (inputs read once, outputs written once) at the memory rate, the
    larger."""
    b, h, s_q, d = c["q"].shape
    q_seg, k_seg = c["q_seg"].long(), c["k_seg"].long()
    visible = ((q_seg[:, :, None] == k_seg[:, None, :])
               & (q_seg != 0)[:, :, None])
    if c["causal"]:
        q_pos = torch.arange(s_q, device=q_seg.device)
        k_pos = torch.arange(k_seg.shape[1], device=q_seg.device)
        visible &= q_pos[:, None] >= k_pos[None, :]
    pairs = int(visible.sum()) * h
    products = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[name]
    flops = 2 * d * pairs * products
    el = c["q"].element_size()
    qkv = (c["q"].numel() + c["k"].numel() + c["v"].numel()) * el
    rows = b * h * s_q * 4                    # one f32 per query row
    seg_bytes = (c["q_seg"].numel() + c["k_seg"].numel()) * 4
    io = {
        "flash_fwd": qkv + c["q"].numel() * el + rows,
        "flash_bwd_dq": qkv + 2 * c["q"].numel() * el + 2 * rows,
        "flash_bwd_dkv": (qkv + c["do"].numel() * el + 2 * rows
                          + 2 * c["k"].numel() * 4),
    }[name] + seg_bytes
    kind = "bf16" if c["q"].dtype == torch.bfloat16 else "f32"
    t_ops, t_bytes = flops / peak_ops(kind), io / peak_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sdpa_yardsticks(torch, c):
    """``F.scaled_dot_product_attention`` (causal) on the same head-major
    q, k, v: the forward, and the backward alone — ``torch.autograd.grad``
    with ``dO`` on a graph whose forward ran once, outside the timed
    window, and is retained. One backward call computes dQ, dK and dV
    together. Timing yardsticks only; the port never calls it."""
    import torch.nn.functional as F

    q, k, v = (c[n].detach().requires_grad_() for n in ("q", "k", "v"))

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def bwd():
        return torch.autograd.grad(out, (q, k, v), c["do"],
                                   retain_graph=True)
    return fwd, bwd


# name: (dtype kind, flash_case arguments). "ragged" and "full" reach the
# partial last tile and the masked-tile path, and the non-causal schedule;
# the six after them split GPT-2-small's width 768 into heads of 32 and
# 128, the kernels' other instances ("main_d32" and "main_d128" are timed
# beside "main"); the last three are the batch a call of the mesh paths
# (b2: a pipe phase microbatch; b4: the moe phase's (c); b1: a microbatch
# of torch_shard_run.py's pipe=4 cases).
FLASH_CASES = [
    ("main", "bf16", dict(b=8, s=1024, h=12, h_kv=12, segments="none")),
    ("packed", "bf16", dict(b=8, s=1024, h=12, h_kv=12, segments="packed")),
    ("gqa", "bf16", dict(b=8, s=1024, h=12, h_kv=4, segments="packed")),
    ("f32", "f32", dict(b=4, s=1024, h=12, h_kv=12, segments="packed")),
    ("ragged", "bf16", dict(b=8, s=1000, h=12, h_kv=12, segments="ragged")),
    ("full", "bf16", dict(b=8, s=1024, s_k=768, h=12, h_kv=12,
                          segments="none", causal=False)),
    ("main_d32", "bf16", dict(b=8, s=1024, h=24, h_kv=24, segments="none",
                              d=32)),
    ("main_d128", "bf16", dict(b=8, s=1024, h=6, h_kv=6, segments="none",
                               d=128)),
    ("d32", "bf16", dict(b=8, s=1024, h=24, h_kv=24, segments="packed",
                         d=32)),
    ("d128", "bf16", dict(b=8, s=1024, h=6, h_kv=6, segments="packed",
                          d=128)),
    ("d128gqa", "bf16", dict(b=8, s=1024, h=6, h_kv=2, segments="packed",
                             d=128)),
    ("d128f32", "f32", dict(b=4, s=1024, h=6, h_kv=6, segments="packed",
                            d=128)),
    ("d32f32", "f32", dict(b=4, s=1024, h=24, h_kv=24, segments="packed",
                           d=32)),
    ("mb1", "bf16", dict(b=1, s=1024, h=12, h_kv=12, segments="none")),
    ("mb2", "bf16", dict(b=2, s=1024, h=12, h_kv=12, segments="none")),
    ("mb4", "bf16", dict(b=4, s=1024, h=12, h_kv=12, segments="none")),
]
# The cases timed in flash_timings, by head width.
FLASH_TIMED = {64: "main", 32: "main_d32", 128: "main_d128"}


def flash_compare(torch, fa, c, case, kind, errs):
    """Each kernel against its plain version on case ``c``'s inputs (the
    backward kernels take the plain forward's lse and delta); raises past
    :data:`FLASH_TOL` or :data:`BF16_MAX_DIFFERING`, folds each kernel's
    largest error into ``errs``, returns the log parts."""
    ref_out, ref_lse = fa.flash_forward_reference(
        c["q"], c["k"], c["v"], c["q_seg"], c["k_seg"], causal=c["causal"])
    c["lse"] = ref_lse
    c["delta"] = (ref_out.float() * c["do"].float()).sum(dim=-1)
    got = {n: fn() for n, fn in flash_calls(fa, c, "kernel").items()}
    torch.cuda.synchronize()
    ref = {n: fn() for n, fn in flash_calls(fa, c, "plain").items()}
    pairs = {
        "flash_fwd": (("out", got["flash_fwd"][0], ref_out),
                      ("lse", got["flash_fwd"][1], ref_lse)),
        "flash_bwd_dq": (("dq", got["flash_bwd_dq"], ref["flash_bwd_dq"]),),
        "flash_bwd_dkv": (("dk", got["flash_bwd_dkv"][0],
                           ref["flash_bwd_dkv"][0]),
                          ("dv", got["flash_bwd_dkv"][1],
                           ref["flash_bwd_dkv"][1])),
    }
    parts = []
    for name, outs in pairs.items():
        for label, a, r in outs:
            err = float((a.float() - r.float()).abs().max())
            tol = FLASH_TOL[kind][label]
            differing = float((a != r).float().mean())
            parts.append("{} {:.3e} ({:.4f} differ)".format(
                label, err, differing))
            if not err <= tol:
                raise AssertionError(
                    "{} {} {}: {} disagrees with its plain version: "
                    "{} > {}".format(name, case, kind, label, err, tol))
            if a.dtype == torch.bfloat16 and not (
                    differing <= BF16_MAX_DIFFERING):
                raise AssertionError(
                    "{} {}: {:.4f} of the bf16 {} values differ from "
                    "the plain version (limit {})".format(
                        name, case, differing, label, BF16_MAX_DIFFERING))
            errs[name] = max(errs[name], err)
    return parts


def flash_phase(torch, fa):
    """Every case of FLASH_CASES against the plain versions; returns the
    largest error of each kernel and the timed cases ({d: case})."""
    errs = {name: 0.0 for name in fa.launches}
    timed = {}
    for i, (case, kind, kw) in enumerate(FLASH_CASES):
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        c = flash_case(torch, fa, 100 + i, dtype=dtype, **kw)
        parts = flash_compare(torch, fa, c, case, kind, errs)
        log("kernel flash {:9s} {:4s} b{} s{}x{} h{}/{} d{}{}: {}".format(
            case, kind, kw["b"], kw["s"], kw.get("s_k", kw["s"]), kw["h"],
            kw["h_kv"], kw.get("d", 64), "" if c["causal"] else " full",
            ", ".join(parts)))
        timed.update({d: c for d, name in FLASH_TIMED.items()
                      if name == case})
    return errs, timed


def flash_timings(torch, fa, device_info, errs, timed):
    """Kernel (device), call, plain and SDPA (device) times of B1-B3 at
    the timed cases (b8 s1024 bf16 causal at head width 32, 64 and 128),
    beside their bound; returns the main case's (d = 64)."""
    peak_bw = device_info.peak_bandwidth()
    timings = {}
    for d in sorted(timed, key=lambda d: d != 64):
        c = timed[d]
        sdpa_fwd, sdpa_bwd = sdpa_yardsticks(torch, c)
        lib = {"flash_fwd": device_ms(torch, sdpa_fwd)}
        lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = device_ms(torch,
                                                               sdpa_bwd)
        launch = flash_calls(fa, c, "launch")
        kernels = flash_calls(fa, c, "kernel")
        plains = flash_calls(fa, c, "plain")
        for name in fa.launches:
            ms = device_ms(torch, launch[name])
            call_ms = time_cold(torch, kernels[name])
            plain_ms = time_cold(torch, plains[name], reps=5)
            bound_ms, bound_by = flash_bound_ms(torch, c, name, peak_bw,
                                                device_info.peak_ops)
            if d == 64:
                timings[name] = dict(ms=ms, call_ms=call_ms,
                                     plain_ms=plain_ms, library_ms=lib[name],
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     max_abs_err=errs[name])
            log("time   {:13s} {:9s} h{} d{} bf16 kernel {:.4f} ms (call "
                "{:.4f})  plain {:.4f} ms  sdpa {} {:.4f} ms  bound {:.4f} "
                "ms ({})".format(
                    name, FLASH_TIMED[d], c["q"].shape[1], d, ms, call_ms,
                    plain_ms,
                    "fwd" if name == "flash_fwd" else "bwd (dq+dk+dv)",
                    lib[name], bound_ms, bound_by))
    return timings


# -- main path -----------------------------------------------------------------


def serve_requests(torch, model, variables, kv_cache_dtype, n_requests, seed,
                   pa):
    from tensorflowonspark_tpu_torch.serving import FINISHED, ServingEngine

    engine = ServingEngine(model, variables, max_slots=8, page_size=128,
                           decode_horizon=1, prefix_share=False,
                           preempt="off", kv_cache_dtype=kv_cache_dtype,
                           device="cuda")
    rs = np.random.RandomState(seed)
    reqs = []
    for _ in range(n_requests):
        p = int(rs.randint(32, 513))
        n = int(rs.randint(16, 65))
        reqs.append((rs.randint(1, model.cfg.vocab_size, size=p), n))
    pa.reset_launches()
    t0 = time.perf_counter()
    handles = [engine.submit(p, n) for p, n in reqs]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    stats = engine.stats()
    for (p, n), h in zip(reqs, handles):
        toks = h.result(timeout=5)
        if h.state != FINISHED or len(toks) != n:
            raise AssertionError("request ended {} with {} of {} tokens"
                                 .format(h.state, len(toks), n))
    want = engine.decode_steps * model.cfg.num_layers
    if launches != want:
        raise AssertionError("paged_decode launched {} times; {} decode "
                             "steps x {} layers = {}".format(
                                 launches, engine.decode_steps,
                                 model.cfg.num_layers, want))
    if engine.pool.pages_in_use:
        raise AssertionError("pages leaked: {}".format(
            engine.pool.pages_in_use))
    engine.close()
    log("main   pool {:4s} requests {} tokens {} decode_steps {} "
        "launches {} decode tok/s {:.1f} step {:.2f} ms ttft_p50 {:.2f} ms "
        "wall {:.2f} s".format(
            kv_cache_dtype or "bf16", n_requests, stats["tokens_generated"],
            stats["decode_steps"], launches,
            stats["decode_tokens"] / stats["decode_seconds"],
            stats["decode_seconds"] / stats["decode_steps"] * 1e3,
            stats["ttft_ms_p50"], wall))
    return launches


def main_phase(torch, pa):
    from tensorflowonspark_tpu_torch.models import decoding, factory

    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device="cuda", seed=0, **GPT2_SMALL)
    variables = decoding.serving_variables(model.state_dict(),
                                           torch.bfloat16)
    launches = 0
    for kv_cache_dtype, seed in (("", 1), ("int8", 2)):
        launches += serve_requests(torch, model, variables, kv_cache_dtype,
                                   12, seed, pa)
    profile_decode(torch, model, variables)
    del model, variables
    torch.cuda.empty_cache()
    return launches


# -- serving at the engine's defaults -----------------------------------------

# bench.py:1454-1467 ``_serving_model``: GPT-2-small widths, context 512,
# chunked cache attention, bf16 serving variables from a seed; and
# bench.py:1064-1140 ``bench_serving_continuous``'s load and engine: 24
# requests over four shapes, 12 slots, page 64, 1 + 4 x 12 pages, prefill
# floor 32, at the engine's defaults (horizon 8, prefix sharing, swap).
SERVE_DEFAULT_LM = dict(vocab_size=50257, num_layers=12, num_heads=12,
                        embed_dim=768, mlp_dim=3072, max_seq_len=512,
                        remat=False, decode_attention="chunked")
SERVE_DEFAULT_SHAPES = [(32, 24), (64, 48), (96, 16), (128, 32)]
SERVE_DEFAULT_ENGINE = dict(max_slots=12, page_size=64, num_pages=1 + 4 * 12,
                            prefill_floor=32)
_COUNTERS = ("decode_steps", "decode_tokens", "decode_seconds",
             "prefill_seconds", "prefix_hits", "preemptions",
             "preempt_swaps", "preempt_recomputes")


def default_engine(model, variables, **kw):
    from tensorflowonspark_tpu_torch.serving import ServingEngine

    args = dict(SERVE_DEFAULT_ENGINE, device="cuda")
    args.update(kw)
    engine = ServingEngine(model, variables, **args)
    # Warm: one request per shape (first calls of each GEMM shape),
    # drained before anything is counted.
    rs = np.random.RandomState(99)
    for p, n in SERVE_DEFAULT_SHAPES:
        engine.submit(rs.randint(1, model.cfg.vocab_size, size=p), n)
    engine.run_until_idle()
    return engine


def serve_counted(torch, engine, pa, run):
    """``run(engine)`` submits requests, drives the engine to idle and
    returns ``[(handle, max_new_tokens)]``; B4's count is set to 0 just
    before and read just after. Every request must finish with its token
    count, no page may stay in use, and B4 must have launched decode calls
    x horizon x layers times. Returns (streams, handles, counter deltas with
    ``launches``)."""
    from tensorflowonspark_tpu_torch.serving import FINISHED

    before = engine.stats()
    pa.reset_launches()
    handles = run(engine)
    torch.cuda.synchronize()
    launches = pa.launches
    after = engine.stats()
    delta = {k: after[k] - before[k] for k in _COUNTERS}
    delta["launches"] = launches
    streams = []
    for h, n in handles:
        toks = h.result(timeout=5)
        if h.state != FINISHED or len(toks) != n:
            raise AssertionError("request ended {} with {} of {} tokens"
                                 .format(h.state, len(toks), n))
        streams.append(toks)
    want = delta["decode_steps"] * engine.decode_horizon * engine.num_layers
    if launches != want:
        raise AssertionError(
            "paged_decode launched {} times; {} decode calls x horizon {} x "
            "{} layers = {}".format(launches, delta["decode_steps"],
                                    engine.decode_horizon,
                                    engine.num_layers, want))
    if engine.pool.pages_in_use:
        raise AssertionError("pages leaked: {}".format(
            engine.pool.pages_in_use))
    return streams, [h for h, _ in handles], delta


def profile_window(torch, fn, reps=3):
    """``fn``'s host ms a call unprofiled (synchronised, median of
    ``reps``), then one ``torch.profiler`` window over ``reps`` calls:
    (host ms, profiled wall ms, device-busy ms, device kernels) a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    by_name, count = device_kernels(prof)
    return (float(np.median(host)), wall, sum(by_name.values()) / reps,
            count / reps)


def decode_profile(torch, runner, card):
    """One decode call over all 12 rows (each at position 200 of its own
    4 pages, greedy) at horizon 8 and at horizon 1: host, device-busy and
    idle share a step."""
    slots = runner.max_slots
    table = np.zeros((slots, runner.table_width), np.int32)
    table[:, :4] = 1 + np.arange(slots * 4).reshape(slots, 4)
    toks = np.arange(1, slots + 1, dtype=np.int32)
    lens = np.full((slots,), 200, np.int32)
    zeros = np.zeros((slots,), np.int32)
    for horizon in (8, 1):
        host, wall, busy, kernels = profile_window(
            torch, lambda: runner.decode(
                toks, table, lens, zeros.astype(np.float32), zeros,
                zeros.astype(np.float32), horizon=horizon, sampling=False))
        log("profile serve_default decode call, {} rows, horizon {}: host "
            "{:.3f} ms/step unprofiled; profiled {:.3f} ms/step, device "
            "busy {:.3f} ms/step, idle share {:.3f}, {:.0f} device kernels/"
            "step ({})".format(slots, horizon, host / horizon,
                               wall / horizon, busy / horizon,
                               1.0 - busy / wall, kernels / horizon, card))


def prefill_profile(torch, runner, card, prompt_len=272, start=256):
    """A 272-token prompt's whole prefill (one 512-slot chunk) against the
    tail a 256-token shared prefix leaves (a 256-slot chunk at index 256
    of the same allocation): host and device-busy ms a prefill."""
    alloc = runner.prefill_alloc(prompt_len)
    rs = np.random.RandomState(5)
    vocab = runner.model.cfg.vocab_size
    full_toks = rs.randint(1, vocab, size=(1, min(alloc,
                                                  runner.prefill_chunk)))
    tail_toks = rs.randint(1, vocab, size=(1, alloc - start))

    def full():
        runner.prefill_step(runner.new_prefill_cache(alloc), full_toks,
                            prompt_len - 1, alloc)

    def tail():
        cache = runner.new_prefill_cache(alloc)
        cache["position"] = start
        for key, layer in cache.items():
            if key != "position":
                layer["cache_index"] = start
        runner.prefill_step(cache, tail_toks, prompt_len - 1 - start, alloc)

    for name, fn in (("whole prompt", full), ("shared-prefix tail", tail)):
        host, wall, busy, kernels = profile_window(torch, fn)
        log("profile serve_default prefill, {}: host {:.3f} ms unprofiled; "
            "profiled {:.3f} ms, device busy {:.3f} ms, idle share {:.3f}, "
            "{:.0f} device kernels ({})".format(
                name, host, wall, busy, 1.0 - busy / wall, kernels, card))


def submit_all(reqs, priority=0):
    def run(engine):
        handles = [(engine.submit(p, n, priority=priority), n)
                   for p, n in reqs]
        engine.run_until_idle()
        return handles
    return run


# serve_default's SLO drill: an objective on the TTFT p95 that the bf16
# load at horizon 8 breaches (its TTFT p95 is tens to hundreds of ms), its
# burn windows short enough for one run, node_stats() ingested every
# SLO_PUMP_S seconds meanwhile.
SLO_TTFT_MS = 5.0
SLO_PUMP_S = 0.1


class _SloWatch:
    """``serve_ttft_ms_p95 < SLO_TTFT_MS`` over a history store fed from
    this process's ``node_stats()`` while a load runs, with an incident
    recorder on the driver's span export: the breach must write exactly
    one ``slo_breach`` bundle carrying the ``cluster/slo_breach``
    marker."""

    def __init__(self, torch):
        import tempfile
        import threading

        from tensorflowonspark_tpu_torch import (incident, telemetry,
                                                 telemetry_store)

        self.root = tempfile.mkdtemp(prefix="tfos-slo-")
        self.tdir = os.path.join(self.root, "telemetry")
        telemetry.configure(node_id="driver", export_dir=self.tdir)
        self.store = telemetry_store.TelemetryStore()
        self.recorder = incident.IncidentRecorder(
            os.path.join(self.root, "incidents"), telemetry_dir=self.tdir)
        self.monitor = self.store.set_slos(
            [{"metric": "serve_ttft_ms_p95", "op": "<",
              "threshold": SLO_TTFT_MS, "windows": [[5.0, 0.5]],
              "min_points": 3}], recorder=self.recorder, interval=0.2)
        self._stop = threading.Event()
        self.beats = 0

        def pump():
            while not self._stop.wait(SLO_PUMP_S):
                self.store.ingest("serve", telemetry.node_stats())
                self.beats += 1

        self._thread = threading.Thread(target=pump, name="slo-pump",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        from tensorflowonspark_tpu_torch import telemetry

        self._stop.set()
        self._thread.join()
        # The last beat after the load, then one evaluation.
        self.store.ingest("serve", telemetry.node_stats())
        self.monitor.evaluate()
        self.bundles = self.recorder.join(timeout=120.0)
        telemetry.disable()

    def check(self, engine, d, st, card):
        import shutil

        names = []
        man = {}
        if self.bundles:
            man, _, _, events = _read_bundle(self.bundles[0])
            names = [e["name"] for e in events or ()]
        status = self.monitor.status()[0]
        p95 = st["ttft_ms_p95"]
        log("serve_default SLO serve_ttft_ms_p95 < {:g} ms (window 5 s, "
            "burn 0.5) on the bf16 load at horizon 8: measured TTFT p95 "
            "{:.2f} ms; {} beats ingested every {:g} s; firing {}; "
            "incident bundles {} (reason {}), cluster/slo_breach markers on "
            "the bundle's timeline {}; B4 launches {} = {} decode calls x 8 "
            "x {}; on {}".format(
                SLO_TTFT_MS, p95, self.beats, SLO_PUMP_S, status["firing"],
                [os.path.basename(b) for b in self.bundles],
                man.get("reason"), names.count("cluster/slo_breach"),
                d["launches"], d["decode_steps"], engine.num_layers, card))
        shutil.rmtree(self.root, ignore_errors=True)
        checks = {
            "TTFT p95 above the objective": p95 > SLO_TTFT_MS,
            "exactly one slo_breach bundle": len(self.bundles) == 1
            and man.get("reason") == "slo_breach",
            "its timeline carries cluster/slo_breach":
                "cluster/slo_breach" in names,
            "B4 launched decode calls x 8 x 12": d["launches"]
            == d["decode_steps"] * 8 * engine.num_layers,
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError("serve_default SLO drill failed: {}".format(
                failed))


def serve_default_phase(torch, pa, card):
    """The engine at its defaults on ``bench_serving_continuous``'s load,
    bf16 and int8 pools, each against the same load at horizon 1 (streams
    bitwise equal); a prefix burst against a no-sharing run; a preemption
    drill in swap and recompute mode against an uninterrupted run.
    Returns B4's launches over the phase."""
    from tensorflowonspark_tpu_torch.models import decoding, factory

    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device="cuda", seed=0, **SERVE_DEFAULT_LM)
    variables = decoding.serving_variables(model.state_dict(),
                                           torch.bfloat16)
    vocab = model.cfg.vocab_size
    rs = np.random.RandomState(0)
    shapes = SERVE_DEFAULT_SHAPES
    reqs = [(rs.randint(1, vocab, size=shapes[i % 4][0]).astype(np.int32),
             shapes[i % 4][1]) for i in range(24)]
    launches = 0
    for kv in ("", "int8"):
        streams = {}
        for horizon in (8, 1):
            engine = default_engine(model, variables, kv_cache_dtype=kv,
                                    decode_horizon=horizon)
            slo = None
            if not kv and horizon == 8:
                slo = _SloWatch(torch)
            try:
                streams[horizon], _, d = serve_counted(torch, engine, pa,
                                                       submit_all(reqs))
            finally:
                if slo is not None:
                    slo.stop()
            st = engine.stats()
            if slo is not None:
                slo.check(engine, d, st, card)
            if not kv and horizon == 8:
                decode_profile(torch, engine.runner, card)
            engine.close()
            launches += d["launches"]
            log("serve_default pool {:4s} horizon {}: requests 24 tokens {} "
                "decode calls {} launches {} (calls x {} x {}) decode tok/s "
                "{:.1f} step {:.3f} ms (call {:.3f} ms) ttft_p50 {:.2f} ms "
                "prefix_hits {} ({})".format(
                    kv or "bf16", horizon, sum(n for _, n in reqs),
                    d["decode_steps"], d["launches"], horizon,
                    model.cfg.num_layers,
                    d["decode_tokens"] / d["decode_seconds"],
                    d["decode_seconds"] / (d["decode_steps"] * horizon) * 1e3,
                    d["decode_seconds"] / d["decode_steps"] * 1e3,
                    st["ttft_ms_p50"], d["prefix_hits"], card))
        if streams[8] != streams[1]:
            bad = sum(a != b for a, b in zip(streams[8], streams[1]))
            raise AssertionError("pool {}: {} of 24 horizon-8 streams differ "
                                 "from horizon 1".format(kv or "bf16", bad))
        log("serve_default pool {:4s}: 24 horizon-8 streams equal horizon 1 "
            "bitwise".format(kv or "bf16"))
    launches += prefix_burst(torch, pa, model, variables, rs, card)
    launches += preemption_drill(torch, pa, model, variables, rs, card)
    del model, variables
    torch.cuda.empty_cache()
    return launches


def prefix_burst(torch, pa, model, variables, rs, card):
    """8 requests on one 256-token prompt with distinct 16-token tails:
    with sharing, 7 of them gather the 4 shared pages and prefill only
    their tail; their streams against a ``prefix_share=False`` run, both
    teacher-forced against solo decode up to near ties (the tail's prefill
    runs GEMMs of other shapes, so bf16 streams may part at a near tie).
    Each engine first serves a burst on another prefix, uncounted, so that
    both counted runs find their shapes warm."""
    vocab = model.cfg.vocab_size

    def make_burst():
        prefix = rs.randint(1, vocab, size=256)
        return [(np.concatenate([prefix, rs.randint(1, vocab, size=16)])
                 .astype(np.int32), 16) for _ in range(8)]

    warm, burst = make_burst(), make_burst()
    out = {}
    launches = 0
    for share in (True, False):
        engine = default_engine(model, variables, prefix_share=share)
        submit_all(warm)(engine)
        streams, _, d = serve_counted(torch, engine, pa, submit_all(burst))
        launches += d["launches"]
        if share and d["prefix_hits"] < 7:
            raise AssertionError("prefix burst: {} prefix hits, want >= 7"
                                 .format(d["prefix_hits"]))
        compared, stops, worst = _solo_teacher_forced(torch, model, burst,
                                                      streams)
        if share:
            prefill_profile(torch, engine.runner, card)
        engine.close()
        out[share] = (streams, d)
        log("serve_default burst prefix_share={}: prefix_hits {} prefill "
            "{:.2f} ms, teacher-forced {} tokens, {} near-tie stops "
            "(largest {:.1f} bf16 steps)".format(
                share, d["prefix_hits"], d["prefill_seconds"] * 1e3,
                compared, stops, worst))
    equal = sum(a == b for a, b in zip(out[True][0], out[False][0]))
    saved = (out[False][1]["prefill_seconds"]
             - out[True][1]["prefill_seconds"]) * 1e3
    log("serve_default burst: {} of 8 shared streams equal the unshared "
        "ones; prefill saved {:.2f} ms ({:.2f} against {:.2f} ms) ({})"
        .format(equal, saved, out[True][1]["prefill_seconds"] * 1e3,
                out[False][1]["prefill_seconds"] * 1e3, card))
    return launches


def preemption_drill(torch, pa, model, variables, rs, card):
    """Four low-priority requests fill a 12-page pool (3 pages each), then
    two high-priority ones arrive and each evicts the newest low. Swap
    mode: every stream bitwise the uninterrupted run's (the bytes come
    back exactly and the decode batch keeps its shape); recompute mode:
    the victims replay through the prefill and are held teacher-forced
    against solo decode up to near ties, the rest bitwise. Then the swap
    copy's host and device times a page."""
    vocab = model.cfg.vocab_size
    lows = [(rs.randint(1, vocab, size=128).astype(np.int32), 48)
            for _ in range(4)]
    highs = [(rs.randint(1, vocab, size=128).astype(np.int32), 32)
             for _ in range(2)]

    def drill(engine):
        handles = [(engine.submit(p, n), n) for p, n in lows]
        engine.step()
        engine.step()
        handles += [(engine.submit(p, n, priority=1), n) for p, n in highs]
        engine.run_until_idle()
        return handles

    launches = 0
    engine = default_engine(model, variables, preempt="off")
    want, _, d = serve_counted(torch, engine, pa, drill)
    engine.close()
    launches += d["launches"]
    if d["preemptions"]:
        raise AssertionError("the uninterrupted run preempted")
    for mode in ("swap", "recompute"):
        engine = default_engine(model, variables, num_pages=1 + 12,
                                preempt=mode)
        streams, handles, d = serve_counted(torch, engine, pa, drill)
        launches += d["launches"]
        key = "preempt_swaps" if mode == "swap" else "preempt_recomputes"
        if d["preemptions"] < 2 or d[key] != d["preemptions"]:
            raise AssertionError("{} drill: {} preemptions, {} {}".format(
                mode, d["preemptions"], d[key], key))
        victims = [i for i, h in enumerate(handles) if h._req.preempt_count]
        for i, (got, ref) in enumerate(zip(streams, want)):
            if got != ref and (mode == "swap" or i not in victims):
                raise AssertionError(
                    "{} drill: stream {} differs from the uninterrupted "
                    "run".format(mode, i))
        note = "all 6 streams bitwise the uninterrupted run's"
        if mode == "recompute":
            compared, stops, worst = _solo_teacher_forced(
                torch, model, [lows[i] for i in victims],
                [streams[i] for i in victims])
            note = ("bystanders and preemptors bitwise; victims "
                    "teacher-forced {} tokens, {} near-tie stops (largest "
                    "{:.1f} bf16 steps), {} of {} bitwise".format(
                        compared, stops, worst,
                        sum(streams[i] == want[i] for i in victims),
                        len(victims)))
        log("serve_default drill preempt={}: preemptions {} victims {}; {}"
            .format(mode, d["preemptions"], victims, note))
        if mode == "swap":
            swap_timing(torch, engine, card)
        engine.close()
    return launches


def swap_timing(torch, engine, card, n_pages=3, reps=5):
    """Swap-out (``extract_pages``: device pages to host memory) and
    swap-in (``restore_pages``) of ``n_pages`` pages, synchronised host
    time, median of ``reps``; the pages hold a drained engine's stale
    bytes and are written back unchanged."""
    pages = list(range(1, 1 + n_pages))
    out_ms, in_ms = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = engine.runner.extract_pages(pages)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.runner.restore_pages(host, pages)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out_ms.append((t1 - t0) * 1e3)
        in_ms.append((t2 - t1) * 1e3)
    log("serve_default swap: {} bytes a page (every layer's K and V); "
        "swap-out {:.3f} ms a page, swap-in {:.3f} ms a page ({} pages, "
        "median of {}) ({})".format(
            engine.pool.page_bytes, float(np.median(out_ms)) / n_pages,
            float(np.median(in_ms)) / n_pages, n_pages, reps, card))


# -- speculative decoding -----------------------------------------------------

# bench.py:1739-1809 ``bench_serving_speculative``: the latency regime (one
# slot, page 64, k 12, horizon 8, prefill floor 32) on ``_serving_model``
# with the stem-sharing ``gpt2-draft`` pair; prompts of 24, 32, 48 and 64
# tokens, 64 new tokens each, every shape warmed once.
SPEC_SHAPES = [(24, 64), (32, 64), (48, 64), (64, 64)]
SPEC_K = 12
SPEC_ENGINE = dict(max_slots=1, page_size=64, decode_horizon=8,
                   prefill_floor=32)
# The rollback path: a random-init draft (acceptance ~1/vocab, so every
# round rejects) at 8 rows, k 4, horizon 8, page 64: bf16 and f32 targets
# and a bf16 target over int8 pools, against the same load without a draft.
SPEC_ROLLBACK_K = 4
SPEC_ROLLBACK_ROWS = 8
SPEC_ROLLBACK_CASES = [("bf16", "bfloat16", ""), ("f32", "float32", ""),
                       ("int8", "bfloat16", "int8")]


def stem_sharing_pair(torch, model, variables, draft_layers=2):
    """bench.py:1688-1733 ``_speculative_pair`` on the port: the target's
    blocks from ``draft_layers`` up get their residual writes zeroed
    (``attn.out`` and ``mlp.down``, so each is x + 0) and the draft is the
    registry's ``gpt2-draft`` reusing the target's stem (embedding,
    positions, final norm, the first ``draft_layers`` blocks). Draft and
    target then compute the same logits while the target still streams all
    of its layers. Returns (target variables, draft model, draft
    variables)."""
    import dataclasses

    from tensorflowonspark_tpu_torch.models import factory

    target = dict(variables)
    for i in range(draft_layers, model.cfg.num_layers):
        for name in ("attn.out.kernel", "mlp.down.kernel"):
            key = "block_{}.{}".format(i, name)
            target[key] = torch.zeros_like(target[key])
    stem = {"embed", "pos_embed", "ln_f"} | {
        "block_{}".format(i) for i in range(draft_layers)}
    draft_vars = {k: v for k, v in target.items()
                  if k.split(".")[0] in stem}
    kw = {f.name: getattr(model.cfg, f.name)
          for f in dataclasses.fields(model.cfg)}
    kw["num_layers"] = draft_layers
    draft = factory.get_model("gpt2-draft", device=str(model.device), **kw)
    if set(draft.state_dict()) != set(draft_vars):
        raise AssertionError("the draft's parameters are not the target's "
                             "stem: {}".format(sorted(
                                 set(draft.state_dict()) ^ set(draft_vars))))
    return target, draft, draft_vars


def _paged_teacher_forced(torch, model, kv, reqs, streams, page_size=64,
                          prefill_floor=32):
    """Each stream against the baseline engine's own computation,
    teacher-forced: the prompt's prefill (the engine's chunk allocation)
    scattered into a one-row pool of the stream's KV dtype, then one-token
    paged steps along the stream (B4 on every step); see
    :func:`_teacher_forced`."""
    from tensorflowonspark_tpu_torch.serving import PagePool
    from tensorflowonspark_tpu_torch.serving.runner import ModelRunner

    longest = max(len(p) + n for p, n in reqs)
    r = ModelRunner(model, None, max_slots=1, page_size=page_size,
                    num_pages=1 + PagePool.pages_needed(longest, page_size),
                    prefill_floor=prefill_floor, kv_quant=kv)
    row = np.arange(1, 1 + r.table_width, dtype=np.int32)
    table = torch.as_tensor(row[None], device=model.device)

    def start(p, n):
        alloc = r.prefill_alloc(len(p))
        pc, logits = r.prefill_step(r.new_prefill_cache(alloc), p[None],
                                    len(p) - 1, alloc)
        r.scatter(pc, row, len(p), alloc)
        return logits

    def step(tok, pos):
        return model(torch.tensor([[tok]], device=model.device),
                     decode=True, pages=table,
                     seq_lens=torch.tensor([pos], dtype=torch.int32,
                                           device=model.device),
                     cache=r.cache)[0, 0].float()

    return _teacher_forced(torch, reqs, streams, start, step,
                           "the baseline's paged steps")


def _held(torch, model, kv, reqs, spec, base):
    """Speculative streams against the baseline engine's: how many are
    equal, every speculative stream held against the baseline's paged
    steps teacher-forced, and the baseline's own streams where the two
    differ (an equal one is covered by the first check). Returns the
    summary text."""
    differ = [i for i, (a, b) in enumerate(zip(spec, base)) if a != b]
    held = _paged_teacher_forced(torch, model, kv, reqs, spec)
    base_held = (_paged_teacher_forced(
        torch, model, kv, [reqs[i] for i in differ],
        [base[i] for i in differ]) if differ else (0, 0, 0.0))
    return ("streams equal to the baseline's {} of {}; teacher-forced on "
            "the baseline's paged steps: spec {} tokens, {} near-tie stops "
            "(worst {:.1f} bf16 steps); the differing baseline streams {} "
            "tokens, {} stops (worst {:.1f})".format(
                len(spec) - len(differ), len(spec), *held, *base_held))


class _SpanWindow:
    """The engine's ``serve/*`` spans over one run, when ``on``: span
    recording into a ring buffer (no export), median milliseconds by name
    after :meth:`close`."""

    NAMES = ("serve/draft", "serve/verify", "serve/draft_prefill",
             "serve/decode_batch")

    def __init__(self, on):
        from tensorflowonspark_tpu_torch import telemetry

        self.rec = None
        if on and not telemetry.enabled():
            self.rec = telemetry.configure(node_id="spec")
        self.medians = {}

    def close(self):
        from tensorflowonspark_tpu_torch import telemetry

        if self.rec is None:
            return
        by_name = {}
        for sp in self.rec.spans():
            if sp["name"] in self.NAMES:
                by_name.setdefault(sp["name"], []).append(sp["dur"] * 1e3)
        telemetry.disable()
        self.medians = {k: (float(np.median(v)), len(v))
                        for k, v in by_name.items()}

    def text(self):
        return "".join(
            "; {} median {:.3f} ms of {}".format(k, *self.medians[k])
            for k in self.NAMES if k in self.medians)


def _spec_profile(torch, engine, card):
    """One speculative round of one row at position 100 (the draft's k
    steps, then the target's verify of k + 1 tokens), or without a draft
    one decode call at the engine's horizon: host and device-busy ms,
    idle share and device kernels (:func:`profile_window`)."""
    r = engine.runner
    k = engine.speculative_tokens
    lens = np.full((1,), 100, np.int32)
    zf, zi = np.zeros((1,), np.float32), np.zeros((1,), np.int32)
    table = np.zeros((1, r.table_width), np.int32)
    table[0, :3] = [1, 2, 3]
    if k:
        toks = np.ones((1, k + 1), np.int32)

        def run():
            engine.draft_runner.decode(toks[:, 0], engine._draft_table[:1],
                                       lens, zf, zi, zf, horizon=k,
                                       sampling=False)
            r.verify(toks, table, lens)
        what = "round (draft {} steps + verify {} tokens)".format(k, k + 1)
    else:
        def run():
            r.decode(zi + 1, table, lens, zf, zi, zf,
                     horizon=engine.decode_horizon, sampling=False)
        what = "decode call (horizon {})".format(engine.decode_horizon)
    host, wall, busy, kernels = profile_window(torch, run)
    log("profile spec (a) {}, one row: host {:.3f} ms unprofiled; profiled "
        "{:.3f} ms, device busy {:.3f} ms, idle share {:.3f}, {:.0f} device "
        "kernels ({})".format(what, host, wall, busy, 1.0 - busy / wall,
                              kernels, card))


def _spec_run(torch, pa, engine, reqs):
    """Serve ``reqs`` on a warmed engine with B4's count set to 0 just
    before and read just after. Every request must finish with its token
    count and no page stay in use; B4 must have launched verify calls x the
    target's layers + draft steps x the draft's layers + decode calls x
    horizon x the target's layers. Returns (streams, tokens/s, B4
    launches, counter deltas)."""
    from tensorflowonspark_tpu_torch.serving import FINISHED

    keys = ("spec_rounds", "spec_drafted", "spec_accepted", "decode_steps")
    before = engine.stats()
    pa.reset_launches()
    t0 = time.perf_counter()
    handles = [engine.submit(p, n) for p, n in reqs]
    engine.run_until_idle()
    torch.cuda.synchronize()
    dur = time.perf_counter() - t0
    launches = pa.launches
    after = engine.stats()
    d = {k: after[k] - before[k] for k in keys}
    streams = []
    for (p, n), h in zip(reqs, handles):
        toks = h.result(timeout=5)
        if h.state != FINISHED or len(toks) != n:
            raise AssertionError("request ended {} with {} of {} tokens"
                                 .format(h.state, len(toks), n))
        streams.append(toks)
    k = engine.speculative_tokens
    draft_layers = (engine.draft_runner.model.cfg.num_layers
                    if engine.draft_runner is not None else 0)
    want = (d["spec_rounds"] * engine.num_layers
            + d["spec_rounds"] * k * draft_layers
            + d["decode_steps"] * engine.decode_horizon * engine.num_layers)
    if launches != want:
        raise AssertionError(
            "paged_decode launched {} times; {} verify calls x {} + {} draft "
            "steps x {} + {} decode calls x {} x {} = {}".format(
                launches, d["spec_rounds"], engine.num_layers,
                d["spec_rounds"] * k, draft_layers, d["decode_steps"],
                engine.decode_horizon, engine.num_layers, want))
    if engine.pool.pages_in_use:
        raise AssertionError("pages leaked: {}".format(
            engine.pool.pages_in_use))
    return streams, sum(n for _, n in reqs) / dur, launches, d


def _spec_engine(model, variables, reqs_warm, draft=None, k=0, **kw):
    """A warmed engine (one drained request a shape) with or without a
    draft ``(model, variables)``."""
    from tensorflowonspark_tpu_torch.serving import ServingEngine

    if draft is not None:
        kw.update(draft_model=draft[0], draft_variables=draft[1],
                  speculative_tokens=k)
    engine = ServingEngine(model, variables, device="cuda", **kw)
    for p, n in reqs_warm:
        engine.submit(p, n)
    engine.run_until_idle()
    return engine


def spec_phase(torch, pa, card):
    """Speculative decoding on the card: (a) ``bench_serving_speculative``'s
    latency regime, spec against baseline tok/s, the acceptance rate and the
    rounds, streams held against the baseline's teacher-forced; (b) the
    rollback path, a noise draft at 8 rows in bf16, f32 and over int8
    pools, against the same load without a draft; (c) in every run B4
    launched verify calls x 12 + draft steps x 2 (+ decode calls x 8 x 12
    without a draft) times, no page left. Returns B4's launches over the
    counted runs."""
    from tensorflowonspark_tpu_torch.models import decoding, factory
    from tensorflowonspark_tpu_torch.serving import PagePool

    t_phase = time.perf_counter()
    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device="cuda", seed=0, **SERVE_DEFAULT_LM)
    variables = decoding.serving_variables(model.state_dict(),
                                           torch.bfloat16)
    target_vars, draft, draft_vars = stem_sharing_pair(torch, model,
                                                       variables)
    vocab = model.cfg.vocab_size
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(1, vocab, size=p).astype(np.int32), n)
            for p, n in SPEC_SHAPES]
    warm = [(rs.randint(1, vocab, size=p).astype(np.int32), n)
            for p, n in SPEC_SHAPES]
    ps = SPEC_ENGINE["page_size"]
    per_req = PagePool.pages_needed(
        max(p + n for p, n in SPEC_SHAPES)
        + max(SPEC_ENGINE["decode_horizon"] - 1, SPEC_K), ps)
    num_pages = 1 + (per_req + 1) * SPEC_ENGINE["max_slots"]
    launches = 0
    runs = {}
    for name, pair in (("baseline", None), ("spec", (draft, draft_vars))):
        engine = _spec_engine(model, target_vars, warm, draft=pair, k=SPEC_K,
                              num_pages=num_pages, **SPEC_ENGINE)
        spans = _SpanWindow(pair is not None)
        streams, tok_s, n_b4, d = _spec_run(torch, pa, engine, reqs)
        spans.close()
        _spec_profile(torch, engine, card)
        engine.close()
        launches += n_b4
        runs[name] = (streams, tok_s, d)
        log("spec (a) {:8s}: 4 requests, 256 tokens, {:.1f} tok/s, rounds "
            "{} drafted {} accepted {} decode calls {}, B4 launches {}{} "
            "({})".format(name, tok_s, d["spec_rounds"], d["spec_drafted"],
                          d["spec_accepted"], d["decode_steps"], n_b4,
                          spans.text(), card))
    spec, base = runs["spec"], runs["baseline"]
    rate = spec[2]["spec_accepted"] / max(1, spec[2]["spec_drafted"])
    log("spec (a) latency regime (k {}, one slot, horizon 8): spec {:.1f} "
        "tok/s, baseline {:.1f} tok/s, speedup {:.3f}, acceptance rate "
        "{:.4f}, rounds {}; {} ({})".format(
            SPEC_K, spec[1], base[1], spec[1] / base[1], rate,
            spec[2]["spec_rounds"],
            _held(torch, model, "", reqs, spec[0], base[0]), card))
    del draft, draft_vars, target_vars
    launches += _spec_rollback(torch, pa, model, variables, card)
    del model, variables
    torch.cuda.empty_cache()
    log("spec phase {:.1f} s".format(time.perf_counter() - t_phase))
    return launches


def _spec_rollback(torch, pa, model, variables, card):
    """(b): a random-init draft at 8 rows, every case against the same
    load without a draft, both held against the baseline's teacher-forced
    paged steps."""
    from tensorflowonspark_tpu_torch.models import decoding, factory

    vocab = model.cfg.vocab_size
    rs = np.random.RandomState(1)
    reqs = [(rs.randint(1, vocab, size=int(rs.randint(16, 129))).astype(
        np.int32), 32) for _ in range(SPEC_ROLLBACK_ROWS)]
    warm = [(rs.randint(1, vocab, size=64).astype(np.int32), 32)]
    kw = dict(max_slots=SPEC_ROLLBACK_ROWS, page_size=64, decode_horizon=8,
              prefill_floor=32)
    launches = 0
    for name, dtype_name, kv in SPEC_ROLLBACK_CASES:
        dtype = getattr(torch, dtype_name)
        if dtype == torch.bfloat16:
            target, tvars = model, variables
        else:
            target = factory.get_model("transformer", dtype=dtype,
                                       device="cuda", seed=0,
                                       **SERVE_DEFAULT_LM)
            tvars = None
        draft = factory.get_model("gpt2-draft", dtype=dtype, device="cuda",
                                  seed=1, vocab_size=vocab)
        dvars = (decoding.serving_variables(draft.state_dict(), dtype)
                 if dtype == torch.bfloat16 else draft.state_dict())
        runs = {}
        for run, pair in (("baseline", None), ("spec", (draft, dvars))):
            engine = _spec_engine(target, tvars, warm, draft=pair,
                                  k=SPEC_ROLLBACK_K, kv_cache_dtype=kv, **kw)
            runs[run] = _spec_run(torch, pa, engine, reqs)
            engine.close()
            launches += runs[run][2]
        (spec, spec_tok_s, spec_b4, d), (base, base_tok_s, base_b4, _) = \
            runs["spec"], runs["baseline"]
        log("spec (b) rollback {:4s}: {} rows, k {}: rounds {} drafted {} "
            "accepted {}, B4 launches {} (= {} x {} + {} x 2) against "
            "baseline {}; {}; {:.1f} against {:.1f} tok/s ({})".format(
                name, SPEC_ROLLBACK_ROWS, SPEC_ROLLBACK_K, d["spec_rounds"],
                d["spec_drafted"], d["spec_accepted"], spec_b4,
                d["spec_rounds"], model.cfg.num_layers,
                d["spec_rounds"] * SPEC_ROLLBACK_K, base_b4,
                _held(torch, target, kv, reqs, spec, base), spec_tok_s,
                base_tok_s, card))
        if not d["spec_rounds"] or d["spec_accepted"] == d["spec_drafted"]:
            raise AssertionError("the noise draft's rounds did not roll "
                                 "back: {}".format(d))
        del draft, dvars
        if target is not model:
            del target
        torch.cuda.empty_cache()
    return launches


# -- the serving fleet plane --------------------------------------------------

# The fleet phase serves ``serve_default``'s model and load (24 requests,
# 12 slots, page 64, 49 pages, horizon 8) through the fleet plane.
FLEET_HTTP_REQUESTS = 4
FLEET_DRAIN_REQUESTS = 8
FLEET_WAVE = 8


def _fleet_load(vocab):
    """``bench_serving_continuous``'s 24 requests (as ``serve_default``)."""
    rs = np.random.RandomState(0)
    shapes = SERVE_DEFAULT_SHAPES
    return [(rs.randint(1, vocab, size=shapes[i % 4][0]).astype(np.int32),
             shapes[i % 4][1]) for i in range(24)]


def _finished_streams(handles, reqs, timeout=120.0):
    from tensorflowonspark_tpu_torch.serving import FINISHED

    out = []
    for h, (_, n) in zip(handles, reqs):
        toks = h.result(timeout=timeout)
        if h.state != FINISHED or len(toks) != n:
            raise AssertionError("request ended {} with {} of {} tokens"
                                 .format(h.state, len(toks), n))
        out.append(toks)
    return out


def _settle(*engines, timeout=60.0):
    """Wait until no engine has work or a handoff in flight (a handoff
    thread records its outcome after its stream may have ended)."""
    deadline = time.monotonic() + timeout
    while any(e.busy() for e in engines):
        if time.monotonic() > deadline:
            raise AssertionError("engines did not settle: {}".format(
                [e.stats() for e in engines]))
        time.sleep(0.002)


def _b4_check(launches, deltas, engines, what):
    """B4's launches over a run: decode calls x horizon x layers, summed
    over ``engines`` (``deltas``: each engine's decode calls in the run)."""
    want = sum(d * e.decode_horizon * e.num_layers
               for d, e in zip(deltas, engines))
    if launches != want:
        raise AssertionError("{}: paged_decode launched {} times; decode "
                             "calls {} x horizon x layers = {}".format(
                                 what, launches, deltas, want))


def _no_leaks(*engines):
    for e in engines:
        if e.pool.pages_in_use or e.busy():
            raise AssertionError("engine left work or pages: {}".format(
                e.stats()))


def _ledger_ok(e):
    s = e.stats()
    return (s["accepted"] + s["migrated_in"]
            == s["finished"] + s["cancelled"] + s["failed"]
            + s["migrated_out"])


def _pcts(values):
    return float(np.percentile(values, 50)), float(np.percentile(values, 95))


def _timed_handoffs(engine, sink):
    """Wrap a prefill engine's ``handoff_fn`` to record each hop's seconds:
    the interval the engine observes as ``serve_kv_transfer_seconds``."""
    inner = engine.handoff_fn

    def timed(req, payload):
        t0 = time.perf_counter()
        try:
            return inner(req, payload)
        finally:
            sink.append(time.perf_counter() - t0)
    engine.handoff_fn = timed


def _serve_threaded(torch, pa, submit, reqs, engines):
    """Submit ``reqs`` through ``submit`` to started ``engines`` and wait
    for every stream; B4's count set to 0 just before and read once the
    engines settled. Returns (streams, handles, launches, decode-call
    deltas)."""
    before = [e.decode_steps for e in engines]
    pa.reset_launches()
    handles = [submit(p, n) for p, n in reqs]
    streams = _finished_streams(handles, reqs)
    _settle(*engines)
    torch.cuda.synchronize()
    launches = pa.launches
    deltas = [e.decode_steps - b for e, b in zip(engines, before)]
    return streams, handles, launches, deltas


# The JAX attribution module's accounting check: a request's segments sum
# to its e2e within this share.
ATTRIBUTION_TOL = 0.1


def _attribution_check(telemetry, span_dir, handles, card):
    """(e): ``request_profile`` of every request of fleet (a)'s bf16
    disaggregated run over its span export, and ``window_attribution``'s
    tail."""
    import shutil

    from tensorflowonspark_tpu_torch.telemetry import attribution

    spans = telemetry.load_spans(span_dir)
    shutil.rmtree(span_dir, ignore_errors=True)
    traces = {h.trace for h in handles}
    mine = [s for s in spans if (s.get("attrs") or {}).get("trace")
            in traces]
    profiles = [attribution.request_profile(mine, h.trace)
                for h in handles]
    fracs = [p["accounted_frac"] if p else None for p in profiles]
    table = attribution.window_attribution(mine)
    seg = table.get("segments", {})
    log("fleet (e) attribution of (a)'s bf16 disaggregated run over its "
        "span export ({} spans): accounted share of e2e min {} max {} "
        "(limit 1 +/- {:g}); tail (e2e >= p95 cut {} ms, {} requests) "
        "dominant segment {}; tail means ms {}; on {}".format(
            len(mine), min(f for f in fracs if f is not None)
            if any(f is not None for f in fracs) else None,
            max(f for f in fracs if f is not None)
            if any(f is not None for f in fracs) else None,
            ATTRIBUTION_TOL, table.get("e2e_cut_ms"),
            table.get("tail_requests"), table.get("dominant"),
            {k: v["tail_mean_ms"] for k, v in seg.items()}, card))
    bad = [f for f in fracs if f is None or abs(f - 1.0) > ATTRIBUTION_TOL]
    if bad or table.get("requests") != len(handles):
        raise AssertionError("fleet (e): {} of {} requests outside the "
                             "accounting tolerance: {}".format(
                                 len(bad), len(handles), fracs))


def _dashboard_check(telemetry, store, port, card):
    """(e): ``/dashboard``, ``/timeseries`` and ``/traces`` of fleet (b)'s
    server answer 200 over its store, fed three beats of this process's
    ``node_stats()``."""
    import urllib.request

    for _ in range(3):
        store.ingest("driver", telemetry.node_stats())
    answers = {}
    for path in ("/dashboard", "/timeseries",
                 "/timeseries?metric=serve_ttft_ms_p95", "/traces"):
        with urllib.request.urlopen("http://127.0.0.1:{}{}".format(
                port, path), timeout=60) as resp:
            answers[path] = (resp.status, resp.read())
    slowest = json.loads(answers["/traces"][1])["slowest"]
    log("fleet (e) MetricsServer over a history store: {}; /traces lists "
        "{} requests; on {}".format(
            ", ".join("GET {} {} ({} bytes)".format(p, a[0], len(a[1]))
                      for p, a in answers.items()), len(slowest), card))
    if any(a[0] != 200 for a in answers.values()) or not slowest:
        raise AssertionError("fleet (e): {}".format(
            {p: a[0] for p, a in answers.items()}))


def fleet_phase(torch, pa, card):
    """The serving fleet plane at ``serve_default``'s geometry: (a) a
    prefill-role and a decode-role engine behind ``ServingFleet`` against
    one colocated engine, bf16 and int8 pools; (b) the decode engine
    behind a ``MetricsServer``, the pages crossing ``POST /v1/migrate``;
    (c) a drain with ``migrate_requests`` between two stepped engines;
    (d) the ``Autoscaler`` from 1 replica to 2 and back through a drain;
    (e) (a)'s bf16 run's latency attribution over its span export, and
    (b)'s server's dashboard routes over a history store. Returns B4's
    launches over the phase."""
    import tempfile

    from tensorflowonspark_tpu_torch import (serving, telemetry,
                                             telemetry_store)
    from tensorflowonspark_tpu_torch.models import decoding, factory
    from tensorflowonspark_tpu_torch.train.metrics import MetricsServer

    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device="cuda", seed=0, **SERVE_DEFAULT_LM)
    variables = decoding.serving_variables(model.state_dict(),
                                           torch.bfloat16)
    reqs = _fleet_load(model.cfg.vocab_size)
    launches = 0
    colocated = {}
    keep = {}
    # -- (a) disaggregated in process, against colocated ---------------------
    for kv in ("", "int8"):
        pool = kv or "bf16"
        colo = default_engine(model, variables, kv_cache_dtype=kv).start()
        want, handles, n, deltas = _serve_threaded(
            torch, pa, colo.submit, reqs, [colo])
        _b4_check(n, deltas, [colo], "colocated " + pool)
        _no_leaks(colo)
        colo.close()
        launches += n
        colocated[kv] = want
        colo_ttft = _pcts([h.ttft * 1e3 for h in handles])
        pre = default_engine(model, variables, kv_cache_dtype=kv,
                             role="prefill")
        dec = default_engine(model, variables, kv_cache_dtype=kv,
                             role="decode")
        fleet = serving.ServingFleet([pre, dec])
        hops = []
        _timed_handoffs(pre, hops)
        fleet.start()
        out0, bytes0 = pre.handoffs_out, pre.handoff_bytes
        span_dir = None
        if not kv:  # the bf16 run's spans, exported for (e)
            span_dir = tempfile.mkdtemp(prefix="tfos-fleet-spans-")
            telemetry.configure(node_id="driver", export_dir=span_dir,
                                capacity=16384)
        try:
            got, handles, n, deltas = _serve_threaded(
                torch, pa, fleet.submit, reqs, [pre, dec])
        finally:
            if span_dir is not None:
                telemetry.disable()
        if span_dir is not None:
            _attribution_check(telemetry, span_dir, handles, card)
        launches += n
        out = pre.handoffs_out - out0
        if deltas[0] or out != len(reqs) or pre.handoff_fallbacks:
            raise AssertionError(
                "disaggregated {}: prefill engine decode calls {}, handoffs "
                "{} of {}, fallbacks {}".format(pool, deltas[0], out,
                                                len(reqs),
                                                pre.handoff_fallbacks))
        _b4_check(n, deltas, [pre, dec], "disaggregated " + pool)
        _no_leaks(pre, dec)
        if not (_ledger_ok(pre) and _ledger_ok(dec)):
            raise AssertionError("disaggregated {}: ledger {} / {}".format(
                pool, pre.stats(), dec.stats()))
        if got != want:
            bad = sum(a != b for a, b in zip(got, want))
            raise AssertionError("disaggregated {}: {} of {} streams differ "
                                 "from the colocated engine's".format(
                                     pool, bad, len(reqs)))
        ttft = _pcts([h.ttft * 1e3 for h in handles])
        per_req = (pre.handoff_bytes - bytes0) / len(reqs)
        log("fleet (a) pool {:4s}: 24 requests through prefill + decode "
            "engines bitwise the colocated engine's; handoffs {} fallbacks 0;"
            " B4 launches {} (decode engine's {} calls x 8 x {}, prefill "
            "engine 0 calls); handoff {:.0f} bytes a request; kv transfer "
            "(handoff_fn, in process) median {:.3f} ms; TTFT p50/p95 "
            "disaggregated {:.2f}/{:.2f} ms, colocated {:.2f}/{:.2f} ms ({})"
            .format(pool, out, n, deltas[1], dec.num_layers, per_req,
                    float(np.median(hops)) * 1e3, ttft[0], ttft[1],
                    colo_ttft[0], colo_ttft[1], card))
        if kv:
            fleet.close()
        else:
            keep = dict(pre=pre, dec=dec, fleet=fleet)
    # -- (b) the HTTP hop ------------------------------------------------------
    pre, dec = keep["pre"], keep["dec"]
    # (e): the server also holds a history store fed from this process's
    # node_stats(), for the dashboard routes.
    store = telemetry_store.TelemetryStore()
    server = MetricsServer(engine=dec, store=store)
    server.start()
    try:
        pre.handoff_fn = None                # the new fleet wires its own
        # (a) left these prompts' pages in the prefill engine's prefix
        # index: a match would prefill only their tails (other GEMM
        # shapes, other bf16 roundings). Purged, they prefill whole, as
        # in (a).
        pre.pool.purge_index()
        remote = serving.RemoteEngine(
            "http://127.0.0.1:{}".format(server.port), name="decode-http",
            role="decode")
        fleet = serving.ServingFleet([pre, remote])
        hops = []
        _timed_handoffs(pre, hops)
        sub = reqs[:FLEET_HTTP_REQUESTS]
        out0, in0 = pre.handoffs_out, dec.handoffs_in
        got, _, n, deltas = _serve_threaded(torch, pa, fleet.submit, sub,
                                            [pre, dec])
        launches += n
        if (deltas[0] or pre.handoffs_out - out0 != len(sub)
                or dec.handoffs_in - in0 != len(sub)
                or pre.handoff_fallbacks):
            raise AssertionError(
                "HTTP hop: prefill decode calls {}, handoffs out {} in {}, "
                "fallbacks {}".format(deltas[0], pre.handoffs_out - out0,
                                      dec.handoffs_in - in0,
                                      pre.handoff_fallbacks))
        _b4_check(n, deltas, [pre, dec], "HTTP hop")
        _no_leaks(pre, dec)
        if got != colocated[""][:len(sub)]:
            raise AssertionError("HTTP hop: streams differ from (a)'s")
        log("fleet (b) {} requests over POST /v1/migrate: streams equal "
            "(a)'s; B4 launches {} (decode calls {} x 8 x {}); kv transfer "
            "(handoff_fn: POST, restore queued, ack) median {:.3f} ms ({})"
            .format(len(sub), n, deltas[1], dec.num_layers,
                    float(np.median(hops)) * 1e3, card))
        _dashboard_check(telemetry, store, server.port, card)
    finally:
        server.stop()
        keep["fleet"].close()
    # -- (c) drain and migration -------------------------------------------------
    a = default_engine(model, variables)
    b = default_engine(model, variables)
    restore_s = []
    restore = b.runner.restore_pages

    def timed_restore(tree, pages):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(tree, pages)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
    b.runner.restore_pages = timed_restore
    sub = reqs[:FLEET_DRAIN_REQUESTS]
    before = [a.decode_steps, b.decode_steps]
    pa.reset_launches()
    handles = [a.submit(p, n) for p, n in sub]
    while not all(h.state == serving.RUNNING and h._req.generated
                  for h in handles):
        a.step()
    pages = sum(a.pool.required(h._req.cache_len) for h in handles)
    a.begin_drain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moved = a.migrate_requests(b)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    if len(moved) != len(sub) or not a.is_drained():
        raise AssertionError("drain: moved {} of {}, drained {}".format(
            len(moved), len(sub), a.is_drained()))
    b.run_until_idle()
    torch.cuda.synchronize()
    n = pa.launches
    deltas = [a.decode_steps - before[0], b.decode_steps - before[1]]
    launches += n
    got = _finished_streams(handles, sub)
    _b4_check(n, deltas, [a, b], "drain")
    _no_leaks(a, b)
    sa, sb = a.stats(), b.stats()
    if not (_ledger_ok(a) and _ledger_ok(b)) or sa["migrated_out"] != \
            len(sub) or sb["migrated_in"] != len(sub) or \
            sb["preempt_recomputes"]:
        raise AssertionError("drain ledger: {} / {}".format(sa, sb))
    if got != colocated[""][:len(sub)]:
        raise AssertionError("drain: migrated streams differ from the "
                             "undisturbed run's")
    b.runner.restore_pages = restore
    a.close()
    log("fleet (c) drain: {} residents migrated ({} pages) bitwise the "
        "undisturbed run's, ledgers balanced, source drained; migration "
        "{:.3f} ms a page (extract {:.3f} + restore {:.3f}); B4 launches {} "
        "(decode calls {} x 8 x {}) ({})".format(
            len(moved), pages, (extract_s + sum(restore_s)) / pages * 1e3,
            extract_s / pages * 1e3, sum(restore_s) / pages * 1e3, n, deltas,
            b.num_layers, card))
    # -- (d) the autoscaler ---------------------------------------------------
    b.pool.purge_index()                     # as in (b): whole prefills
    fleet = serving.ServingFleet([b])
    spawned = []

    def spawn(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = default_engine(model, variables)
        torch.cuda.synchronize()
        spawned.append((eng, time.perf_counter() - t0))
        return eng

    scaler = serving.Autoscaler(fleet, store=None, spawn_fn=spawn,
                                policy=serving.AutoscalePolicy(
                                    queue_high=4.0, max_replicas=2,
                                    cooldown_up_s=1.0, cooldown_down_s=5.0,
                                    stable_down_s=2.0, drain_grace_s=1.0))
    first, wave = reqs[:FLEET_WAVE], reqs[FLEET_WAVE:2 * FLEET_WAVE]
    b_before = b.decode_steps
    pa.reset_launches()
    handles = [fleet.submit(p, n) for p, n in first]
    if scaler.step(now=0.0) != "scale_up" or len(fleet.engines) != 2:
        raise AssertionError("autoscaler: no scale-up at 8 queued requests")
    new = spawned[0][0]
    fleet.run_until_idle()
    handles += [fleet.submit(p, n) for p, n in wave]
    for eng in (b, new):
        eng.step()
        eng.step()
    if not all(e.scheduler.active() for e in (b, new)):
        raise AssertionError("autoscaler: the second wave did not spread")
    if scaler.step(now=10.0) is not None:
        raise AssertionError("autoscaler: scaled at the quiet clock's start")
    t0 = time.perf_counter()
    if scaler.step(now=13.0) != "scale_down":
        raise AssertionError("autoscaler: no scale-down when quiet")
    drain = scaler.drains[0]
    scaler.step(now=14.5)
    drain_s = time.perf_counter() - t0
    if scaler.drains or len(fleet.engines) != 1:
        raise AssertionError("autoscaler: the drain did not finish")
    fleet.run_until_idle()
    torch.cuda.synchronize()
    n = pa.launches
    launches += n
    got = _finished_streams(handles, first + wave)
    survivor = fleet.engines[0].engine
    victim = drain.engine
    deltas = [b.decode_steps - b_before, new.decode_steps]
    _b4_check(n, deltas, [b, new], "autoscaler")
    (audit,) = scaler.drain_audits
    st = scaler.stats()
    if not audit["ok"] or audit["migrated"] < 1 or st["scale_ups"] != 1 \
            or st["scale_downs"] != 1 or st["replicas"] != 1:
        raise AssertionError("autoscaler: audit {} stats {}".format(audit,
                                                                    st))
    if got != colocated[""][:2 * FLEET_WAVE]:
        raise AssertionError("autoscaler: streams differ from the "
                             "colocated run's")
    _no_leaks(survivor)
    survivor.close()
    if victim is not survivor:
        victim.close()
    log("fleet (d) autoscaler: 1 -> 2 replicas at 8 queued requests, back "
        "to 1 through a drain ({} migrated), ledger audit balanced with 0 "
        "failed or cancelled; streams equal the colocated run's; B4 "
        "launches {} (decode calls {} x 8 x {}); scale-up {:.3f} s (build "
        "+ warm); drain {:.3f} s (scale-down decision to drain done, "
        "migration included) ({})".format(
            audit["migrated"], n, deltas, b.num_layers, spawned[0][1],
            drain_s, card))
    del model, variables
    torch.cuda.empty_cache()
    return launches


def device_kernels(prof):
    """``({name: device ms}, count)`` of the device activities in a
    profiler window, leaving out user annotations (the optimizer's
    ``Optimizer.step`` range is one), which span kernels already counted."""
    by_name = {}
    count = 0
    for ev in prof.events():
        if (str(getattr(ev, "device_type", "")).endswith("CUDA")
                and not getattr(ev, "is_user_annotation", False)):
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (
                ev.self_device_time_total / 1e3)
            count += 1
    return by_name, count


def profile_decode(torch, model, variables, steps=10):
    """Where a steady decode step's time goes: 8 resident rows. Host time
    per step unprofiled, then one ``torch.profiler`` window whose wall
    time and device kernels (busy time, launches, the largest kernels)
    give the idle share: 1 - busy / wall, both of that window."""
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_tpu_torch.serving import RUNNING, ServingEngine

    engine = ServingEngine(model, variables, max_slots=8, page_size=128,
                           decode_horizon=1, prefix_share=False,
                           preempt="off", device="cuda")
    rs = np.random.RandomState(3)
    handles = [engine.submit(rs.randint(1, model.cfg.vocab_size,
                                        size=int(rs.randint(32, 513))), 200)
               for _ in range(8)]
    while not all(h.state == RUNNING for h in handles):
        engine.step()
    for _ in range(5):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2 * steps):
        engine.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / (2 * steps) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) / steps * 1e3
    engine.close()
    by_name, count = device_kernels(prof)
    busy_ms = sum(by_name.values()) / steps
    b4_ms = sum(ms for name, ms in by_name.items()
                if "paged_decode" in name) / steps
    log("profile decode step (8 rows, bf16 pool): host {:.3f} ms/step "
        "unprofiled; profiled window {:.3f} ms/step, device busy {:.3f} "
        "ms/step, idle share {:.3f}, {:.0f} device kernels/step; B4 "
        "paged_decode {:.4f} ms/step ({:.1%} of device busy)".format(
            host_ms, window_ms, busy_ms, 1.0 - busy_ms / window_ms,
            count / steps, b4_ms, b4_ms / busy_ms))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log("profile   {:7.4f} ms/step {:5.1%}  {}".format(
            ms / steps, ms / steps / busy_ms, name[:90]))


# -- training ------------------------------------------------------------------

GRAD_NORM_PARAMS = ("embed.embedding", "block_0.attn.qkv.kernel",
                    "block_5.mlp.up.kernel", "block_11.attn.out.kernel",
                    "ln_f.scale")
# ``examples/transformer/train_lm.py``'s model (its defaults: vocab 512, 4
# layers, 8 heads of width 32, embed 256, MLP 512) at the training phase's
# b8 x s1024; the parameters whose gradient norms step 1 compares.
TRAIN_LM = dict(vocab_size=512, num_layers=4, num_heads=8, embed_dim=256,
                mlp_dim=512, max_seq_len=1024, remat=False)
TRAIN_LM_NORM_PARAMS = ("embed.embedding", "block_0.attn.qkv.kernel",
                        "block_2.mlp.up.kernel", "block_3.attn.out.kernel",
                        "ln_f.scale")


def lm_batch(batch, seq, vocab, packed=False):
    """``bench.py``'s ``_lm_trainer`` batch: seeded tokens as inputs and
    labels, optionally with its packed segment layout."""
    tokens = np.random.RandomState(0).randint(
        1, vocab, size=(batch, seq)).astype(np.int32)
    b = {"x": tokens, "y": tokens}
    if packed:
        b["segment_ids"] = lm_segments(batch, seq)
    return b


def grad_norms(state, names=GRAD_NORM_PARAMS):
    return {n: float(state.params[n].grad.float().norm()) for n in names}


def train_step_counted(torch, fa, tr, state, batch):
    """One step; returns (state, loss, launches of each flash kernel in
    it, host seconds to the loss on the host)."""
    before = dict(fa.launches)
    t0 = time.perf_counter()
    state, m = tr.train_step(state, batch)
    loss = float(m["loss"])
    sec = time.perf_counter() - t0
    return state, loss, {n: fa.launches[n] - before[n]
                         for n in fa.launches}, sec


def training_phase(torch, fa, pa, card):
    """The main training path: returns the flash kernels' launches over its
    four steps."""
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    kw = dict(GPT2_SMALL, attention_impl="pallas")
    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device="cuda", seed=0, **kw)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, optimizer=trainer.adamw(3e-4), device="cuda")
    state = tr.init()
    batch = lm_batch(8, 1024, GPT2_SMALL["vocab_size"])
    per_layer = dict.fromkeys(fa.launches, GPT2_SMALL["num_layers"])
    losses, secs = [], []
    fa.reset_launches()
    pa.reset_launches()
    for i in range(4):
        state, loss, counts, sec = train_step_counted(torch, fa, tr, state,
                                                      batch)
        if i == 0:
            norms = grad_norms(state)
        losses.append(loss)
        secs.append(sec)
        if counts != per_layer:
            raise AssertionError("train step {} launched {}; want {} per "
                                 "step".format(i, counts, per_layer))
    launches = dict(fa.launches)
    if pa.launches:
        raise AssertionError("a train step launched paged_decode")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("losses not finite and falling: {}".format(
            losses))
    step_ms = float(np.median(secs[1:])) * 1e3
    log("train  GPT-2-small b8 s1024 bf16 pallas adamw(3e-4): losses {} "
        "launches/step {}; step {:.2f} ms median of steps 2-4, {:.0f} "
        "tokens/s on {}".format(["{:.4f}".format(x) for x in losses],
                                per_layer, step_ms,
                                8 * 1024 / step_ms * 1e3, card))

    state, loss, counts, _ = train_step_counted(
        torch, fa, tr, state,
        lm_batch(8, 1024, GPT2_SMALL["vocab_size"], packed=True))
    if counts != per_layer or not np.isfinite(loss):
        raise AssertionError("packed step: loss {} launches {}".format(
            loss, counts))
    log("train  packed step (2 documents/row, padded last eighth): loss "
        "{:.4f} launches {}".format(loss, counts))

    profile_train_step(torch, tr, state, batch)

    dense_step1(torch, fa, kw, initial, batch, losses[0], norms,
                GRAD_NORM_PARAMS, "GPT-2-small")

    # Full-block remat: each block's forward runs again in the backward.
    rtr = Trainer(model, optimizer=trainer.adamw(3e-4), remat=True,
                  device="cuda")
    _, loss, counts, _ = train_step_counted(torch, fa, rtr, rtr.init(),
                                            batch)
    want = dict(per_layer, flash_fwd=2 * GPT2_SMALL["num_layers"])
    if counts != want or not np.isfinite(loss):
        raise AssertionError("remat step: loss {} launches {}, want "
                             "{}".format(loss, counts, want))
    log("train  remat step: loss {:.4f} launches {}".format(loss, counts))
    del model, tr, rtr, state
    torch.cuda.empty_cache()
    train_lm_step1(torch, fa)
    return launches, step_ms


def dense_step1(torch, fa, kw, initial, batch, loss, norms, names, label):
    """Step 1 through the dense attention route from the flash step's
    initial weights on its batch, against the flash step's loss and
    gradient norms (of ``names``)."""
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    dense = factory.get_model("transformer", dtype=torch.bfloat16,
                              device="cuda", seed=0,
                              **dict(kw, attention_impl="dense"))
    dense.load_state_dict(initial)
    dtr = Trainer(dense, optimizer=trainer.adamw(3e-4), device="cuda")
    dstate, dloss, dcounts, _ = train_step_counted(torch, fa, dtr,
                                                   dtr.init(), batch)
    dnorms = grad_norms(dstate, names)
    if any(dcounts.values()):
        raise AssertionError("the dense route launched {}".format(dcounts))
    rel = abs(loss - dloss) / abs(dloss)
    norm_rel = {n: abs(norms[n] - dnorms[n]) / dnorms[n] for n in norms}
    log("train  {} step 1 flash vs dense: loss {:.6f} vs {:.6f} (rel "
        "{:.2e}, limit {:g}); grad-norm rel diffs {} (limit {:g})".format(
            label, loss, dloss, rel, TRAIN_LOSS_RTOL,
            {n: "{:.2e}".format(v) for n, v in norm_rel.items()},
            TRAIN_GRAD_NORM_RTOL))
    if not rel <= TRAIN_LOSS_RTOL or not all(
            v <= TRAIN_GRAD_NORM_RTOL for v in norm_rel.values()):
        raise AssertionError("{}: flash and dense step 1 disagree".format(
            label))
    del dense, dtr, dstate
    torch.cuda.empty_cache()


def train_lm_step1(torch, fa):
    """Step 1 of ``examples/transformer/train_lm.py``'s model (head width
    32) at b8 x s1024 bf16 through the flash route, each flash kernel
    launched once a layer, against the dense route."""
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    kw = dict(TRAIN_LM, attention_impl="pallas")
    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device="cuda", seed=0, **kw)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, optimizer=trainer.adamw(3e-4), device="cuda")
    batch = lm_batch(8, 1024, TRAIN_LM["vocab_size"])
    state, loss, counts, _ = train_step_counted(torch, fa, tr, tr.init(),
                                                batch)
    want = dict.fromkeys(fa.launches, TRAIN_LM["num_layers"])
    if counts != want or not np.isfinite(loss):
        raise AssertionError("train_lm step: loss {} launches {}, want "
                             "{}".format(loss, counts, want))
    log("train  train_lm geometry (d{}) b8 s1024 bf16 pallas: loss {:.4f} "
        "launches {}".format(model.cfg.head_dim, loss, counts))
    norms = grad_norms(state, TRAIN_LM_NORM_PARAMS)
    del model, tr, state
    dense_step1(torch, fa, kw, initial, batch, loss, norms,
                TRAIN_LM_NORM_PARAMS, "train_lm d32")


def profile_train_step(torch, tr, state, batch, steps=2,
                       label="b8 s1024 bf16", top_ops=0):
    """Where a training step's time goes: one ``torch.profiler`` window
    over ``steps`` steps; device busy time against the window's wall time,
    and the largest device kernels; with ``top_ops``, also the operators
    whose kernels take the most device time (self time: an operator's own
    kernels, not its children's)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = tr.train_step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) / steps * 1e3
    by_name, count = device_kernels(prof)
    busy_ms = sum(by_name.values()) / steps
    log("profile train step ({}): profiled window {:.3f} "
        "ms/step, device busy {:.3f} ms/step, idle share {:.3f}, {:.0f} "
        "device kernels/step".format(label, window_ms, busy_ms,
                                     1.0 - busy_ms / window_ms,
                                     count / steps))
    flash_ms = sum(ms for name, ms in by_name.items()
                   if "flash_" in name) / steps
    if flash_ms:
        log("profile   flash kernels (B1-B3) {:.4f} ms/step, {:.1%} of device "
            "busy".format(flash_ms, flash_ms / busy_ms))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log("profile   {:8.4f} ms/step {:5.1%}  {}".format(
            ms / steps, ms / steps / busy_ms, name[:90]))
    ops = sorted(((ev.key, ev.self_device_time_total / 1e3 / steps)
                  for ev in prof.key_averages()
                  if ev.key.startswith("aten::")), key=lambda kv: -kv[1])
    for name, ms in ops[:top_ops]:
        log("profile   op {:8.4f} ms/step {:5.1%}  {}".format(
            ms, ms / busy_ms, name))


# -- the main path whole: fit, commit, restore, serve -------------------------

# Greedy engine streams against solo ``generate`` in bf16: the engine's B4
# walk and the solo path's dense cache attention round in other places, so
# a token may differ where solo's top two logits lie within this many bf16
# steps (of the larger) of each other; that stream's comparison stops there.
BF16_NEAR_TIE_ULPS = 4


def bf16_ulp(x):
    """The spacing of bf16 values at ``x`` (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def _moments(state):
    return state.optimizer.state_dict()["state"]


def _equal(x, y):
    """``torch.equal`` across devices."""
    return bool(x.equal(y)) if x.device == y.device else bool(
        x.cpu().equal(y.cpu()))


def _states_differ(a, b):
    """Names of the parameters and AdamW moments that differ."""
    bad = [n for n in a.params if not _equal(a.params[n], b.params[n])]
    ma, mb = _moments(a), _moments(b)
    bad += ["moment {} {}".format(i, k) for i in ma for k in ma[i]
            if not _equal(ma[i][k], mb[i][k])]
    return bad


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, n))
               for root, _, names in os.walk(path) for n in names)


def _serve_greedy(torch, model, variables, reqs, pa):
    """Greedy streams of ``reqs`` through a bf16-pool engine over
    ``variables``; returns (streams, B4 launches, decode steps)."""
    from tensorflowonspark_tpu_torch.serving import FINISHED, ServingEngine

    engine = ServingEngine(model, variables, max_slots=8, page_size=128,
                           decode_horizon=1, prefix_share=False,
                           preempt="off", device="cuda")
    pa.reset_launches()
    handles = [engine.submit(p, n) for p, n in reqs]
    engine.run_until_idle()
    torch.cuda.synchronize()
    launches, steps = pa.launches, engine.decode_steps
    streams = []
    for (p, n), h in zip(reqs, handles):
        toks = h.result(timeout=5)
        if h.state != FINISHED or len(toks) != n:
            raise AssertionError("request ended {} with {} of {} tokens"
                                 .format(h.state, len(toks), n))
        streams.append(toks)
    if engine.pool.pages_in_use:
        raise AssertionError("pages leaked: {}".format(
            engine.pool.pages_in_use))
    engine.close()
    return streams, launches, steps


def _teacher_forced(torch, reqs, streams, start, step, what):
    """Each stream against a model teacher-forced on the stream's own
    tokens: ``start(p, n)`` gives the logits after prompt ``p`` (``n``
    tokens to follow), ``step(tok, pos)`` those after ``tok`` at position
    ``pos``. A stream stops at its first difference, which must be a near
    tie (the top two logits within ``BF16_NEAR_TIE_ULPS`` bf16 steps).
    Returns (tokens compared, near-tie stops, largest gap at a stop in
    bf16 steps)."""
    compared = stops = 0
    worst = 0.0
    with torch.no_grad():
        for (p, n), toks in zip(reqs, streams):
            logits = start(p, n)
            for j, tok in enumerate(toks):
                want = int(torch.argmax(logits))
                compared += 1
                if want != tok:
                    top2 = torch.topk(logits, 2).values
                    top, second = float(top2[0]), float(top2[1])
                    ulps = (top - second) / bf16_ulp(top)
                    if ulps > BF16_NEAR_TIE_ULPS:
                        raise AssertionError(
                            "served stream differs from {} at step {}: "
                            "engine {}, {} {} (top-2 gap {} = {:.1f} bf16 "
                            "steps)".format(what, j, tok, what, want,
                                            top - second, ulps))
                    stops += 1
                    worst = max(worst, ulps)
                    break
                if j + 1 < len(toks):
                    logits = step(tok, len(p) + j)
    return compared, stops, worst


def _solo_teacher_forced(torch, model, reqs, streams):
    """Each engine stream against solo decode teacher-forced on the
    engine's own tokens (what solo ``generate`` computes up to the first
    difference); see :func:`_teacher_forced`."""
    from tensorflowonspark_tpu_torch.models import decoding

    cache = {}

    def start(p, n):
        cache.clear()
        cache.update(decoding.init_cache(
            model, 1, decoding._bucketed_cache_len(
                len(p) + n, model.cfg.max_seq_len)))
        return model(torch.as_tensor(p[None], device=model.device).long(),
                     decode=True, cache=cache)[0, -1].float()

    def step(tok, pos):
        return model(torch.tensor([[tok]], device=model.device),
                     decode=True, cache=cache)[0, -1].float()

    return _teacher_forced(torch, reqs, streams, start, step, "solo")


def whole_path_phase(torch, fa, pa, card, plain_step_ms):
    """The main path whole at GPT-2-small width: ``Trainer.fit`` over host
    batches (``DevicePrefetch`` copies them; B1-B3 12 launches each a
    step) with a checkpoint every 2 steps; the commit; a bitwise resume of
    step 5 by a fresh trainer restored from the checkpoint; serving from
    ``restore_variables`` (B4 every decode step) against solo ``generate``
    and against the live weights' streams; an async save that two more
    steps must not reach; then ``fit``'s step time."""
    import shutil
    import tempfile

    from tensorflowonspark_tpu_torch.models import decoding, factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train import checkpoint as ckpt_lib
    from tensorflowonspark_tpu_torch.train.checkpoint import (
        CheckpointManager)

    kw = dict(GPT2_SMALL, attention_impl="pallas")
    vocab, layers = GPT2_SMALL["vocab_size"], GPT2_SMALL["num_layers"]
    per_layer = dict.fromkeys(fa.launches, layers)
    batch = lm_batch(8, 1024, vocab)
    # Step 5's batch: another seeded draw, the same for both trainers.
    batch5 = {"x": np.random.RandomState(5).randint(
        1, vocab, size=(8, 1024)).astype(np.int32)}
    batch5["y"] = batch5["x"]

    def host_batches(n):
        # CPU (numpy) batches: DevicePrefetch makes every copy to the card.
        for _ in range(n):
            yield {k: v.copy() for k, v in batch.items()}

    def make(seed):
        model = factory.get_model("transformer", dtype=torch.bfloat16,
                                  device="cuda", seed=seed, **kw)
        tr = Trainer(model, optimizer=trainer.adamw(3e-4), device="cuda")
        return model, tr, tr.init()

    root = tempfile.mkdtemp(prefix="tfos-whole-path-")
    try:
        ckdir = os.path.join(root, "ckpt")
        model, tr, state = make(0)
        mgr = CheckpointManager(ckdir, max_to_keep=2)

        # Per-step launch counts, and proof that fit's batches arrive on
        # the card already placed.
        counts, on_card = [], []
        plain_step = tr.train_step

        def counted_step(state, batch):
            on_card.append(all(v.is_cuda for v in batch.values()))
            before = dict(fa.launches)
            out = plain_step(state, batch)
            counts.append({n: fa.launches[n] - before[n]
                           for n in fa.launches})
            return out

        save_secs = []
        plain_save = mgr.save

        def timed_save(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            saved = plain_save(*args, **kwargs)
            if saved:
                save_secs.append(time.perf_counter() - t0)
            return saved

        tr.train_step, mgr.save = counted_step, timed_save
        fa.reset_launches()
        pa.reset_launches()
        state, history = tr.fit(state, host_batches(4), steps=4,
                                flush_every=2, checkpoint=mgr,
                                checkpoint_every=2)
        del tr.train_step, mgr.save  # back to the methods
        losses = [h["loss"] for h in history]
        if [h["step"] for h in history] != [0, 1, 2, 3] or not (
                all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError("fit history {}".format(history))
        if counts != [per_layer] * 4 or not all(on_card):
            raise AssertionError("fit steps launched {} (want {} each); "
                                 "batches on the card {}".format(
                                     counts, per_layer, on_card))
        if pa.launches:
            raise AssertionError("fit launched paged_decode")
        log("whole  fit GPT-2-small b8 s1024 bf16 pallas adamw(3e-4), 4 "
            "steps over CPU batches (DevicePrefetch), flush_every 2, "
            "checkpoint_every 2: losses {}; launches/step {}".format(
                ["{:.4f}".format(x) for x in losses], counts[0]))

        # The commit: step 4 committed, every retained step's manifest
        # matching its files.
        if ckpt_lib.latest_committed_step(ckdir) != 4 or \
                mgr.latest_committed_step() != 4:
            raise AssertionError("latest committed step {} != 4".format(
                ckpt_lib.latest_committed_step(ckdir)))
        retained = sorted(int(n) for n in os.listdir(ckdir) if n.isdigit())
        for step in retained:
            with open(os.path.join(ckdir, ckpt_lib._marker_name(step))) as f:
                doc = json.load(f)
            if doc != {"step": step, "files": ckpt_lib._step_manifest(
                    os.path.join(ckdir, str(step)))}:
                raise AssertionError("step {}'s manifest does not "
                                     "validate".format(step))
        step_dir = os.path.join(ckdir, "4")
        step_bytes = _dir_bytes(step_dir)
        var_bytes = sum(os.path.getsize(os.path.join(
            step_dir, ckpt_lib.ITEM, name))
            for name in (ckpt_lib.PARAMS, ckpt_lib.MODEL_STATE))
        live4 = decoding.serving_variables(model.state_dict(),
                                           torch.bfloat16)
        log("whole  committed step 4; retained steps {} (max_to_keep 2), "
            "manifests valid; step dir {} bytes, restore_variables reads {} "
            "bytes; save blocked fit {} s (synchronous, steps 2 and 4) on "
            "{}".format(retained, step_bytes, var_bytes,
                        ["{:.3f}".format(x) for x in save_secs], card))

        # Resume, bitwise: the live trainer and a fresh one restored from
        # the checkpoint each take step 5 on the same batch.
        state, live_loss, _, _ = train_step_counted(torch, fa, tr, state,
                                                    batch5)
        model2, tr2, state2 = make(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state2 = CheckpointManager(ckdir, max_to_keep=2).restore(state2)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if state2.step != 4:
            raise AssertionError("restored step {}".format(state2.step))
        state2, resumed_loss, _, _ = train_step_counted(torch, fa, tr2,
                                                        state2, batch5)
        differ = _states_differ(state, state2)
        if live_loss != resumed_loss or state.step != state2.step or differ:
            raise AssertionError(
                "resumed step 5 differs: loss {} vs {}, {} tensors differ "
                "(first {})".format(live_loss, resumed_loss, len(differ),
                                    differ[:3]))
        log("whole  resume: step 5 of the live and of the restored trainer "
            "bitwise equal (loss {:.6f}, {} parameters, {} AdamW state "
            "tensors); restore {:.3f} s on {}".format(
                live_loss, len(state.params),
                sum(len(m) for m in _moments(state).values()), restore_s,
                card))
        del model2, tr2, state2
        torch.cuda.empty_cache()

        # Serve from the committed checkpoint.
        t0 = time.perf_counter()
        restored = CheckpointManager(ckdir,
                                     max_to_keep=2).restore_variables()
        restore_vars_s = time.perf_counter() - t0
        served = decoding.serving_variables(restored, torch.bfloat16)
        bad = [k for k in live4 if not _equal(live4[k], served[k])]
        if served.keys() != live4.keys() or bad:
            raise AssertionError("restored variables differ from the live "
                                 "step-4 weights: {}".format(bad[:3]))
        smodel = factory.get_model("transformer", dtype=torch.bfloat16,
                                   device="cuda", seed=2, **GPT2_SMALL)
        decoding.load_variables(smodel, served)
        rs = np.random.RandomState(11)
        reqs = [(rs.randint(1, vocab, size=int(rs.randint(32, 257))),
                 int(rs.randint(16, 33))) for _ in range(4)]
        streams, launches, steps = _serve_greedy(torch, smodel, None, reqs,
                                                 pa)
        if launches != steps * layers or not steps:
            raise AssertionError("paged_decode launched {} times over {} "
                                 "decode steps x {} layers".format(
                                     launches, steps, layers))
        compared, stops, worst = _solo_teacher_forced(torch, smodel, reqs,
                                                      streams)
        exact = sum(
            decoding.generate(smodel, None, p[None], n,
                              auto_cache=True)[0, len(p):].tolist() == toks
            for (p, n), toks in zip(reqs, streams))
        live_streams, _, _ = _serve_greedy(torch, smodel, live4, reqs, pa)
        if live_streams != streams:
            raise AssertionError("streams from the checkpoint differ from "
                                 "the live step-4 weights' streams")
        log("whole  served from restore_variables ({:.3f} s, {} tensors) on "
            "a bf16 model and pool: {} greedy requests, {} decode steps, "
            "paged_decode launches {} (= steps x {}); streams equal the "
            "live step-4 weights' streams; against solo generate: {} of {} "
            "streams equal, teacher-forced {} tokens compared, {} near-tie "
            "stops (largest top-2 gap {:.1f} bf16 steps, limit {}) on "
            "{}".format(restore_vars_s, len(restored), len(reqs), steps,
                        launches, layers, exact, len(reqs), compared, stops,
                        worst, BF16_NEAR_TIE_ULPS, card))
        del smodel, served, restored, live4
        torch.cuda.empty_cache()

        # Async: the save snapshots the state, two more steps update it in
        # place, and the restored values are the values at the save.
        amgr = CheckpointManager(os.path.join(root, "async"), max_to_keep=2,
                                 async_checkpointing=True)
        at_save = {k: v.detach().clone() for k, v in state.params.items()}
        moments = {(i, k): v.clone() for i, m in _moments(state).items()
                   for k, v in m.items()}
        save_step = state.step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not amgr.save(state):
            raise AssertionError("the async save was declined")
        async_s = time.perf_counter() - t0
        for _ in range(2):
            state, _, _, _ = train_step_counted(torch, fa, tr, state, batch)
        t0 = time.perf_counter()
        amgr.wait()
        wait_s = time.perf_counter() - t0
        if amgr.latest_committed_step() != save_step:
            raise AssertionError("async step {} not committed".format(
                save_step))
        state = amgr.restore(state)
        after = _moments(state)
        bad = [k for k in at_save if not _equal(state.params[k], at_save[k])]
        bad += [key for key, v in moments.items()
                if not _equal(after[key[0]][key[1]], v)]
        if state.step != save_step or bad:
            raise AssertionError("async save differs from its snapshot: "
                                 "step {}, {}".format(state.step, bad[:3]))
        amgr.close()
        log("whole  async save at step {}: blocked fit {:.3f} s, wait after "
            "two more steps {:.3f} s; restored bitwise equal to the values "
            "at the save on {}".format(save_step, async_s, wait_s, card))

        # fit's step time beside the plain train_step loop's (a host sync
        # on each loss), 8 steps each, in turns: by CUDA events at each
        # step's start (the device timeline, idle gaps included; median of
        # steps 2-8) and by the host clock over the loop.
        def timed(run):
            marks = []

            def marked_step(state, batch):
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                return plain_step(state, batch)

            tr.train_step = marked_step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = run()
            finally:
                del tr.train_step
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / 8 * 1e3
            ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            return out, float(np.median(ms[1:])), host_ms

        def plain_loop(state):
            for b in host_batches(8):
                state, m = tr.train_step(state, b)
                float(m["loss"])
            return state

        runs = {"plain loop": [], "fit depth 2": [], "fit depth 0": []}
        order = list(runs)
        for rnd in range(4):  # in turns, the order reversed every round
            for name in order if rnd % 2 == 0 else order[::-1]:
                if name == "plain loop":
                    state, ev, host = timed(lambda: plain_loop(state))
                else:
                    depth = int(name[-1])
                    (state, _), ev, host = timed(lambda: tr.fit(
                        state, host_batches(8), depth=depth, flush_every=2))
                runs[name].append((ev, host))
        log("whole  step ms by events / by host clock, 8 steps a run, four "
            "runs each in turns (train phase's plain loop: {:.2f} ms host): "
            "{}; medians by events {} on {}".format(
                plain_step_ms, "; ".join(
                    "{} {}".format(name, ", ".join(
                        "{:.2f} / {:.2f}".format(*r) for r in rs))
                    for name, rs in runs.items()),
                ", ".join("{} {:.2f}".format(name, float(np.median(
                    [ev for ev, _ in rs]))) for name, rs in runs.items()),
                card))
        del model, tr, state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- export and Spark-ML inference: export.py, pipeline.py ---------------------

# (a): GPT-2-small, bf16 compute, flash route, trained two steps at
# ``_lm_trainer``'s b8 x s1024, then exported with the serving artifact
# traced at tokens (2, 128). The registry rebuild predicts b4 x s256; the
# artifact serves (1, 128) and (4, 128). Its dense attention is held
# against the live model's dense route to EXPORT_AOT_TOL, the bf16 limit of
# ``tests/test_torch_model.py::test_bf16_forward_close_to_jax`` (logits of
# O(1) a few bf16 ulps apart).
EXPORT_KW = dict(GPT2_SMALL, attention_impl="pallas")
EXPORT_EXAMPLE = (2, 128)
EXPORT_PREDICT = (4, 256)
EXPORT_SERVE_BATCHES = (1, 4)
EXPORT_AOT_TOL = 0.1
EXPORT_REQUESTS = 8
EXPORT_GENERATE = (32, 32)  # prompt tokens, new tokens
# (b): the estimator's LM: GPT-2-small's width (768, 12 heads, MLP 3072) at
# 2 layers, a vocabulary of 512 and a context of 128; two executors share
# the card (data=2 over gloo), batch 8 a rank. The export names
# EST_MODEL, which ``register_last_position`` adds to the registry on each
# executor (``TFModel``'s ``model_registrar``) and in the driver: the same
# LM and weights, its output the last position's logits, so that an
# output row is one vector (a table holds scalars and 1-D arrays).
EST_LM = dict(GPT2_SMALL, num_layers=2, vocab_size=512, max_seq_len=128,
              attention_impl="pallas")
EST_MODEL = "transformer-last-position"
EST_TRAIN_ROWS = 48
EST_ROWS = 64
EST_BATCH = 8

_SERVE_CHILD = r"""
import json, sys, time
import numpy as np
from tensorflowonspark_tpu_torch import export
z = np.load(sys.argv[1])
doc = {"load_s": {}, "max_abs_err": {}, "bitwise": {}}
outs = {}
for name, path in (("card", sys.argv[2]), ("cpu", sys.argv[3])):
    t0 = time.perf_counter()
    loaded = export.load_serving_model(path)
    doc["load_s"][name] = time.perf_counter() - t0
    for b in BATCHES:
        got = loaded.predict(z["x{}".format(b)])["out"]
        want = z["ref{}".format(b)]
        assert got.shape == want.shape, (got.shape, want.shape)
        key = "{}_b{}".format(name, b)
        doc["max_abs_err"][key] = float(np.abs(got - want).max())
        doc["bitwise"][key] = bool(np.array_equal(got, want))
        outs[key] = got
doc["artifacts_equal"] = all(np.array_equal(outs["card_b%d" % b],
                                            outs["cpu_b%d" % b])
                             for b in BATCHES)
doc["device"] = str(loaded.device)
doc["models_loaded"] = sorted(
    m for m in sys.modules if m.startswith("tensorflowonspark_tpu_torch.models"))
print(json.dumps(doc))
"""


def _start_serving(torch, root, card_dir, cpu_dir, dense_model):
    """Start a fresh interpreter that serves both artifacts on the card at
    EXPORT_SERVE_BATCHES (loading no ``models`` module) against the live
    weights' dense route; it runs while the driver goes on. Returns
    ``(process, start time)`` for :func:`_finish_serving`."""
    arrays = {}
    for b in EXPORT_SERVE_BATCHES:
        x = np.random.RandomState(40 + b).randint(
            1, GPT2_SMALL["vocab_size"], size=(b, EXPORT_EXAMPLE[1])).astype(
                np.int32)
        with torch.no_grad():
            ref = dense_model(torch.as_tensor(x, device=dense_model.device))
        arrays["x{}".format(b)] = x
        arrays["ref{}".format(b)] = ref.float().cpu().numpy()
    path = os.path.join(root, "serve_inputs.npz")
    np.savez(path, **arrays)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVE_CHILD.replace(
            "BATCHES", repr(EXPORT_SERVE_BATCHES)), path, card_dir, cpu_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def _finish_serving(proc, t0):
    """The serving child's report, checked."""
    out, err = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise AssertionError("serving child failed:\n" + err[-4000:])
    doc = json.loads(out.strip().splitlines()[-1])
    doc["seconds"] = time.perf_counter() - t0
    if doc["models_loaded"] or not doc["device"].startswith("cuda"):
        raise AssertionError("the artifact's child loaded {} on {}".format(
            doc["models_loaded"], doc["device"]))
    worst = max(doc["max_abs_err"].values())
    if not worst <= EXPORT_AOT_TOL:
        raise AssertionError("serving artifact vs the live dense route: {} "
                             "(limit {})".format(doc["max_abs_err"],
                                                 EXPORT_AOT_TOL))
    return doc


def export_lm(torch, fa, pa, root, card):
    """(a): train, checkpoint, export; the registry rebuild, the checkpoint
    load and the artifact against the live model; ``serving_engine()`` and
    ``generate`` against the live model's. Returns the flash kernels'
    launches and B4's."""
    from tensorflowonspark_tpu_torch import export
    from tensorflowonspark_tpu_torch.models import decoding, factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train import checkpoint as ckpt_lib

    vocab, layers = GPT2_SMALL["vocab_size"], GPT2_SMALL["num_layers"]
    model_kwargs = dict(EXPORT_KW, dtype=torch.bfloat16)
    model = factory.get_model("transformer", device="cuda", seed=0,
                              **model_kwargs)
    tr = Trainer(model, optimizer=trainer.adamw(3e-4), device="cuda")
    state = tr.init()
    batch = lm_batch(8, 1024, vocab)
    fa.reset_launches()
    losses = []
    for _ in range(2):
        state, m = tr.train_step(state, batch)
        losses.append(float(m["loss"]))
    launches = dict(fa.launches)
    if launches != dict.fromkeys(fa.launches, 2 * layers) or not all(
            np.isfinite(losses)):
        raise AssertionError("export training: losses {} launches {}".format(
            losses, launches))
    ckpt = os.path.join(root, "ckpt")
    mgr = ckpt_lib.CheckpointManager(ckpt)
    mgr.save(state, force=True)
    mgr.close()
    if ckpt_lib.latest_committed_step(ckpt) != 2:
        raise AssertionError("export: step 2 is not committed")

    card_dir, cpu_dir = (os.path.join(root, n) for n in ("card", "cpu"))
    example = np.zeros(EXPORT_EXAMPLE, np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export.export_saved_model(card_dir, "transformer", state=state,
                              model_kwargs=model_kwargs,
                              example_inputs=example)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    export.export_saved_model(
        cpu_dir, "transformer",
        params={k: v.detach().cpu() for k, v in state.params.items()},
        model_kwargs=model_kwargs, example_inputs=example)
    cpu_export_s = time.perf_counter() - t0
    sizes = {n: {f: os.path.getsize(os.path.join(d, f)) for f in (
        export.VARIABLES, "torch_export/serving_default.pt2")}
        for n, d in (("card", card_dir), ("cpu", cpu_dir))}
    log("export (a) GPT-2-small bf16 flash: 2 steps (losses {}), step 2 "
        "committed; export {:.1f} s on the card, {:.1f} s from CPU tensors "
        "(bytes {})".format(["{:.4f}".format(v) for v in losses], export_s,
                            cpu_export_s, sizes))

    # The artifacts, served code-free on the card by a child process that
    # runs beside the checks below.
    params = {k: v.detach() for k, v in state.params.items()}
    dense = factory.get_model("transformer", device="cuda", **dict(
        model_kwargs, attention_impl="dense"))
    decoding.load_variables(dense, params)
    child, t_child = _start_serving(torch, root, card_dir, cpu_dir, dense)
    del dense
    try:
        b4 = _export_checks(torch, fa, pa, model, params, card_dir, ckpt,
                            model_kwargs, launches)
        doc = _finish_serving(child, t_child)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    log("export (a) torch.export artifact in a fresh process (no models "
        "module loaded) on {}: written on the card and on the CPU, served "
        "at batches {} x {} tokens; max |artifact - live dense route| {} "
        "(limit {}), bitwise {}, the two artifacts equal {}; load s {}, "
        "child {:.1f} s".format(
            doc["device"], EXPORT_SERVE_BATCHES, EXPORT_EXAMPLE[1],
            doc["max_abs_err"], EXPORT_AOT_TOL, doc["bitwise"],
            doc["artifacts_equal"],
            {k: round(v, 2) for k, v in doc["load_s"].items()},
            doc["seconds"]))
    del model, tr, state, params
    torch.cuda.empty_cache()
    return launches, b4


def _export_checks(torch, fa, pa, model, params, card_dir, ckpt,
                   model_kwargs, launches):
    """(a)'s checks beside the serving child: the registry rebuild and the
    checkpoint load against the live forward (B1 counted into
    ``launches``), then ``generate`` and the engines. Returns B4's
    launches."""
    from tensorflowonspark_tpu_torch import export

    vocab, layers = GPT2_SMALL["vocab_size"], GPT2_SMALL["num_layers"]
    # The live model's forward, and the registry rebuild's: bitwise, with
    # B1 once a layer a call.
    x = np.random.RandomState(31).randint(1, vocab, size=EXPORT_PREDICT)\
        .astype(np.int32)
    model.eval()
    with torch.no_grad():
        live = model(torch.as_tensor(x, device=model.device)).float().cpu()\
            .numpy()
    t0 = time.perf_counter()
    loaded = export.load_saved_model(card_dir, prefer_aot=False)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_ckpt = export.load_from_checkpoint(ckpt, "transformer",
                                            model_kwargs=model_kwargs)
    ckpt_load_s = time.perf_counter() - t0
    predict_ms = {}
    for name, lm in (("export", loaded), ("checkpoint", from_ckpt)):
        fa.reset_launches()
        stop = _timer(torch)
        got = lm.predict({"x": x})["out"]
        predict_ms[name] = stop()
        counts = dict(fa.launches)
        if counts != dict(flash_fwd=layers, flash_bwd_dq=0, flash_bwd_dkv=0):
            raise AssertionError("{} predict launched {}".format(name,
                                                                 counts))
        if not np.array_equal(got, live):
            raise AssertionError("{} predict differs from the live model: "
                                 "{}".format(name, np.abs(got - live).max()))
        launches["flash_fwd"] += counts["flash_fwd"]
    del live, from_ckpt
    log("export (a) load_saved_model(prefer_aot=False) {:.1f} s, "
        "load_from_checkpoint {:.1f} s; predict b4 x s256 bitwise the live "
        "forward, B1 {} a call, {} ms by events".format(
            load_s, ckpt_load_s, layers,
            {k: round(v, 3) for k, v in predict_ms.items()}))
    b4 = _export_serving(torch, pa, model, params, loaded)
    del loaded
    return b4


def _export_serving(torch, pa, model, params, loaded):
    """``generate`` and ``serving_engine()`` of the export against the live
    model's; returns B4's launches."""
    from tensorflowonspark_tpu_torch.models import decoding
    from tensorflowonspark_tpu_torch.serving import ServingEngine

    vocab = GPT2_SMALL["vocab_size"]
    # generate: greedy, bitwise the live model's.
    p_len, n_new = EXPORT_GENERATE
    prompt = np.random.RandomState(32).randint(1, vocab, size=(1, p_len))
    got = loaded.generate(prompt, n_new)
    want = decoding.generate(model, None, prompt, n_new)
    if not torch.equal(got, want):
        raise AssertionError("LoadedModel.generate differs from the live "
                             "model's")

    # serving_engine() at the JAX defaults against an engine built on the
    # live model (last: that engine adopts bf16 weights into it).
    rs = np.random.RandomState(33)
    shapes = [SERVE_DEFAULT_SHAPES[i % len(SERVE_DEFAULT_SHAPES)]
              for i in range(EXPORT_REQUESTS)]
    prompts = [rs.randint(1, vocab, size=p) for p, _ in shapes]

    def run(engine):
        handles = [(engine.submit(p, n), n)
                   for p, (_, n) in zip(prompts, shapes)]
        engine.run_until_idle()
        return handles

    b4 = 0
    streams = {}
    engines = (("serving_engine()", lambda: loaded.serving_engine()),
               ("direct", lambda: ServingEngine(
                   model, decoding.serving_variables(params))))
    for name, build in engines:
        engine = build()
        t0 = time.perf_counter()
        streams[name], _, delta = serve_counted(torch, engine, pa, run)
        sec = time.perf_counter() - t0
        b4 += delta["launches"]
        log("export (a) {} at the JAX defaults (horizon {}, {} slots): {} "
            "requests, {} decode calls, B4 {} launches, {} tokens in "
            "{:.2f} s".format(
                name, engine.decode_horizon, engine.max_slots,
                EXPORT_REQUESTS, delta["decode_steps"], delta["launches"],
                delta["decode_tokens"], sec))
        del engine
    if streams["serving_engine()"] != streams["direct"]:
        raise AssertionError("serving_engine() streams differ from the "
                             "engine on the live model")
    return b4


def estimator_node(args, ctx):
    """The estimator's ``train_fn``: join the group (two ranks on the card,
    gloo), train ``args.lm`` on the feed's lockstep batches, save the
    collective checkpoint. Records losses and launches under
    ``args.outdir``."""
    import torch

    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.parallel import MeshConfig, multihost
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    ctx.initialize_distributed(device=args.device)
    rank = multihost.process_index()
    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device=ctx.device, seed=0, **args.lm)
    tr = Trainer(model, optimizer=trainer.adamw(CLUSTER_LR),
                 mesh=MeshConfig(data=-1).build(), device=ctx.device)
    state = tr.init()
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping={"tokens": "tokens"})
    example = {"tokens": np.zeros((1, args.lm["max_seq_len"] + 1), np.int64)}
    fa.reset_launches()
    losses = []
    for arrays, mask in feed.sync_batches(args.batch_size, example=example):
        state, m = tr.train_step(state, _cluster_batch(arrays["tokens"],
                                                       mask))
        losses.append(float(m["loss"]))
    launches = dict(fa.launches)
    ckpt = CheckpointManager(ctx.absolute_path(args.model_dir))
    ckpt.save(state, force=True)
    ckpt.close()
    with open(os.path.join(args.outdir, "node{}.json".format(rank)),
              "w") as f:
        json.dump({"losses": losses, "launches": launches,
                   "backend": ctx.distributed_backend}, f)
    multihost.shutdown()


def register_last_position():
    """``model_registrar``: register EST_MODEL, the transformer LM whose
    forward returns the last position's logits (the full forward runs, B1
    once a layer)."""
    from tensorflowonspark_tpu_torch.models import factory, transformer

    class LastPositionLM(transformer.TransformerLM):
        def forward(self, tokens, **kwargs):
            return super().forward(tokens, **kwargs)[:, -1]

    factory.register(EST_MODEL, lambda device="cuda", seed=0, **kw:
                     LastPositionLM(transformer.TransformerConfig(**kw),
                                    device=device, seed=seed))


def estimator_export(args):
    """The estimator's ``export_fn``, on one executor: the committed
    checkpoint to an export directory."""
    from tensorflowonspark_tpu_torch import export
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    mgr = CheckpointManager(args.model_dir)
    try:
        params, model_state = mgr.restore_variables(split=True)
    finally:
        mgr.close()
    export.export_saved_model(args.export_dir, EST_MODEL, params=params,
                              model_state=model_state,
                              model_kwargs=dict(args.lm, dtype="bfloat16"))
    with open(os.path.join(args.outdir, "export.json"), "w") as f:
        json.dump({"seconds": time.perf_counter() - t0,
                   "pid": os.getpid()}, f)


def executor_launches(iterator):
    """A task: this executor's flash launch counts, then zeroed."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    list(iterator)
    counts = dict(fa.launches)
    fa.reset_launches()
    return [counts]


def start_estimator(pool, root):
    """(b), first half: ``TFEstimator(train_fn, export_fn).fit`` in FEED
    mode on the two executors of ``pool``, on a thread of its own, so that
    it runs beside (a). Returns the thread and the dict it fills (``model``
    and ``fit_s``, or ``error``)."""
    import threading

    from tensorflowonspark_tpu_torch import pipeline

    seq = EST_LM["max_seq_len"]
    rng = np.random.RandomState(34)
    train = [{"tokens": r.tolist()} for r in rng.randint(
        1, EST_LM["vocab_size"], size=(EST_TRAIN_ROWS, seq + 1))]
    outdir = os.path.join(root, "estimator")
    os.makedirs(outdir)
    est = (pipeline.TFEstimator(estimator_node,
                                {"lm": EST_LM, "outdir": outdir},
                                export_fn=estimator_export)
           .setInputMapping({"tokens": "tokens"}).setClusterSize(2)
           .setBatchSize(EST_BATCH).setEpochs(1)
           .setModelDir(os.path.join(root, "est_model"))
           .setExportDir(os.path.join(root, "est_export")).setTimeout(600))
    result = {"outdir": outdir}

    def fit():
        t0 = time.perf_counter()
        try:
            result["model"] = est.fit(train, backend=pool)
        except Exception as e:  # raised again by finish_estimator
            result["error"] = e
        result["fit_s"] = time.perf_counter() - t0

    thread = threading.Thread(target=fit, name="estimator-fit", daemon=True)
    thread.start()
    return thread, result


def finish_estimator(torch, fa, pool, started, card):
    """(b), second half: wait for the fit, then ``TFModel.transform`` over
    EST_ROWS rows on the same two executors, against in-process
    ``predict`` on the same batches. Returns the flash kernels' launches
    (training and transform)."""
    from tensorflowonspark_tpu_torch import export

    thread, result = started
    thread.join(timeout=900)
    if thread.is_alive():
        raise AssertionError("the estimator's fit did not end in 900 s")
    if "error" in result:
        raise AssertionError("the estimator's fit failed") from \
            result["error"]
    model, fit_s, outdir = result["model"], result["fit_s"], result["outdir"]
    rows = [{"tokens": r.tolist()} for r in np.random.RandomState(35).randint(
        1, EST_LM["vocab_size"], size=(EST_ROWS, EST_LM["max_seq_len"]))]
    pool.map_partitions([[0], [1]], executor_launches)  # zeroed
    model.setInputMapping({"tokens": "x"}).setBatchSize(EST_BATCH)
    model.setModelRegistrar(register_last_position)
    t0 = time.perf_counter()
    out = model.transform(rows, backend=pool)
    transform_s = time.perf_counter() - t0
    infer = pool.map_partitions([[0], [1]], executor_launches)
    with open(os.path.join(outdir, "export.json")) as f:
        exp = json.load(f)
    nodes = []
    for r in range(2):
        with open(os.path.join(outdir, "node{}.json".format(r))) as f:
            nodes.append(json.load(f))
    steps = len(nodes[0]["losses"])
    per_rank = dict.fromkeys(fa.launches, steps * EST_LM["num_layers"])
    if any(n["launches"] != per_rank for n in nodes) or steps < 2:
        raise AssertionError("estimator ranks launched {}; want {} each"
                             .format([n["launches"] for n in nodes],
                                     per_rank))
    if not all(np.isfinite(n["losses"]).all() for n in nodes):
        raise AssertionError("estimator losses: {}".format(
            [n["losses"] for n in nodes]))
    # Output rows align 1:1 with the input and equal the in-process
    # predict on the transform's own batches (round-robin partitions).
    if len(out) != EST_ROWS or out.schema != {"output": "array<float>"}:
        raise AssertionError("transform returned {} rows, schema {}".format(
            len(out), out.schema))
    got = np.asarray([r["output"] for r in out], np.float32)
    x = np.asarray([r["tokens"] for r in rows], np.int64)
    register_last_position()
    loaded = export.load_saved_model(model.getExportDir())
    want = np.zeros_like(got)
    for p in range(2):
        idx = np.arange(p, EST_ROWS, 2)
        for s in range(0, len(idx), EST_BATCH):
            chunk = idx[s:s + EST_BATCH]
            want[chunk] = loaded.predict(x[chunk])["out"]
    err = float(np.abs(got - want).max())
    if err != 0.0:
        raise AssertionError("transform vs in-process predict: max abs "
                             "{}".format(err))
    infer_fwd = [c[0]["flash_fwd"] for c in infer]
    want_fwd = EST_ROWS // 2 // EST_BATCH * EST_LM["num_layers"]
    if infer_fwd != [want_fwd, want_fwd] or any(
            c[0]["flash_bwd_dq"] or c[0]["flash_bwd_dkv"] for c in infer):
        raise AssertionError("transform executors launched {}".format(infer))
    launches = {k: sum(n["launches"][k] for n in nodes) for k in per_rank}
    launches["flash_fwd"] += sum(infer_fwd)
    log("export (b) TFEstimator FEED, 2 executors on the card ({}), {} "
        "rows b{} a rank, {} layers at GPT-2-small width, vocab {}: losses "
        "{}; fit {:.1f} s (export_fn {:.2f} s on executor pid {}); "
        "TFModel.transform {} rows on 2 executors {:.1f} s = {:.1f} rows/s; "
        "bitwise the in-process predict; B1 {} a rank in training, {} an "
        "executor in transform on {}".format(
            nodes[0]["backend"], EST_TRAIN_ROWS, EST_BATCH,
            EST_LM["num_layers"], EST_LM["vocab_size"],
            [["{:.4f}".format(v) for v in n["losses"]] for n in nodes],
            fit_s, exp["seconds"], exp["pid"], EST_ROWS, transform_s,
            EST_ROWS / transform_s, per_rank["flash_fwd"], want_fwd, card))
    return launches


def export_phase(torch, fa, pa, card):
    """The export and Spark-ML inference plane: (a), with (b)'s fit
    running beside it on its own executors, then (b)'s transform. Returns
    the flash kernels' launches and B4's."""
    import shutil
    import tempfile

    from tensorflowonspark_tpu_torch import backend

    root = tempfile.mkdtemp(prefix="tfos-export-")
    # (b)'s estimator fits on two executors beside (a).
    pool = backend.LocalBackend(2, base_dir=os.path.join(root, "exec"))
    try:
        started = start_estimator(pool, root)
        launches, b4 = export_lm(torch, fa, pa, root, card)
        est = finish_estimator(torch, fa, pool, started, card)
    finally:
        pool.stop()
        shutil.rmtree(root, ignore_errors=True)
    return {k: launches[k] + est[k] for k in launches}, b4


# -- fused ResNet bottleneck (B5, B6) and ResNet-50 training -------------------

# ``scripts/block_bench.py``'s two full-width blocks (name, spatial, C, F),
# batch 256, and the JAX kernel tests' shape (b4, 8x8, C 32, F 16).
BLOCKS = [("stage1", 56, 256, 64), ("stage3", 14, 1024, 256)]
BLOCK_BATCH = 256
SMALL_BLOCK = ("jax_test", 8, 32, 16)
SMALL_BATCH = 4
# Geometry-only bf16 cases, untimed (name, spatial, C, F, batch): ResNet-50's
# stride-1 stages 2 and 4 at b16 (an image smaller than a strip, F above
# 256, C = 2048), and a ragged block: strips of 8, 8, 8 and 6 rows, input
# channels no multiple of a 64-channel chunk (96, 384), part-filled column
# tiles, rows no multiple of a row tile.
GEOMETRY_BLOCKS = [("stage2", 28, 512, 128, 16), ("stage4", 7, 2048, 512, 16),
                   ("ragged", 30, 384, 96, 3)]
# Fused-block kernels against their plain versions on the same inputs:
# y (bf16) within one bf16 step (2^-7 of the value) plus FUSED_Y_ATOL, and
# differing in at most BF16_MAX_DIFFERING of the values (read: one step, in
# at most 0.062% of the values, where the f32 sums' order flips a rounding;
# near zero, where y is a difference of nearly equal sums of 1024-2304
# products, the two orders differ by up to 1.4e-6 past the step, so the
# absolute floor; the script prints that excess as "near-zero");
# the f32 sums within FUSED_SUM_RTOL of their largest value (read 2.7e-6 at
# the stage-3 block, 6.1e-7 at stage 1; NVIDIA H100 80GB HBM3, 700 W). The
# f32 kernels' y is held to TOL["f32"] instead (no bf16 step; f32 sums in
# another order differ in most values' last bits, so no share is counted).
FUSED_Y_RTOL = 2.0 ** -7
FUSED_Y_ATOL = 1e-5
FUSED_SUM_RTOL = 6e-6
# The fused block against the port's BottleneckBlock in train mode, against
# reference_forward and against each per-slot library swap: the JAX test's
# 5e-2, absolute plus relative (|err| <= 5e-2 + 5e-2 |ref|).
BLOCK_TOL = 5e-2
RESNET_BATCH = 256


def block_inputs(torch, frb, spatial, c, f, batch, seed,
                 dtype=None):
    """One block's operands on the card in ``dtype`` (bf16 by default): x,
    the parameters (He-normal weights, non-identity norms), and the inputs
    each conv slot sees on the main path, taken from the plain chain: K1
    (x), K2 (y1 and bn1's affine) and K3 (y2 and bn2's affine)."""
    dtype = torch.bfloat16 if dtype is None else dtype
    g = torch.Generator().manual_seed(seed)
    params = frb.init_params(c, f, dtype=dtype, device="cuda", generator=g)
    for i, width in (("1", f), ("2", f), ("3", c)):
        params["gamma" + i] = (1.0 + 0.2 * torch.randn(width, generator=g)
                               ).cuda()
        params["beta" + i] = (0.1 * torch.randn(width, generator=g)).cuda()
    x = (0.5 * torch.randn(batch, spatial, spatial, c, generator=g)).to(
        dtype).cuda()
    n = batch * spatial * spatial
    y1, s1, q1 = frb.matmul_stats_reference(x.reshape(n, c), params["w1"])
    sc1, sh1, _, _ = frb._affine(s1, q1, n, params["gamma1"],
                                 params["beta1"])
    y2, s2, q2 = frb.conv3x3_stats_reference(
        y1.reshape(batch, spatial, spatial, f), params["w2"], sc1, sh1)
    sc2, sh2, _, _ = frb._affine(s2, q2, n, params["gamma2"],
                                 params["beta2"])
    return dict(x=x, params=params, slots={
        "K1": (x.reshape(n, c), params["w1"], None, None),
        "K2": (y1.reshape(batch, spatial, spatial, f), params["w2"], sc1,
               sh1),
        "K3": (y2.reshape(n, f), params["w3"], sc2, sh2)})


def fused_calls(frb, slot, args):
    """(kernel, plain version, library rendition) of one conv slot."""
    if slot == "K2":
        fns = (frb._conv3x3_stats, frb.conv3x3_stats_reference,
               frb._xla_conv3x3_stats)
    else:
        fns = (frb._conv1x1_stats, frb.matmul_stats_reference,
               frb._xla_conv1x1_stats)
    return [lambda fn=fn: fn(*args) for fn in fns]


def fused_bound_ms(torch, slot, args, peak_bw, peak_ops):
    """Least time of one slot's call: the bytes it must move (x, w, the
    affine vectors and y once, the two f32 sums) at the memory rate, or its
    matmul FLOPs (2 per multiply-add; 9 taps for the 3x3 conv) at the bf16
    rate, the larger."""
    x, w = args[0], args[1]
    f_out = w.shape[-1]
    n = x.numel() // x.shape[-1]
    el = x.element_size()
    nbytes = (x.numel() + w.numel() + n * f_out) * el + 2 * f_out * 4
    if args[2] is not None:
        nbytes += 2 * x.shape[-1] * 4
    flops = 2 * n * w.numel()
    t_bytes, t_ops = nbytes / peak_bw, flops / peak_ops("bf16")
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fused_compare(torch, got, ref):
    """(y max abs err, y's largest error past one bf16 step, share of y
    values differing, sums' error over their largest value) of one kernel
    call against its plain version; raises past the limits (an f32 y:
    TOL["f32"])."""
    y, yr = got[0].float(), ref[0].float()
    err = (y - yr).abs()
    y_err = float(err.max())
    past_step = float((err - FUSED_Y_RTOL * yr.abs()).clamp_min(0.0).max())
    differing = float((got[0] != ref[0]).float().mean())
    if got[0].dtype == torch.float32:
        if not y_err <= TOL["f32"]:
            raise AssertionError("f32 y off the plain version by {} (limit "
                                 "{})".format(y_err, TOL["f32"]))
    elif not past_step <= FUSED_Y_ATOL:
        raise AssertionError("y more than one bf16 step from the plain "
                             "version: max abs err {}, {} past the step "
                             "(limit {})".format(y_err, past_step,
                                                 FUSED_Y_ATOL))
    if got[0].dtype != torch.float32 and not differing <= BF16_MAX_DIFFERING:
        raise AssertionError("{:.4f} of y differ from the plain version "
                             "(limit {})".format(differing,
                                                 BF16_MAX_DIFFERING))
    sum_err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got[1:], ref[1:]))
    if not sum_err <= FUSED_SUM_RTOL:
        raise AssertionError("sums off by {} of their largest value "
                             "(limit {})".format(sum_err, FUSED_SUM_RTOL))
    return y_err, past_step, differing, sum_err


def fused_kernel_phase(torch, frb, device_info):
    """(a) B5 (K1 without, K3 with the prologue) and B6 (K2) against their
    plain versions, and each call against a second call on the same
    operands (y and both sums bitwise): at the JAX test shape in bf16 and
    f32, at both full-width blocks (timed) and at the geometry-only blocks.
    Returns ({kernel: max y error}, {(block, slot): timings})."""
    peak_bw = device_info.peak_bandwidth()
    errs = {"matmul_stats": 0.0, "conv3x3_stats": 0.0}
    timings = {}
    shapes = [(SMALL_BLOCK, SMALL_BATCH, torch.bfloat16)]
    shapes += [(b, BLOCK_BATCH, torch.bfloat16) for b in BLOCKS]
    shapes += [(SMALL_BLOCK, SMALL_BATCH, torch.float32)]
    shapes += [(b[:4], b[4], torch.bfloat16) for b in GEOMETRY_BLOCKS]
    for i, ((name, spatial, c, f), batch, dtype) in enumerate(shapes):
        case = block_inputs(torch, frb, spatial, c, f, batch, 300 + i,
                            dtype=dtype)
        kind = "f32" if dtype == torch.float32 else "bf16"
        for slot, args in case["slots"].items():
            kernel, plain, lib = fused_calls(frb, slot, args)
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("{} {} {}: two calls on the same "
                                     "operands differ".format(name, slot,
                                                              kind))
            ref = plain()
            y_err, past_step, differing, sum_err = fused_compare(
                torch, got, ref)
            kname = "conv3x3_stats" if slot == "K2" else "matmul_stats"
            errs[kname] = max(errs[kname], y_err)
            log("kernel {:13s} {:8s} {} {} b{} {}x{} {}->{}: y max_abs_err "
                "{:.3e} ({:.5f} differ, near-zero {:.3e}), sums rel err "
                "{:.3e}, repeat equal".format(
                    kname, name, slot, kind, batch, spatial, spatial,
                    args[0].shape[-1], args[1].shape[-1], y_err, differing,
                    past_step, sum_err))
            del got, again, ref
            if batch != BLOCK_BATCH:
                continue
            ms = device_ms(torch, kernel)
            call_ms = time_cold(torch, kernel)
            plain_ms = time_cold(torch, plain, reps=5)
            lib_ms = device_ms(torch, lib)
            bound_ms, bound_by = fused_bound_ms(torch, slot, args, peak_bw,
                                                device_info.peak_ops)
            timings[(name, slot)] = dict(ms=ms, call_ms=call_ms,
                                         plain_ms=plain_ms, library_ms=lib_ms,
                                         bound_ms=bound_ms, bound_by=bound_by)
            log("time   {:13s} {:8s} {} kernel {:.4f} ms (call {:.4f})  "
                "plain {:.4f} ms  library {:.4f} ms  bound {:.4f} ms "
                "({})".format(kname, name, slot, ms, call_ms, plain_ms,
                              lib_ms, bound_ms, bound_by))
        del case
        torch.cuda.empty_cache()
    return errs, timings


def port_block(torch, params):
    """The port's ``models.resnet.BottleneckBlock`` (stride 1, C = 4F) in
    train mode, holding the fused block's weights."""
    from tensorflowonspark_tpu_torch.models import resnet

    c, f = params["w1"].shape
    block = resnet.BottleneckBlock(c, f, 1, torch.bfloat16).cuda().train()
    with torch.no_grad():
        block.Conv_0.kernel.copy_(params["w1"].t()[:, :, None, None])
        block.Conv_1.kernel.copy_(params["w2"].permute(3, 2, 0, 1))
        block.Conv_2.kernel.copy_(params["w3"].t()[:, :, None, None])
        for i in range(3):
            norm = getattr(block, "BatchNorm_{}".format(i))
            norm.scale.copy_(params["gamma{}".format(i + 1)])
            norm.bias.copy_(params["beta{}".format(i + 1)])
    return block


def block_phase(torch, frb):
    """(b) ``bottleneck_forward`` at both full-width blocks: the default
    route launches B5 twice and B6 once per call (counted from zero around
    these two calls, the main path of the kernels), and agrees with the
    port's BottleneckBlock in train mode, with ``reference_forward`` and
    with every per-slot library swap."""
    cases = []
    frb.reset_launches()
    for i, (name, spatial, c, f) in enumerate(BLOCKS):
        case = block_inputs(torch, frb, spatial, c, f, BLOCK_BATCH, 400 + i)
        before = dict(frb.launches)
        out, stats = frb.bottleneck_forward(case["params"], case["x"])
        torch.cuda.synchronize()
        counts = {k: frb.launches[k] - before[k] for k in before}
        if counts != {"matmul_stats": 2, "conv3x3_stats": 1}:
            raise AssertionError("bottleneck_forward {} launched {}".format(
                name, counts))
        cases.append((name, case, out, stats))
    launches = dict(frb.launches)
    for name, case, out, stats in cases:
        x, params = case["x"], case["params"]
        with torch.no_grad():
            want = port_block(torch, params)(x.permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1)
        refs = [("BottleneckBlock", want),
                ("reference_forward", frb.reference_forward(params, x))]
        refs += [("/".join(impls), frb.bottleneck_forward(
            params, x, impls=impls)[0]) for impls in (
                ("xla", "pallas", "pallas"), ("pallas", "xla", "pallas"),
                ("pallas", "pallas", "xla"))]
        readings = {}
        for label, ref in refs:
            err = (out.float() - ref.float()).abs()
            # The share of the limit used: 1 at |err| = 5e-2 + 5e-2 |ref|.
            used = float((err / (BLOCK_TOL + BLOCK_TOL * ref.float().abs())
                          ).max())
            readings[label] = (float(err.max()), used)
            if not used <= 1.0:
                raise AssertionError("fused block {} disagrees with {}: max "
                                     "abs err {}".format(name, label,
                                                         float(err.max())))
        finite = all(bool(torch.isfinite(t).all()) for pair in stats
                     for t in pair)
        if not (finite and bool(torch.isfinite(out).all())):
            raise AssertionError("fused block {}: non-finite".format(name))
        log("block  {} b{} {}x{} {}->{}: max abs err vs {}".format(
            name, BLOCK_BATCH, *([case["x"].shape[1]] * 2),
            case["x"].shape[-1], case["params"]["w1"].shape[1],
            ", ".join("{} {:.3e} ({:.2f} of the limit)".format(k, *v)
                      for k, v in readings.items())))
    log("block  launches over the two default calls: {}".format(launches))
    del cases
    torch.cuda.empty_cache()
    return launches


def resnet_training_phase(torch, card):
    """(c) ``bench.py``'s ``bench_resnet50`` through the port: resnet50,
    1000 classes, b256 bf16 224x224x3 images (the same batch every step),
    ``sgd(0.1, momentum=0.9)``; 4 steps with finite losses, the loss of
    the last step below the first's (the same batch every step, so a
    backward that does not descend shows), the running statistics moved,
    images/s (median of steps 2-4); then a profiled window."""
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    model = factory.get_model("resnet50", num_classes=1000, device="cuda",
                              seed=0)
    tr = Trainer(model, optimizer=trainer.sgd(0.1, momentum=0.9),
                 device="cuda")
    state = tr.init()
    rng = np.random.RandomState(0)
    batch = {
        "x": torch.from_numpy(rng.rand(RESNET_BATCH, 224, 224, 3).astype(
            np.float32)).to(torch.bfloat16).cuda(),
        "y": torch.from_numpy(rng.randint(0, 1000, size=RESNET_BATCH).astype(
            np.int64)).cuda(),
    }
    stats0 = {n: b.clone() for n, b in state.model_state.items()}
    losses, secs = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(4):
        t0 = time.perf_counter()
        state, m = tr.train_step(state, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    moved = sum(not torch.equal(b, stats0[n])
                for n, b in state.model_state.items() if n.endswith("mean"))
    n_means = sum(n.endswith("mean") for n in state.model_state)
    if not all(np.isfinite(losses)):
        raise AssertionError("resnet50 losses not finite: {}".format(losses))
    if not losses[-1] < losses[0]:
        raise AssertionError("resnet50 loss did not fall over 4 steps on "
                             "one batch: {}".format(losses))
    if moved != n_means:
        raise AssertionError("{} of {} running means moved".format(moved,
                                                                   n_means))
    step_ms = float(np.median(secs[1:])) * 1e3
    log("resnet ResNet-50 b256 224x224 bf16 sgd(0.1, 0.9): losses {}; "
        "running means moved {}/{}; step {:.2f} ms median of steps 2-4 "
        "(step 1 {:.0f} ms), {:.1f} images/s, peak memory {:.1f} GB on "
        "{}".format(["{:.4f}".format(x) for x in losses], moved, n_means,
                    step_ms, secs[0] * 1e3, RESNET_BATCH / step_ms * 1e3,
                    torch.cuda.max_memory_allocated() / 1e9, card))
    profile_train_step(torch, tr, state, batch, steps=2,
                       label="ResNet-50 b256 224x224 bf16", top_ops=12)
    del model, tr, state, batch
    torch.cuda.empty_cache()


def resnet_phase(torch, frb, device_info, card):
    errs, timings = fused_kernel_phase(torch, frb, device_info)
    launches = block_phase(torch, frb)
    resnet_training_phase(torch, card)
    return errs, timings, launches


# -- greedy equality -----------------------------------------------------------


# -- the cluster runtime: cluster.run over spawned executors ------------------

# (a): one executor, GPT-2-small width, the main training path's geometry
# (b8 x s1024: the sequence is the model's max_seq_len).
CLUSTER_STEPS = 6
CLUSTER_BATCH = 8
# (b): two executors sharing the one card, data=2, at GPT-2-small width
# and a reduced depth of 2 layers (two processes' activations, weights and
# AdamW state on one card beside the driver's). Partitions of 8, 8, 8, 8
# and 4 rows: rank 0 takes three (20 rows), rank 1 two (16 rows), so rank
# 1 trains its third step on a lockstep zero batch (mask 0).
CLUSTER_DP_LAYERS = 2
CLUSTER_DP_PARTS = (8, 8, 8, 8, 4)
# The data-parallel run against one in-process trainer with grad_accum=2
# over the concatenated global batches: each microbatch is one rank's 8
# rows, so its bf16 matmuls are the rank's own, and the weights of the
# two paths (mask sums over the global sum, against the rank's mask sum
# and a division after the all-reduce) are powers of two on full
# batches. Each step's loss, relative; the update (final minus initial
# parameters), relative in norm over the elements whose reference step-1
# gradient lies above CLUSTER_ADAM_NEAR_EPS; below it (~10x Adam's eps)
# Adam turns a last-bit gradient difference into one of order lr, so
# those elements are held to 2 lr a step (a sign flip), as
# tests/test_torch_cluster.py holds them to the JAX trainer. The same
# update reading of a replay with plain DDP averaging (each rank's local
# mean, the ranks' gradients averaged: a lockstep zero batch halves the
# step) must lie above the limit, or the check could not see that fault.
# Readings (NVIDIA H100 80GB HBM3, 700 W): loss 0, update 0, near-eps
# elements 0 (0.34% of them); plain DDP averaging 4.98e-2. The update
# limit sits 50x below the fault and leaves room for a run whose
# non-blocking drain hands a rank a partial batch (weights then no
# powers of two).
CLUSTER_DP_LOSS_RTOL = 2e-5
CLUSTER_DP_UPDATE_RTOL = 1e-3
CLUSTER_ADAM_NEAR_EPS = 1e-7
CLUSTER_LR = 3e-4
# The inference batches of (c): two partitions of one batch each.
CLUSTER_INFER_PARTS = 2
# (a)'s live incident capture: steps timed with the continuous sampler off
# and on (twice each, in turns), the profile window a capture request asks
# for, and the recorder's snapshot budget (a window's trace export of a
# GPT-2-small step loop takes seconds).
CAPTURE_TIMED_STEPS = 8
CAPTURE_PROFILE_SECS = 2.0
CAPTURE_NODE_TIMEOUT = 30.0
FLASH_KERNELS = {"flash_fwd": "flash_fwd_bf16_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_bf16_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_bf16_kernel"}


def _cluster_rows(lm, n, seed):
    """``n`` seeded rows of ``max_seq_len + 1`` tokens: a row is one feed
    item, the inputs its first tokens, the labels its last."""
    rng = np.random.RandomState(seed)
    return [r.tolist() for r in rng.randint(
        1, lm["vocab_size"], size=(n, lm["max_seq_len"] + 1))]


def _timer(torch):
    """A stop function for a timing started now: it returns the
    milliseconds since, by CUDA events (the step's device time)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()

    def stop():
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    return stop


def _cluster_batch(arrays, mask):
    """A feed batch ``(rows, mask)`` as the LM batch of the Quickstart: a
    per-token loss mask from the feed's per-row mask."""
    arrays = np.asarray(arrays)
    return {"x": arrays[:, :-1].astype(np.int64),
            "y": arrays[:, 1:].astype(np.int64),
            "mask": np.repeat(np.asarray(mask, np.float32)[:, None],
                              arrays.shape[1] - 1, 1)}


def _params_equal_to_rank0(torch, dist, state):
    """Whether this rank's parameters equal rank 0's bit for bit (rank 0's
    broadcast, compared here)."""
    flat = torch.cat([p.detach().reshape(-1).float()
                      for p in state.params.values()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    return bool(torch.equal(ref, flat))


def cluster_node(args, ctx):
    """The node program of the cluster phase (the README's Quickstart on
    the port): join the group, build the LM, train on ``sync_batches``
    with ``Trainer.train_step``, then (one executor) answer inference
    batches. Writes what the driver checks to ``args["outdir"]``."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.parallel import MeshConfig, multihost
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    # Wall-clock marks of the bring-up (one host clock with the driver's).
    marks = {"enter": time.time()}
    joined = ctx.initialize_distributed()
    marks["joined"] = time.time()
    rank = multihost.process_index()
    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device=ctx.device, seed=0,
                              **dict(args["lm"], attention_impl="pallas"))
    tr = Trainer(model, optimizer=trainer.adamw(CLUSTER_LR),
                 mesh=MeshConfig(data=-1).build(), device=ctx.device)
    state = tr.init()
    marks["built"] = time.time()
    torch.cuda.reset_peak_memory_stats(ctx.device)
    feed = ctx.get_data_feed(train_mode=True)
    example = np.zeros((1, args["lm"]["max_seq_len"] + 1), np.int64)
    doc = {"rank": rank, "joined": joined, "device": str(ctx.device),
           "backend": getattr(ctx, "distributed_backend", None),
           "backend_reason": getattr(ctx, "distributed_backend_reason",
                                     None),
           "losses": [], "step_ms": [], "wait_ms": [], "equal": [],
           "marks": marks}
    batches = []
    fa.reset_launches()
    it = iter(feed.sync_batches(CLUSTER_BATCH, example=example))
    while len(batches) < args["steps"]:
        t_wait = time.perf_counter()
        try:
            arrays, mask = next(it)
        except StopIteration:
            break
        doc["wait_ms"].append((time.perf_counter() - t_wait) * 1e3)
        batch = _cluster_batch(arrays, mask)
        batches.append(batch)
        marks.setdefault("first_step", time.time())
        stop = _timer(torch)
        state, m = tr.train_step(state, batch)
        doc["step_ms"].append(stop())
        doc["losses"].append(float(m["loss"]))
        if multihost.is_multiprocess():
            doc["equal"].append(_params_equal_to_rank0(torch, dist, state))
    it.close()
    doc["train_launches"] = dict(fa.launches)
    doc["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    if args.get("capture_dir"):
        doc["capture"] = _capture_steps(torch, fa, args, ctx, batches[-1])
    np.savez(os.path.join(args["outdir"], "batches{}.npz".format(rank)),
             **{"{}_{}".format(k, i): v for i, b in enumerate(batches)
                for k, v in b.items()})
    if rank == 0 and args.get("save_params"):
        torch.save({k: v.detach().float().cpu()
                    for k, v in state.params.items()},
                   os.path.join(args["outdir"], "params.pt"))
    if args.get("infer"):
        # (c): one prediction per item: the greedy next token after the
        # item's last input position.
        fa.reset_launches()
        df = ctx.get_data_feed(train_mode=False)
        while not df.should_stop():
            rows = df.next_batch(CLUSTER_BATCH)
            if rows:
                x = np.asarray(rows)[:, :-1].astype(np.int64)
                logits = tr.predict(state, x)
                df.batch_results(
                    [int(t) for t in logits[:, -1].argmax(-1).cpu()])
        doc["infer_launches"] = dict(fa.launches)
    with open(os.path.join(args["outdir"], "node{}.json".format(rank)),
              "w") as f:
        json.dump(doc, f)
    if multihost.is_multiprocess():
        multihost.shutdown()


def _capture_steps(torch, fa, args, ctx, batch):
    """The live-capture part of cluster (a), in the executor: a second
    trainer (its own model, so the checked trainer's state stays as the
    driver replays it) steps on the last batch: ``CAPTURE_TIMED_STEPS``
    steps with the continuous sampler stopped and as many with it running,
    twice in turns; then it keeps stepping, the sampler on, until the
    driver's capture is done (``done`` under ``capture_dir``), having
    written ``ready`` there. Returns the step ms (CUDA events) off and
    on, the sampler's duty cycle (``profiling_overhead_frac``) and the
    B1-B3 launches of these steps."""
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.telemetry import profiling
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device=ctx.device, seed=1,
                              **dict(args["lm"], attention_impl="pallas"))
    tr = Trainer(model, optimizer=trainer.adamw(CLUSTER_LR),
                 mesh=MeshConfig(data=-1).build(), device=ctx.device)
    box = [tr.init()]
    before = dict(fa.launches)

    def steps(n):
        out = []
        for _ in range(n):
            stop = _timer(torch)
            box[0], _ = tr.train_step(box[0], batch)
            out.append(stop())
        return out

    steps(1)
    off, on = [], []
    for _ in range(2):
        profiling.stop()
        off += steps(CAPTURE_TIMED_STEPS)
        sampler = profiling.start()
        on += steps(CAPTURE_TIMED_STEPS)
    open(os.path.join(args["capture_dir"], "ready"), "w").close()
    during = []
    t0 = time.monotonic()
    while not os.path.exists(os.path.join(args["capture_dir"], "done")) \
            and time.monotonic() - t0 < 300.0:
        during += steps(1)
    return {"off_ms": off, "on_ms": on, "during_ms": during,
            "duty": sampler.duty_cycle(), "hz": sampler.hz,
            "samples": sampler.samples,
            "launches": {k: fa.launches[k] - before[k] for k in before}}


def _lm_trainer(torch, lm, grad_accum=1):
    """The driver's in-process trainer, from the executors' initial
    weights (seed 0): ``(trainer, state, initial f32 parameters)``."""
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device="cuda", seed=0,
                              **dict(lm, attention_impl="pallas"))
    tr = Trainer(model, optimizer=trainer.adamw(CLUSTER_LR),
                 grad_accum=grad_accum)
    state = tr.init()
    initial = {k: v.detach().float().clone()
               for k, v in state.params.items()}
    return tr, state, initial


def _replay(torch, lm, batch_sets, grad_accum=1):
    """One in-process trainer over ``batch_sets`` (each step's batches,
    concatenated, one microbatch each under ``grad_accum``): its losses,
    per-step milliseconds, initial parameters, step-1 gradients, trainer
    and final state."""
    tr, state, initial = _lm_trainer(torch, lm, grad_accum)
    losses, ms, grads1 = [], [], None
    for parts in batch_sets:
        batch = {k: np.concatenate([b[k] for b in parts]) for k in parts[0]}
        stop = _timer(torch)
        state, m = tr.train_step(state, batch)
        ms.append(stop())
        losses.append(float(m["loss"]))
        if grads1 is None:
            grads1 = {k: p.grad.detach().float().clone()
                      for k, p in state.params.items()}
    return losses, ms, initial, grads1, tr, state


def _ddp_mean_replay(torch, lm, batch_sets):
    """The fault the data-parallel step is held against: plain DDP, where
    each rank back-propagates its local masked mean and the ranks'
    gradients are averaged. Returns the final parameters."""
    tr, state, _ = _lm_trainer(torch, lm)
    tr.model.train()
    for parts in batch_sets:
        state.optimizer.zero_grad(set_to_none=True)
        for b in parts:
            t = {k: torch.as_tensor(v, device=tr.device)
                 for k, v in b.items()}
            (tr.loss_fn(tr.model(t["x"]), t) / len(parts)).backward()
        state.optimizer.step()
    return {k: v.detach().float() for k, v in state.params.items()}


def _update_errors(initial, got, want, near):
    """The update ``got - initial`` against ``want - initial``: relative in
    norm over the elements not in ``near``, and the largest absolute
    difference over those in it."""
    num = den = 0.0
    near_max = 0.0
    for name, w in want.items():
        diff = got[name] - w
        far = ~near[name]
        num += float(diff[far].square().sum())
        den += float((w - initial[name])[far].square().sum())
        if bool(near[name].any()):
            near_max = max(near_max, float(diff[near[name]].abs().max()))
    return (num / den) ** 0.5, near_max


def _load_batches(path, steps):
    z = np.load(path)
    return [{k: z["{}_{}".format(k, i)] for k in ("x", "y", "mask")}
            for i in range(steps)]


def _run_cluster(torch, n, args, parts, infer_parts=None, between=None,
                 **run_kw):
    """``cluster.run`` -> ``train`` (-> ``between(cluster)``) (->
    ``inference``) -> ``shutdown`` on a ``LocalBackend(n)``; returns the
    nodes' documents, the inference results, and the bring-up: seconds
    from ``cluster.run`` to its return (``ready``) and to each node's
    marks, the earliest node's (``enter``: the node program starts in its
    compute child; ``joined``: the process group; ``built``: model and
    trainer; ``first_step``: the first batch in hand). ``run_kw`` go to
    ``cluster.run``."""
    from tensorflowonspark_tpu_torch import backend, cluster

    pool = backend.LocalBackend(n, base_dir=os.path.join(args["outdir"],
                                                         "executors"))
    results = None
    try:
        t_run = time.time()
        c = cluster.run(pool, cluster_node, args, num_executors=n,
                        input_mode=cluster.InputMode.FEED,
                        reservation_timeout=300, **run_kw)
        ready = time.time() - t_run
        try:
            c.train(backend.Partitioned(parts), timeout=600)
            if between is not None:
                between(c)
            if infer_parts is not None:
                results = c.inference(backend.Partitioned(infer_parts),
                                      timeout=600)
        finally:
            c.shutdown(timeout=600)
    finally:
        pool.stop()
    docs = []
    for r in range(n):
        with open(os.path.join(args["outdir"], "node{}.json".format(r))) as f:
            docs.append(json.load(f))
    bring_up = {"ready": ready}
    for mark in ("enter", "joined", "built", "first_step"):
        bring_up[mark] = min(d["marks"][mark] for d in docs) - t_run
    return docs, results, bring_up


def _check_live_capture(torch, fa, lm, doc, cap, card):
    """Cluster (a)'s live capture: the bundle, the profile window's
    kernels, the sampler's cost and the merged timeline's bring-up."""
    from tensorflowonspark_tpu_torch.train import profiler

    bundle = cap.get("bundle")
    if bundle is None:
        raise AssertionError("live capture wrote no bundle ({:.2f} s)"
                             .format(cap.get("s", 0.0)))
    man, nodes, rings, events = _read_bundle(bundle)
    snap = nodes.get("node0", {})
    run_dir = snap.get("profile_dir")
    kernels = profiler.kernel_names(run_dir)
    found = {k: sum(n for name, n in kernels.items() if v in name)
             for k, v in FLASH_KERNELS.items()}
    trace_bytes = sum(os.path.getsize(p)
                      for p in profiler.trace_files(run_dir))
    cp = doc["capture"]
    n_steps = 1 + 4 * CAPTURE_TIMED_STEPS + len(cp["during_ms"])
    prof = snap.get("profile") or {}
    checks = {
        "captured live, executor 0": man["nodes_captured"] == ["0"]
        and man["nodes_missing"] == [] and "via" not in snap,
        "a folded-stack window": os.path.isfile(os.path.join(
            bundle, "profiles", "node0.folded")) and bool(prof.get("digest")),
        "a torch.profiler trace": bool(profiler.trace_files(run_dir)),
        "B1, B2 and B3 in the trace": all(found.values()),
        "capture steps launched {} a kernel".format(n_steps * lm[
            "num_layers"]): cp["launches"] == dict.fromkeys(
                fa.launches, n_steps * lm["num_layers"]),
        "ring holds train steps' spans": bool(rings.get("node0")),
    }
    # The merged timeline's bring-up: each process's first event of a
    # name, on the driver's clock (from the rendezvous exchange).
    pids = {e["pid"]: e["args"]["name"] for e in events or ()
            if e["ph"] == "M"}
    firsts = {}
    for e in events or ():
        if e["ph"] != "M":
            key = "{} {}".format(pids[e["pid"]][5:], e["name"])
            firsts[key] = min(firsts.get(key, e["ts"]), e["ts"])
    t0 = min(firsts.values()) if firsts else 0.0
    order = sorted(firsts, key=firsts.get)[:12]
    log("cluster (a) live capture: {:.2f} s (profile window {:g} s, "
        "snapshot budget {:g} s); bundle {} captured {} missing {}; folded "
        "window {} samples, sampler duty {}; torch.profiler trace {} bytes, "
        "device kernels {} kinds, B1/B2/B3 kernels in the window {}; the "
        "executor's steps while sampled {:.2f} ms (median of {}); on "
        "{}".format(
            cap["s"], CAPTURE_PROFILE_SECS, CAPTURE_NODE_TIMEOUT,
            os.path.basename(bundle), man["nodes_captured"],
            man["nodes_missing"], (prof.get("digest") or {}).get("samples"),
            prof.get("duty"), trace_bytes, len(kernels), found,
            float(np.median(cp["during_ms"])) if cp["during_ms"] else -1.0,
            len(cp["during_ms"]), card))
    log("cluster (a) continuous sampler at {:g} Hz in the executor: "
        "profiling_overhead_frac {:.5f} ({} samples); step {:.2f} ms "
        "sampler off, {:.2f} ms on (CUDA events, medians of {} steps each, "
        "in turns), steps off {} on {}; on {}".format(
            cp["hz"], cp["duty"], cp["samples"],
            float(np.median(cp["off_ms"])), float(np.median(cp["on_ms"])),
            len(cp["off_ms"]), ["{:.2f}".format(x) for x in cp["off_ms"]],
            ["{:.2f}".format(x) for x in cp["on_ms"]], card))
    log("cluster (a) merged bundle timeline, each process's first event "
        "(s after the first): {}".format(", ".join(
            "{} +{:.3f}".format(k, (firsts[k] - t0) / 1e6) for k in order)))
    if run_dir:  # the window's temporary root, on this host
        import shutil

        shutil.rmtree(os.path.dirname(os.path.dirname(os.path.dirname(
            run_dir))), ignore_errors=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("cluster (a) live capture failed: {} (kernels "
                             "{})".format(failed, sorted(kernels)[:20]))


def _bring_up_text(bring_up):
    return ", ".join("{} {:.1f} s".format(k, v) for k, v in bring_up.items())


def cluster_phase(torch, fa, card):
    """``cluster.run`` -> ``train`` -> ``inference`` -> ``shutdown`` over
    spawned executors: (a) one executor at GPT-2-small width, B1-B3 from
    the executor, step 1 (and every step) against the driver's in-process
    trainer on the same batch, and a live incident capture with a profile
    window while the executor steps, the sampler timed off and on; (b)
    two executors on the one card, data=2,
    replicas bitwise equal after every step, against one in-process
    trainer on the concatenated global batches, one rank on a zero batch;
    (c) ``c.inference`` against in-process ``predict``; (d) the report.
    Returns the executors' launches of each flash kernel."""
    import shutil
    import tempfile

    from tensorflowonspark_tpu_torch.parallel import multihost

    lm = GPT2_SMALL
    layers = lm["num_layers"]
    total = dict.fromkeys(fa.launches, 0)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="tfos-cluster-")
    try:
        # (a) + (c): one executor.
        out = os.path.join(root, "one")
        os.makedirs(out)
        rows = _cluster_rows(lm, CLUSTER_STEPS * CLUSTER_BATCH, seed=11)
        infer_rows = _cluster_rows(lm, CLUSTER_INFER_PARTS * CLUSTER_BATCH,
                                   seed=12)
        parts = [rows[i:i + 2 * CLUSTER_BATCH]
                 for i in range(0, len(rows), 2 * CLUSTER_BATCH)]
        infer_parts = [infer_rows[i:i + CLUSTER_BATCH]
                       for i in range(0, len(infer_rows), CLUSTER_BATCH)]
        cap_dir = os.path.join(out, "capture")
        os.makedirs(cap_dir)
        args = {"outdir": out, "steps": CLUSTER_STEPS, "lm": lm,
                "infer": True, "capture_dir": cap_dir}
        tdir = os.path.join(out, "telemetry")
        cap = {}

        def capture(c):
            """A live capture while the executor steps (see
            :func:`_capture_steps`), with a profile window."""
            deadline = time.monotonic() + 600.0
            while not os.path.exists(os.path.join(cap_dir, "ready")):
                if time.monotonic() > deadline:
                    raise AssertionError("the executor never got ready")
                time.sleep(0.05)
            c.incidents.profile_secs = CAPTURE_PROFILE_SECS
            c.incidents.node_timeout = CAPTURE_NODE_TIMEOUT
            t0 = time.perf_counter()
            try:
                cap["bundle"] = c.capture_incident("manual")
            finally:
                cap["s"] = time.perf_counter() - t0
                open(os.path.join(cap_dir, "done"), "w").close()

        # The executor runs the continuous sampler (the telemetry plane's
        # default; the rest of the script runs without it); the driver
        # exports its spans beside the executor's, for the merged
        # timeline.
        from tensorflowonspark_tpu_torch import telemetry

        os.environ["TFOS_PROFILING"] = "1"
        telemetry.configure(node_id="driver", export_dir=tdir)
        try:
            (doc,), results, bring_up = _run_cluster(
                torch, 1, args, parts, infer_parts, between=capture,
                telemetry_dir=tdir, incident_dir=os.path.join(out,
                                                               "incidents"))
        finally:
            telemetry.disable()
            os.environ["TFOS_PROFILING"] = "0"
        _check_live_capture(torch, fa, lm, doc, cap, card)
        want = dict.fromkeys(fa.launches, CLUSTER_STEPS * layers)
        if len(doc["losses"]) != CLUSTER_STEPS or \
                doc["train_launches"] != want:
            raise AssertionError("one executor: {} steps, launches {}; "
                                 "want {} and {}".format(
                                     len(doc["losses"]),
                                     doc["train_launches"], CLUSTER_STEPS,
                                     want))
        losses = doc["losses"]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError("executor losses not finite and falling: "
                                 "{}".format(losses))
        batches = _load_batches(os.path.join(out, "batches0.npz"),
                                CLUSTER_STEPS)
        ref_losses, ref_ms, _, _, tr, state = _replay(
            torch, lm, [[b] for b in batches])
        diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
        log("cluster (a) 1 executor, {} layers, width {}, b{} s{} bf16 "
            "pallas adamw({:g}), {} steps over sync_batches: losses {}; in-process "
            "trainer on the same batches {}; differences {} (step 1 limit: "
            "rel {:g}); B1-B3 launches in the executor {}".format(
                layers, lm["embed_dim"], CLUSTER_BATCH, lm["max_seq_len"],
                CLUSTER_LR, CLUSTER_STEPS,
                ["{:.4f}".format(x) for x in losses],
                ["{:.4f}".format(x) for x in ref_losses],
                ["{:.3g}".format(d) for d in diffs], TRAIN_LOSS_RTOL,
                doc["train_launches"]))
        if not diffs[0] <= TRAIN_LOSS_RTOL * abs(ref_losses[0]):
            raise AssertionError("executor step 1 loss {} vs in-process "
                                 "{}".format(losses[0], ref_losses[0]))
        # (c): one prediction per item, by partition, against predict.
        want_pred = []
        for part in infer_parts:
            x = np.asarray(part)[:, :-1].astype(np.int64)
            logits = tr.predict(state, x)
            want_pred.append([int(t) for t in
                              logits[:, -1].argmax(-1).cpu()])
        if results != want_pred:
            raise AssertionError("c.inference {} != in-process predict "
                                 "{}".format(results, want_pred))
        infer_want = dict(flash_fwd=CLUSTER_INFER_PARTS * layers,
                          flash_bwd_dq=0, flash_bwd_dkv=0)
        if doc["infer_launches"] != infer_want:
            raise AssertionError("inference launches {}, want {}".format(
                doc["infer_launches"], infer_want))
        log("cluster (c) c.inference: {} partitions x {} items, one "
            "prediction per item, equal to in-process predict; B1 "
            "launches {}".format(len(results), CLUSTER_BATCH,
                                 doc["infer_launches"]["flash_fwd"]))
        for name in total:
            total[name] += doc["train_launches"][name] + \
                doc["infer_launches"][name] + \
                doc["capture"]["launches"][name]
        del tr, state
        torch.cuda.empty_cache()
        log("cluster (d) executor step {:.2f} ms (CUDA events, median of "
            "steps 2-{}) vs in-process {:.2f} ms; feed wait {:.2f} ms a "
            "step (median of steps 2-{}); peak memory {:.2f} GiB; "
            "from cluster.run: {}; on {}".format(
                float(np.median(doc["step_ms"][1:])), CLUSTER_STEPS,
                float(np.median(ref_ms[1:])),
                float(np.median(doc["wait_ms"][1:])), CLUSTER_STEPS,
                doc["peak_bytes"] / 2 ** 30, _bring_up_text(bring_up),
                card))

        # (b): two executors on the one card, data=2.
        out = os.path.join(root, "two")
        os.makedirs(out)
        dp_lm = dict(lm, num_layers=CLUSTER_DP_LAYERS)
        rows = _cluster_rows(lm, sum(CLUSTER_DP_PARTS), seed=13)
        parts, at = [], 0
        for n in CLUSTER_DP_PARTS:
            parts.append(rows[at:at + n])
            at += n
        args = {"outdir": out, "steps": 10 ** 6, "lm": dp_lm,
                "save_params": True}
        docs, _, bring_up = _run_cluster(torch, 2, args, parts)
        steps = len(docs[0]["losses"])
        per_rank = [_load_batches(os.path.join(out, "batches{}.npz".format(
            r)), steps) for r in (0, 1)]
        zero_rank_steps = [sum(float(b["mask"].sum()) == 0 for b in pr)
                           for pr in per_rank]
        trained_rows = sum(float(b["mask"][:, 0].sum())
                           for pr in per_rank for b in pr)
        checks = {
            "steps agree": len(docs[1]["losses"]) == steps >= 3,
            "losses agree": docs[0]["losses"] == docs[1]["losses"],
            "replicas bitwise equal every step": all(
                d["equal"] == [True] * steps for d in docs),
            "every row trained once": trained_rows == len(rows),
            "a rank trained on a zero batch": any(zero_rank_steps),
            "backend gloo": [d["backend"] for d in docs] == ["gloo"] * 2,
        }
        global_steps = list(zip(*per_rank))
        ref_losses, _, initial, grads1, _, ref_state = _replay(
            torch, dp_lm, global_steps, grad_accum=2)
        want_params = {k: v.detach().float()
                       for k, v in ref_state.params.items()}
        del ref_state
        near = {k: g.abs() < CLUSTER_ADAM_NEAR_EPS for k, g in grads1.items()}
        del grads1
        got = {k: v.to("cuda")
               for k, v in torch.load(os.path.join(out, "params.pt"),
                                      weights_only=True).items()}
        update_rel, near_max = _update_errors(initial, got, want_params, near)
        del want_params
        torch.cuda.empty_cache()
        fault_rel, _ = _update_errors(
            initial, got, _ddp_mean_replay(torch, dp_lm, global_steps), near)
        near_share = (sum(int(m.sum()) for m in near.values())
                      / sum(m.numel() for m in near.values()))
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(docs[0]["losses"], ref_losses))
        checks["losses within {:g} of the in-process trainer's".format(
            CLUSTER_DP_LOSS_RTOL)] = loss_rel <= CLUSTER_DP_LOSS_RTOL
        checks["update within {:g} of the in-process trainer's".format(
            CLUSTER_DP_UPDATE_RTOL)] = update_rel <= CLUSTER_DP_UPDATE_RTOL
        checks["near-eps elements within 2 lr a step"] = \
            near_max <= 2 * steps * CLUSTER_LR
        checks["plain DDP averaging beyond the update limit"] = \
            fault_rel > CLUSTER_DP_UPDATE_RTOL
        del got, initial, near
        torch.cuda.empty_cache()
        want = dict.fromkeys(fa.launches, steps * CLUSTER_DP_LAYERS)
        for d in docs:
            checks["rank {} launches".format(d["rank"])] = \
                d["train_launches"] == want
            for name in total:
                total[name] += d["train_launches"][name]
        log("cluster (b) 2 executors on one device, data=2, {} layers, b8 "
            "a rank: backend {} ({}); {} steps, "
            "losses {}; in-process trainer (grad_accum=2) on the global "
            "batches {} (max rel {:.3g}); update rel error {:.3g} over the "
            "elements above the near-eps gradient, {:.3g} abs at most on "
            "the {:.3g} share below it; plain DDP averaging's update rel "
            "error {:.3g}; zero-batch steps per "
            "rank {}; launches per rank {}; peak memory per rank {} GiB; "
            "step {} ms per rank (median); from cluster.run: "
            "{}".format(
                CLUSTER_DP_LAYERS, docs[0]["backend"],
                docs[0]["backend_reason"], steps,
                ["{:.4f}".format(x) for x in docs[0]["losses"]],
                ["{:.4f}".format(x) for x in ref_losses], loss_rel,
                update_rel, near_max, near_share, fault_rel, zero_rank_steps,
                [d["train_launches"] for d in docs],
                ["{:.2f}".format(d["peak_bytes"] / 2 ** 30) for d in docs],
                ["{:.2f}".format(float(np.median(d["step_ms"])))
                 for d in docs], _bring_up_text(bring_up)))
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError("cluster (b) failed: {}".format(failed))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if multihost.is_multiprocess():
        raise AssertionError("the driver joined a process group")
    return total


# -- the FILES-mode data tier: record files into training --------------------

# (a) GPT-2-small at ``_lm_trainer``'s geometry from record files: token
# documents made from a seed (vocab 50257, lengths log-uniform over
# 16-3072 tokens) in 8 shards, read by two executors in FILES mode (each
# its 4 shards), packed into b8 x s1024 rows, 6 steps of ``Trainer.fit``
# a rank over data=2 on the one card (gloo).
FILES_DOCS = 320
FILES_SHARDS = 8
FILES_DOC_LEN = (16, 3072)
FILES_STEPS = 6
FILES_ROWS = 8
FILES_READ_BATCH = 16
FILES_COLUMNS = {"tokens": ("int64", FILES_DOC_LEN[1]),
                 "length": ("int64", 1)}
# (b) ``bench_resnet50_piped``'s feed: 1024 uint8 images of 224x224x3 in
# 8 shards, 1000 labels, b256, a two-worker decode pool with the
# shared-memory transport and a batch cache; two epochs (4 steps each),
# the second replayed from the cache. kill_decode_worker fires after the
# consumer's batch 1 of 4. The pool decodes a whole epoch ahead of the
# steps, so the trained run's pipeline buffers one batch (prefetch=1):
# its producer then waits for the consumer, and the pool's next sweep,
# after the kill, sees the death and respawns the worker.
FILES_IMAGES = 1024
FILES_IMAGE = (224, 224, 3)
FILES_KILL_AFTER = 1


def strip_padding(batch):
    """The (a) pipeline's transform: each live record's document without
    its zero padding (a ragged column, as an object array)."""
    docs = [np.asarray(t[:n], np.int32) for t, n, m in zip(
        batch["tokens"], batch["length"], batch["mask"]) if m]
    out = np.empty(len(docs), object)
    out[:] = docs
    return {"docs": out}


def files_lm_batches(path, shard):
    """The (a) stream of one shard: ``InputPipeline`` (one reader thread,
    inline decode) -> ``strip_padding`` -> ``packed_batches``."""
    from tensorflowonspark_tpu_torch.data import packing
    from tensorflowonspark_tpu_torch.data.input_pipeline import (
        InputPipeline,
    )

    pipe = InputPipeline(path, FILES_COLUMNS, batch_size=FILES_READ_BATCH,
                         shard=shard, reader_threads=1,
                         transform=strip_padding)
    docs = (d for b in pipe for d in b["docs"])
    return packing.packed_batches(docs, seq_len=GPT2_SMALL["max_seq_len"],
                                  batch_rows=FILES_ROWS)


class FlipOdd:
    """The (b) pipeline's transform, numpy only: the uint8 column as
    (n, 224, 224, 3) images, those of odd record index flipped left to
    right (the ``_base_index`` hint keeps it the same on any worker)."""

    wants_base_index = True

    def __call__(self, batch):
        base = batch.pop("_base_index")
        x = batch["image"].reshape((-1,) + FILES_IMAGE)
        odd = (base + np.arange(len(x))) % 2 == 1
        x[odd] = x[odd][:, :, ::-1]
        return {"x": x, "y": batch["label"].astype(np.int32)}


def _wait_sum(telemetry):
    """Seconds of ``train_data_wait_seconds`` observed so far (``fit`` adds
    each step's wait for its batch)."""
    h = telemetry.hist_export(["train_data_wait_seconds"]).get(
        "train_data_wait_seconds")
    return h["sum"] if h else 0.0


def files_node(args, ctx):
    """The (a) node program (FILES mode): join data=2, read this executor's
    shards, train ``args["steps"]`` chunks of one step through
    ``Trainer.fit``, replicas compared after each."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import telemetry
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.parallel import MeshConfig, multihost
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    ctx.initialize_distributed()
    rank = multihost.process_index()
    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device=ctx.device, seed=0,
                              **dict(GPT2_SMALL, attention_impl="pallas"))
    tr = Trainer(model, optimizer=trainer.adamw(CLUSTER_LR),
                 mesh=MeshConfig(data=-1).build(), device=ctx.device)
    state = tr.init()
    seen = []

    def source():
        for b in files_lm_batches(args["data"], (2, ctx.worker_num)):
            seen.append(b)
            yield b

    it = source()
    doc = {"rank": rank, "worker": ctx.worker_num,
           "backend": getattr(ctx, "distributed_backend", None),
           "losses": [], "step_ms": [], "wait_ms": [], "equal": []}
    fa.reset_launches()
    for _ in range(args["steps"]):
        stop = _timer(torch)
        waited = _wait_sum(telemetry)
        state, hist = tr.fit(state, it, steps=1, flush_every=1)
        doc["step_ms"].append(stop())
        doc["wait_ms"].append(1e3 * (_wait_sum(telemetry) - waited))
        doc["losses"].append(float(hist[-1]["loss"]))
        doc["equal"].append(_params_equal_to_rank0(torch, dist, state))
    it.close()
    doc["launches"] = dict(fa.launches)
    doc["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    np.savez(os.path.join(args["outdir"], "files{}.npz".format(rank)),
             **{"{}_{}".format(k, i): v for i, b in enumerate(seen)
                for k, v in b.items()})
    with open(os.path.join(args["outdir"], "files{}.json".format(rank)),
              "w") as f:
        json.dump(doc, f)
    multihost.shutdown()


def _files_corpus(path):
    """(a)'s documents, written with ``dfutil.save_as_tfrecords``."""
    from tensorflowonspark_tpu_torch.data import dfutil

    rng = np.random.RandomState(17)
    lo, hi = FILES_DOC_LEN
    lens = np.exp(rng.uniform(np.log(lo), np.log(hi),
                              size=FILES_DOCS)).astype(int)
    rows = [{"tokens": rng.randint(1, GPT2_SMALL["vocab_size"],
                                   size=k).tolist(), "length": int(k)}
            for k in lens]
    dfutil.save_as_tfrecords(rows, path, num_shards=FILES_SHARDS)
    return int(lens.sum())


def _batches_equal(got, want):
    return len(got) == len(want) and all(
        g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in w)
        for g, w in zip(got, want))


def _padding_step(torch, fa, batch):
    """The extra checked step: ``batch`` with its last row padding alone
    (segment 0 everywhere), from the initial weights, through B1-B3 and
    through their plain versions on the card; and once more through
    B1-B3 with the padding row's tokens changed. Returns the readings."""
    batch = {k: v.copy() for k, v in batch.items()}
    for k in ("x", "y", "segment_ids", "positions"):
        batch[k][-1] = 0
    other = {k: v.copy() for k, v in batch.items()}
    other["x"][-1] = np.random.RandomState(3).randint(
        1, GPT2_SMALL["vocab_size"], size=other["x"].shape[1])
    other["y"] = other["x"]
    tr, state, _ = _lm_trainer(torch, GPT2_SMALL)
    initial = {k: v.detach().clone() for k, v in state.params.items()}
    out = {}
    for label, b, plain in (("kernels", batch, False),
                            ("plain", batch, True),
                            ("changed", other, False)):
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(initial[k])
        before = dict(fa.launches)
        with _plain_flash(fa) if plain else contextlib.nullcontext():
            state, m = tr.train_step(state, b)
        out[label] = {
            "loss": float(m["loss"]),
            "norms": grad_norms(state),
            "launches": {n: fa.launches[n] - before[n] for n in fa.launches},
            "grads": [p.grad.detach().clone()
                      for p in state.params.values()]}
    del tr, state, initial
    torch.cuda.empty_cache()
    return out


def files_lm(torch, fa, root, card):
    """(a): returns the flash launches of both ranks and the readings."""
    from tensorflowonspark_tpu_torch import backend, cluster
    from tensorflowonspark_tpu_torch.data import packing

    data = os.path.join(root, "docs")
    tokens = _files_corpus(data)
    inline = [list(itertools.islice(files_lm_batches(data, (2, r)),
                                    FILES_STEPS)) for r in (0, 1)]
    if any(len(b) < FILES_STEPS for b in inline):
        raise AssertionError("a shard packs fewer than {} batches".format(
            FILES_STEPS))
    out = os.path.join(root, "lm")
    os.makedirs(out)
    pool = backend.LocalBackend(2, base_dir=os.path.join(out, "executors"))
    t_run = time.time()
    try:
        c = cluster.run(pool, files_node,
                        {"data": data, "outdir": out, "steps": FILES_STEPS},
                        num_executors=2, input_mode=cluster.InputMode.FILES,
                        reservation_timeout=300)
        c.shutdown(timeout=600)
    finally:
        pool.stop()
    cluster_s = time.time() - t_run
    docs = []
    for r in (0, 1):
        with open(os.path.join(out, "files{}.json".format(r))) as f:
            docs.append(json.load(f))
    seen = []
    for r in (0, 1):
        z = np.load(os.path.join(out, "files{}.npz".format(r)))
        n = len({k.rsplit("_", 1)[1] for k in z.files})
        seen.append([{k: z["{}_{}".format(k, i)]
                      for k in ("x", "y", "segment_ids", "positions")}
                     for i in range(n)])
    layers = GPT2_SMALL["num_layers"]
    want = dict.fromkeys(fa.launches, FILES_STEPS * layers)
    losses = docs[0]["losses"]
    checks = {
        "backend gloo": [d["backend"] for d in docs] == ["gloo"] * 2,
        "each rank's batches bitwise the driver's inline pipeline": all(
            _batches_equal(seen[d["rank"]][:FILES_STEPS],
                           inline[d["worker"]]) for d in docs),
        "losses equal across ranks": docs[1]["losses"] == losses,
        "losses finite and falling": bool(
            np.all(np.isfinite(losses))) and losses[-1] < losses[0],
        "replicas bitwise equal every step": all(
            d["equal"] == [True] * FILES_STEPS for d in docs),
        "B1-B3 steps x 12 a rank": all(d["launches"] == want for d in docs),
    }
    global_steps = [[inline[0][0], inline[1][0]]]
    ref_losses, _, _, _, _, _ = _replay(torch, GPT2_SMALL, global_steps,
                                        grad_accum=2)
    step1_rel = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    checks["step 1 within {:g} of one trainer on the global batch".format(
        TRAIN_LOSS_RTOL)] = step1_rel <= TRAIN_LOSS_RTOL
    torch.cuda.empty_cache()
    pad = _padding_step(torch, fa, inline[0][0])
    k, p, ch = pad["kernels"], pad["plain"], pad["changed"]
    pad_loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    pad_norm_rel = max(abs(k["norms"][n] - p["norms"][n]) / p["norms"][n]
                       for n in p["norms"])
    changed_max = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(k["grads"], ch["grads"]))
    checks["padding row: finite loss"] = bool(np.isfinite(k["loss"]))
    checks["padding row: B1-B3 against the plain versions"] = (
        pad_loss_rel <= TRAIN_LOSS_RTOL
        and pad_norm_rel <= TRAIN_GRAD_NORM_RTOL)
    checks["padding row: its tokens move no gradient"] = (
        ch["loss"] == k["loss"] and changed_max == 0.0)
    checks["padding step: 12 launches of each kernel"] = (
        k["launches"] == dict.fromkeys(fa.launches, layers))
    del pad
    torch.cuda.empty_cache()
    rows = [b for r in (0, 1) for b in seen[r][:FILES_STEPS]]
    segs = np.concatenate([b["segment_ids"] for b in rows])
    eff = packing.packing_efficiency({"segment_ids": segs})
    docs_a_row = float(np.mean(segs.max(axis=1)))
    log("files (a) GPT-2-small ({} layers, width {}) from {} documents "
        "({} tokens, lengths log-uniform {}-{}) in {} record shards, "
        "FILES mode, 2 executors on one device, data=2 over {}: InputPipeline"
        "(shard=(2, i), reader_threads=1) -> strip padding -> packed_batches"
        "(s{}, {} rows) -> Trainer.fit, {} steps; {:.2f} documents a row, "
        "padding share {:.4f} (packing_efficiency {:.4f}); losses {}; "
        "in-process trainer (grad_accum=2) step 1 {:.4f} (rel {:.3g}, "
        "limit {:g}); launches a rank {}; step ms a rank (CUDA events "
        "around fit) {}; train_data_wait_seconds a step, ms, a rank {}; "
        "peak memory a rank {} GiB; cluster.run to shutdown "
        "{:.1f} s".format(
            layers, GPT2_SMALL["embed_dim"], FILES_DOCS, tokens,
            FILES_DOC_LEN[0], FILES_DOC_LEN[1], FILES_SHARDS,
            docs[0]["backend"], GPT2_SMALL["max_seq_len"], FILES_ROWS,
            FILES_STEPS, docs_a_row, 1 - eff, eff,
            ["{:.4f}".format(x) for x in losses], ref_losses[0], step1_rel,
            TRAIN_LOSS_RTOL, [d["launches"] for d in docs],
            [["{:.2f}".format(x) for x in d["step_ms"]] for d in docs],
            [["{:.3f}".format(x) for x in d["wait_ms"]] for d in docs],
            ["{:.2f}".format(d["peak_bytes"] / 2 ** 30) for d in docs],
            cluster_s))
    log("files (a) padding row (segment 0 everywhere) in a b{} x s{} "
        "step: loss {:.6f} through B1-B3, {:.6f} through their plain "
        "versions (rel {:.3g}; gradient norms rel {:.3g}, limits {:g} and "
        "{:g}); the padding row's tokens changed: loss {:.6f}, largest "
        "gradient difference {:.3g}; launches {} on {}".format(
            FILES_ROWS, GPT2_SMALL["max_seq_len"], k["loss"], p["loss"],
            pad_loss_rel, pad_norm_rel, TRAIN_LOSS_RTOL,
            TRAIN_GRAD_NORM_RTOL, ch["loss"], changed_max,
            k["launches"], card))
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("files (a) failed: {}".format(failed))
    total = {n: sum(d["launches"][n] for d in docs) + k["launches"][n]
             + ch["launches"][n] for n in fa.launches}
    return total


def files_images(torch, root, card):
    """(b): the piped ResNet-50 image feed."""
    from tensorflowonspark_tpu_torch import telemetry
    from tensorflowonspark_tpu_torch.data import decode_pool, dfutil
    from tensorflowonspark_tpu_torch.data import image_preprocessing as ip
    from tensorflowonspark_tpu_torch.data.input_pipeline import (
        InputPipeline,
    )
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.testing import faults
    from tensorflowonspark_tpu_torch.train import Trainer, trainer
    from tensorflowonspark_tpu_torch.train.prefetch import DevicePrefetch

    flat = int(np.prod(FILES_IMAGE))
    data = os.path.join(root, "images")
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    rows = [{"image": rng.randint(0, 256, size=flat, dtype=np.uint8)
             .tobytes(), "label": int(rng.randint(1000))}
            for _ in range(FILES_IMAGES)]
    dfutil.save_as_tfrecords(rows, data, schema={
        "image": dfutil.BINARY, "label": dfutil.INT64},
        num_shards=FILES_SHARDS)
    del rows
    write_s = time.perf_counter() - t0
    try:
        import PIL  # noqa: F401
        pil = "PIL present"
    except ImportError:
        pil = "no PIL"
    columns = {"image": ("uint8", flat), "label": ("int64", 1)}
    kw = dict(batch_size=RESNET_BATCH, shuffle_files=True, seed=0,
              drop_remainder=True, prefetch=4, transform=FlipOdd())
    per_epoch = FILES_IMAGES // RESNET_BATCH

    def feed_only(**more):
        """Three epochs of a pipeline alone: the first epoch's batches, and
        images/s from the first batch's arrival to the last's (the pool's
        start left out)."""
        got, stamps = [], []
        for b in InputPipeline(data, columns, epochs=3, **dict(kw, **more)):
            got.append(b)
            stamps.append(time.perf_counter())
        return got[:per_epoch], (len(got) - 1) * RESNET_BATCH / (
            stamps[-1] - stamps[0])

    inline, inline_rate = feed_only()
    _, pool_rate = feed_only(decode_workers=2)
    cache = os.path.join(root, "cache")
    plan = faults.FaultPlan(os.path.join(root, "plan"))
    plan.kill_decode_worker(after_batches=FILES_KILL_AFTER)
    pipe = InputPipeline(data, columns, epochs=2, decode_workers=2,
                         cache_dir=cache, cache_tag="flip-odd",
                         **dict(kw, prefetch=1))
    seen, killed, pool_seen = [], [], []

    def source():
        for i, b in enumerate(pipe):
            seen.append({k: v.copy() for k, v in b.items()})
            if pipe._pool is not None:
                pool_seen.append(i)
                pid = plan.on_pool_batch(i, pipe._pool)
                if pid:
                    killed.append(pid)
                    # Until the dead worker is reaped, so the pool's next
                    # sweep (after this batch is taken) sees the death.
                    deadline = time.monotonic() + 10
                    while decode_pool._alive(pid) and \
                            time.monotonic() < deadline:
                        time.sleep(0.01)
            yield b

    model = factory.get_model("resnet50", num_classes=1000, device="cuda",
                              seed=0)
    tr = Trainer(model, optimizer=trainer.sgd(0.1, momentum=0.9),
                 input_fn=ip.input_normalizer("inception"), device="cuda")
    state = tr.init()

    class Recorder:
        """The trainer's placer, recording what reaches the card."""

        def __init__(self, placer):
            self.placer, self.device, self.placed = placer, placer.device, []

        def __call__(self, batch):
            out = self.placer(batch)
            self.placed.append((out["x"].dtype, out["x"].device.type))
            return out

    def readings():
        return (telemetry.get_counter("ingest_worker_deaths_total"),
                telemetry.get_counter("ingest_cached_batches_total"))

    before = readings()
    recorder = Recorder(tr.batch_placer)
    pin_memory = torch.Tensor.pin_memory
    pins = [0]

    def counted_pin(self, *a, **k):
        pins[0] += 1
        return pin_memory(self, *a, **k)

    torch.Tensor.pin_memory = counted_pin
    losses, step_ms, wait_ms = [], [], []
    try:
        pf = DevicePrefetch(source(), depth=2, placer=recorder)
        for _ in range(2 * per_epoch):
            stop = _timer(torch)
            waited = _wait_sum(telemetry)
            state, hist = tr.fit(state, pf, steps=1, flush_every=1)
            step_ms.append(stop())
            wait_ms.append(1e3 * (_wait_sum(telemetry) - waited))
            losses.append(float(hist[-1]["loss"]))
        pf.close()
    finally:
        torch.Tensor.pin_memory = pin_memory
    after = readings()
    deaths, cached_batches = after[0] - before[0], after[1] - before[1]
    replay_t0 = time.perf_counter()
    replay = list(InputPipeline(data, columns, epochs=1, cache_dir=cache,
                                cache_tag="flip-odd", **kw))
    replay_rate = len(replay) * RESNET_BATCH / (
        time.perf_counter() - replay_t0)
    order = np.random.RandomState(kw["seed"] + 7919 * 2).permutation(
        per_epoch)
    checks = {
        "epoch 1 on the pool bitwise the inline run":
            _batches_equal(seen[:per_epoch], inline),
        "epoch 2 replayed from the cache, bitwise epoch 1": _batches_equal(
            seen[per_epoch:], [seen[j] for j in order]),
        "a rebuilt pipeline replays epoch 1 from the cache":
            _batches_equal(replay, inline),
        "one worker killed mid epoch 1": len(killed) == 1
            and plan.fired(faults.KILL_DECODE_WORKER) == 1
            and deaths >= 1,
        "epoch 1 decoded on the pool, epoch 2 cached":
            pool_seen == list(range(per_epoch))
            and cached_batches >= per_epoch,
        "no shared-memory segment left": glob.glob(
            "/dev/shm/tfos{}p*".format(os.getpid())) == [],
        "losses finite": bool(np.all(np.isfinite(losses))),
        "x uint8 on the host": all(b["x"].dtype == np.uint8 for b in seen),
    }
    checks["uint8 batches placed on the card by DevicePrefetch, pinned"] = (
        recorder.placed == [(torch.uint8, "cuda")] * len(seen)
        and pins[0] >= 2 * len(seen))
    probe = tr.batch_placer({"x": inline[0]["x"][:2]})["x"]
    normalized = tr.input_fn(probe)
    want = probe.float().div(255).to(torch.bfloat16)
    checks["normalized on the card by input_normalizer"] = (
        normalized.is_cuda and normalized.dtype == torch.bfloat16
        and bool(torch.equal(normalized, want)))
    # Step 1 builds cuDNN's plans and waits for the pool's start.
    trained = (len(step_ms) - 1) * RESNET_BATCH / sum(step_ms[1:]) * 1e3
    log("files (b) ResNet-50 b{} {}x{} bf16 sgd(0.1, 0.9) fed from {} "
        "uint8 records in {} shards ({:.1f} s to write; {}: the records are "
        "raw uint8, bench_resnet50_piped's format): feed only {:.1f} "
        "images/s inline, {:.1f} on a 2-worker decode pool (shared memory), "
        "{:.1f} replaying the cache; trained {:.1f} images/s over steps "
        "2-{} "
        "(epoch 1 on the pool, worker pid {} SIGKILLed after batch {}, "
        "epoch 2 from the cache; {} pinned host copies); step ms {} (CUDA "
        "events around fit); train_data_wait_seconds a step {} ms; "
        "losses {} on {}".format(
            RESNET_BATCH, FILES_IMAGE[0], FILES_IMAGE[1], FILES_IMAGES,
            FILES_SHARDS, write_s, pil,
            inline_rate, pool_rate, replay_rate, trained, len(losses),
            killed, FILES_KILL_AFTER, pins[0],
            ["{:.1f}".format(x) for x in step_ms],
            ["{:.3f}".format(x) for x in wait_ms],
            ["{:.4f}".format(x) for x in losses], card))
    failed = [name for name, ok in checks.items() if not ok]
    del model, tr, state, pf, seen, inline, replay
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("files (b) failed: {}".format(failed))


def files_phase(torch, fa, card):
    """The FILES-mode data tier on the card: (a) GPT-2-small packed from
    record files by two FILES-mode executors; (b) the ResNet-50 image
    feed through a decode pool, a worker kill and a cached epoch. Returns
    (a)'s flash launches."""
    import shutil
    import tempfile

    from tensorflowonspark_tpu_torch.data import _native

    native = _native.loaded()
    if not all(native.values()):
        raise AssertionError("the data tier's native libraries did not "
                             "load: {}".format(native))
    log("files: native codecs {} built from tensorflowonspark_tpu_torch/"
        "csrc/host into {}".format(sorted(native), _native.build_dir()))
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tfos-files-")
    try:
        torch.cuda.empty_cache()
        launches = files_lm(torch, fa, root, card)
        t_a = time.perf_counter() - t0
        files_images(torch, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("files phase {:.1f} s ((a) {:.1f} s)".format(
        time.perf_counter() - t0, t_a))
    return launches


# -- recovery: supervised relaunch, elastic membership, remote agents ---------

# (a): GPT-2-small at full width, the cluster phase's geometry, one executor
# under RestartPolicy(max_restarts=1): 6 steps, a commit every 2 (a step
# directory of weights and AdamW moments is 1.49 GB, so max_to_keep is 2),
# the crash fired after step 4 commits.
RECOVER_STEPS = 6
RECOVER_INTERVAL = 2
RECOVER_CRASH_AT = 4
# (a)-(d): GPT-2-small width at a reduced depth of 2 layers ((a) ran 12
# until the export phase joined the script, which had to stay within its
# time: the relaunch's mechanics do not depend on the depth).
RECOVER_LAYERS = 2
# (b): the hang fires after step 2 commits; beats every 0.5 s and 8 missed
# beats make a hang dead within 4 s of its last beat, 4.25 s with the
# supervisor's 0.25 s poll: detection under 5 s.
RECOVER_HANG_AT = 2
RECOVER_HANG_STEPS = 4
RECOVER_HANG_HB = dict(heartbeat_interval=0.5, heartbeat_miss_budget=8)
# Free card memory before a relaunch builds its model, against the reading
# before the first attempt. A child whose CUDA context outlived the kill
# would hold its weights, moments and activations: ~10 GiB at (a)'s width.
RECOVER_MEM_SLACK = 1 << 30
# (c): two executors, each its own 2-layer model, one batch a partition;
# the preemption fires after step 3 commits, with a grace of
# RECOVER_GRACE_STEPS x (step + commit) as measured in (b).
RECOVER_ELASTIC_PARTS = 40
RECOVER_PREEMPT_AT = 3
RECOVER_GRACE_STEPS = 2.0
# (d): two agents, data=2 over gloo, 3 steps, then one batch each.
RECOVER_AGENT_STEPS = 3


def _audit(path, **doc):
    """Append one JSON line (with the wall clock and pid) to an audit log:
    what a crashed incarnation leaves for the driver to read."""
    doc.update(t=time.time(), pid=os.getpid())
    with open(path, "a") as f:
        f.write(json.dumps(doc) + "\n")


def _read_audit(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _incarnations(lines):
    """Audit lines split at each ``resume``: one list per incarnation."""
    out = []
    for line in lines:
        if line["kind"] == "resume":
            out.append([])
        out[-1].append(line)
    return out


def _recover_lm(torch, args, device):
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    model = factory.get_model("transformer", dtype=torch.bfloat16,
                              device=device, seed=0,
                              **dict(args["lm"], attention_impl="pallas"))
    return Trainer(model, optimizer=trainer.adamw(CLUSTER_LR), device=device)


def recover_node(args, ctx):
    """Node program of (a) and (b): restore the latest committed step,
    discard the feed's batches of the steps already committed (a relaunch
    is fed the whole dataset again), train, save at the interval, and poll
    the fault plan after each step. Every step appends its loss, its time,
    its commit time and this incarnation's B1-B3 launches so far to the
    audit log: a crashed incarnation returns nothing to the driver. Each
    step is also a ``train/step`` span, and the restore a ``train/resume``
    event, in the node's flight recorder (what an incident bundle
    carries)."""
    import torch

    from tensorflowonspark_tpu_torch import telemetry
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.testing.faults import FaultPlan
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    ctx.initialize_distributed()
    tr = _recover_lm(torch, args, ctx.device)
    state = tr.init()
    ckpt = CheckpointManager(args["ckpt_dir"], max_to_keep=2,
                             save_interval_steps=args["interval"])
    t0 = time.perf_counter()
    state = ckpt.restore(state)
    torch.cuda.synchronize()
    _audit(args["log"], kind="resume", step=state.step,
           restore_s=time.perf_counter() - t0)
    telemetry.event("train/resume", step=state.step)
    plan = FaultPlan(args["plan_dir"])
    fa.reset_launches()
    feed = ctx.get_data_feed(train_mode=True)
    example = np.zeros((1, args["lm"]["max_seq_len"] + 1), np.int64)
    skip = state.step
    for arrays, mask in feed.sync_batches(CLUSTER_BATCH, example=example):
        if skip:
            skip -= 1
            continue
        stop = _timer(torch)
        state, m = tr.train_step(state, _cluster_batch(arrays, mask))
        step_ms = stop()
        loss = float(m["loss"])
        telemetry.record_span("train/step", step_ms / 1e3, step=state.step)
        t1 = time.perf_counter()
        saved = ckpt.save(state)
        _audit(args["log"], kind="step", step=state.step, loss=loss,
               step_ms=step_ms, saved=saved,
               commit_s=time.perf_counter() - t1 if saved else None,
               launches=dict(fa.launches))
        plan.on_step(state.step, checkpoint_dir=args["ckpt_dir"])
    ckpt.close()


def recover_elastic_node(args, ctx):
    """Node program of (c), the port's ``elastic_linreg_fun`` with the
    2-layer LM: its own checkpoint tree per node, a commit every step, the
    resize barrier (back to the last committed step) at each directive,
    and the same audit lines as :func:`recover_node`."""
    import torch

    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.testing.faults import FaultPlan
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    node_dir = os.path.join(args["ckpt_dir"], "node{}".format(
        ctx.executor_id))
    log = os.path.join(args["log_dir"], "node{}.log".format(ctx.executor_id))
    # Independent replicas, each on the card: no process group to join.
    tr = _recover_lm(torch, args, "cuda")
    ckpt = CheckpointManager(node_dir, max_to_keep=2)
    t0 = time.perf_counter()
    state = ckpt.restore(tr.init())
    torch.cuda.synchronize()
    _audit(log, kind="resume", step=state.step,
           restore_s=time.perf_counter() - t0)
    plan = FaultPlan(args["plan_dir"])
    fa.reset_launches()
    feed = ctx.get_data_feed(train_mode=True)
    while not feed.should_stop():
        directive = ctx.poll_resize()
        if directive:
            state = ckpt.restore(state)
            _audit(log, kind="reshape", step=state.step,
                   epoch=directive.get("epoch"),
                   world_size=directive.get("world_size"))
        arrays, mask = feed.next_batch_arrays(CLUSTER_BATCH, pad_to_full=True)
        if not int(mask.sum()):
            continue
        stop = _timer(torch)
        state, m = tr.train_step(state, _cluster_batch(arrays, mask))
        step_ms = stop()
        loss = float(m["loss"])
        t1 = time.perf_counter()
        ckpt.save(state, force=True)
        _audit(log, kind="step", step=state.step, loss=loss, step_ms=step_ms,
               saved=True, commit_s=time.perf_counter() - t1,
               launches=dict(fa.launches))
        plan.on_step(state.step, checkpoint_dir=node_dir)
    ckpt.close()


class _MemoryReadingBackend:
    """A ``LocalBackend`` that reads the card's free memory each time a
    cluster submits its node bring-up: before an attempt's compute child
    builds its model. A reading after the first waits (up to ``wait``
    seconds) for the memory to come within ``RECOVER_MEM_SLACK`` of the
    first; the wait is reported. Everything else is the pool's."""

    def __init__(self, torch, pool, wait=10.0):
        self._torch = torch
        self.pool = pool
        self.num_executors = pool.num_executors
        self.wait = wait
        self.readings = []  # (free bytes, seconds waited)

    def foreach_partition(self, partitions, fn, **kw):
        from tensorflowonspark_tpu_torch import node

        if isinstance(fn, node.NodeRunner):
            free = self._torch.cuda.mem_get_info()[0]
            t0 = time.perf_counter()
            waited = 0.0
            while self.readings and waited < self.wait and \
                    free < self.readings[0][0] - RECOVER_MEM_SLACK:
                time.sleep(0.1)
                free = self._torch.cuda.mem_get_info()[0]
                waited = time.perf_counter() - t0
            self.readings.append((free, waited))
        return self.pool.foreach_partition(partitions, fn, **kw)

    def stop(self):
        self.pool.stop()


def _teardowns(telemetry, name="supervise/teardown"):
    """The driver's ``supervise/teardown`` (or ``name``) spans, oldest
    first: ``(wall start, wall end)``."""
    return [(s["ts"], s["ts"] + s["dur"]) for s in telemetry.recent_spans(500)
            if s["name"] == name]


def _supervised(torch, telemetry, root, name, lm, steps, interval, arm, hb):
    """One supervised job of :func:`recover_node` on one executor, with
    span export under ``<job>/telemetry`` and the black box armed
    (``incident_dir=<job>/incidents``): returns the report, the audit
    lines, the memory readings, the first teardown span, the checkpoint
    directory, the rows fed and the incident bundles written."""
    from tensorflowonspark_tpu_torch import backend, cluster
    from tensorflowonspark_tpu_torch.supervisor import RestartPolicy
    from tensorflowonspark_tpu_torch.testing import faults

    out = os.path.join(root, name)
    os.makedirs(out)
    plan = faults.FaultPlan(os.path.join(out, "faults"))
    arm(plan)
    args = {"lm": lm, "ckpt_dir": os.path.join(out, "ckpt"),
            "plan_dir": plan.plan_dir, "log": os.path.join(out, "audit.log"),
            "interval": interval}
    rows = _cluster_rows(lm, steps * CLUSTER_BATCH, seed=21)
    parts = [rows[i:i + 2 * CLUSTER_BATCH]
             for i in range(0, len(rows), 2 * CLUSTER_BATCH)]
    torch.cuda.empty_cache()
    spans_before = len(_teardowns(telemetry))
    captures_before = len(_teardowns(telemetry, "capture/incident"))
    pool = _MemoryReadingBackend(torch, backend.LocalBackend(
        1, base_dir=os.path.join(out, "executors")))
    try:
        sup = cluster.run(pool, recover_node, args, num_executors=1,
                          input_mode=cluster.InputMode.FEED,
                          reservation_timeout=300,
                          restart_policy=RestartPolicy(max_restarts=1,
                                                       backoff=0.5),
                          checkpoint_dir=args["ckpt_dir"],
                          telemetry_dir=os.path.join(out, "telemetry"),
                          incident_dir=os.path.join(out, "incidents"), **hb)
        report = sup.train(backend.Partitioned(parts), timeout=600)
    finally:
        pool.stop()
    teardown = _teardowns(telemetry)[spans_before:][:1]
    capture = _teardowns(telemetry, "capture/incident")[captures_before:][:1]
    if teardown and capture and capture[0][0] < teardown[0][0]:
        # The watcher detected the failure where it began the capture
        # that precedes the teardown.
        teardown = [(capture[0][0], teardown[0][1])]
    idir = os.path.join(out, "incidents")
    bundles = sorted(os.path.join(idir, b) for b in os.listdir(idir)) \
        if os.path.isdir(idir) else []
    return (report, _read_audit(args["log"]), pool.readings,
            teardown[0] if teardown else None, args["ckpt_dir"], rows,
            bundles)


def _read_bundle(bundle):
    """An incident bundle's manifest, node documents, ring spans and
    ``trace.json`` events (None when it has none)."""
    def load(*parts):
        with open(os.path.join(bundle, *parts)) as f:
            return json.load(f)

    nodes = {n[:-5]: load("nodes", n)
             for n in os.listdir(os.path.join(bundle, "nodes"))}
    rings = {}
    rings_dir = os.path.join(bundle, "rings")
    for n in os.listdir(rings_dir) if os.path.isdir(rings_dir) else ():
        with open(os.path.join(rings_dir, n)) as f:
            rings[n[:-6]] = [json.loads(line) for line in f]
    events = load("trace.json")["traceEvents"] if os.path.isfile(
        os.path.join(bundle, "trace.json")) else None
    return load("manifest.json"), nodes, rings, events


def _render_report(bundle):
    """``scripts/torch_incident_report.render`` on ``bundle``: its text."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_incident_report

    return torch_incident_report.render(bundle)


def _capture_seconds(telemetry, reason):
    """Seconds of the driver's ``capture/incident`` spans for ``reason``."""
    return [round(s["dur"], 3) for s in telemetry.recent_spans(500)
            if s["name"] == "capture/incident"
            and s["attrs"].get("reason") == reason]


def _fault_times(incs, teardown):
    """Seconds from the fault (the faulting step's audit line, written just
    before the plan fired) to its detection (the start of the incident
    capture, else of the teardown), to the end of the teardown and to the
    relaunch's first step."""
    fault = incs[0][-1]["t"]
    return {"detect": teardown[0] - fault, "teardown": teardown[1] - fault,
            "first_step": incs[1][1]["t"] - fault}


def _launch_sum(fa, last_lines):
    total = dict.fromkeys(fa.launches, 0)
    for line in last_lines:
        for k in total:
            total[k] += line["launches"][k]
    return total


def _mem_text(readings):
    return ", ".join("{:.2f} GiB free (waited {:.2f} s)".format(
        free / 2 ** 30, w) for free, w in readings)


def _mem_ok(readings):
    return len(readings) == 2 and \
        readings[1][0] >= readings[0][0] - RECOVER_MEM_SLACK


def recover_phase(torch, fa, card):
    """Supervised relaunch, elastic membership and remote agents on the
    card: (a) a crash at GPT-2-small width, the relaunch's weights bitwise
    those of an uninterrupted in-process run; (b) a hang, detected from the
    heartbeats; (c) a spot preemption absorbed in place by an elastic
    cluster; (d) the Quickstart over two ``tools/agent.py`` agents; (e) the
    report. Returns the B1-B3 launches of the phase."""
    import shutil
    import subprocess as sp
    import tempfile

    from tensorflowonspark_tpu_torch import (backend, backend_remote,
                                             cluster, telemetry)
    from tensorflowonspark_tpu_torch.supervisor import RestartPolicy
    from tensorflowonspark_tpu_torch.testing import faults
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    telemetry.configure(node_id="driver")
    total = dict.fromkeys(fa.launches, 0)
    lm_small = dict(GPT2_SMALL, num_layers=RECOVER_LAYERS)
    root = tempfile.mkdtemp(prefix="tfos-recover-")
    try:
        # (a) crash at GPT-2-small width.
        layers = RECOVER_LAYERS
        report, lines, mem, teardown, ckpt_dir, rows, bundles = _supervised(
            torch, telemetry, root, "crash", lm_small, RECOVER_STEPS,
            RECOVER_INTERVAL,
            lambda plan: plan.crash_at_step(RECOVER_CRASH_AT), {})
        incs = _incarnations(lines)
        per_inc = [inc[-1]["launches"] for inc in incs]
        batches = [_cluster_batch(rows[i:i + CLUSTER_BATCH],
                                  np.ones(CLUSTER_BATCH, bool))
                   for i in range(0, len(rows), CLUSTER_BATCH)]
        tr = _recover_lm(torch, {"lm": lm_small}, "cuda")
        state = tr.init()
        ref_losses = []
        for b in batches:
            state, m = tr.train_step(state, b)
            ref_losses.append(float(m["loss"]))
        saved = CheckpointManager(ckpt_dir).restore_variables()
        differ = [k for k, v in state.params.items()
                  if not _equal(v.detach().float(), saved[k])]
        losses = [line["loss"] for inc in incs for line in inc[1:]]
        times = _fault_times(incs, teardown)
        restore_s = incs[1][0]["restore_s"]
        del tr, state, saved
        torch.cuda.empty_cache()
        checks = {
            "restarts 1": report["restarts"] == 1,
            "resumed at committed step {}".format(RECOVER_CRASH_AT):
                [inc[0]["step"] for inc in incs] == [0, RECOVER_CRASH_AT]
                and report["failures"][0]["committed_step"]
                == RECOVER_CRASH_AT,
            "failure classified crashed":
                report["failures"][0]["kind"] == "crashed",
            "committed step {} bitwise the in-process run's".format(
                RECOVER_STEPS): not differ and
                report["committed_step"] == RECOVER_STEPS,
            "losses those of the in-process run": losses == ref_losses,
            "launches {} and {} a kernel".format(
                RECOVER_CRASH_AT * layers,
                (RECOVER_STEPS - RECOVER_CRASH_AT) * layers): per_inc == [
                    dict.fromkeys(fa.launches, RECOVER_CRASH_AT * layers),
                    dict.fromkeys(fa.launches, (RECOVER_STEPS
                                                - RECOVER_CRASH_AT) * layers)],
            "card memory back before the relaunch": _mem_ok(mem),
        }
        # The black box written before the teardown: one bundle (the rate
        # limit suppresses the second trigger of the same failure).
        man, nodes, rings, events = _read_bundle(bundles[0]) if bundles \
            else ({}, {}, {}, None)
        snap = nodes.get("node0", {})
        ring_steps = [sp["attrs"]["step"] for sp in rings.get("node0", ())
                      if sp["name"] == "train/step"]
        markers = [e["name"] for e in events or ()
                   if e["name"] in ("node/error", "train/resume")]
        report_text = _render_report(bundles[0]) if bundles else ""
        checks.update({
            "one incident bundle before the teardown": len(bundles) == 1,
            "bundle reason node_death or attempt_failure": man.get(
                "reason") in ("node_death", "attempt_failure"),
            "manifest names executor 0": "0" in man.get(
                "nodes_captured", ()),
            "executor 0's crash snapshot from the manager KV":
                snap.get("via") == "manager_kv" and "injected failure at "
                "step {}".format(RECOVER_CRASH_AT) in snap.get("error", ""),
            "ring train/step spans 1-{}".format(RECOVER_CRASH_AT):
                ring_steps == list(range(1, RECOVER_CRASH_AT + 1)),
            "trace.json with the node/error marker":
                events is not None and "node/error" in markers,
            "torch_incident_report renders it": "reason:   {}".format(
                man.get("reason")) in report_text,
        })
        log("recover (a) incident bundle {} before the teardown: reason {}, "
            "captured {} missing {}, executor 0's snapshot via {} ({}); ring "
            "train/step spans at steps {}; trace.json {} events, markers {}; "
            "report {} lines; capture {} s; on {}".format(
                os.path.basename(bundles[0]) if bundles else None,
                man.get("reason"), man.get("nodes_captured"),
                man.get("nodes_missing"), snap.get("via"), snap.get("error"),
                ring_steps, len(events or ()), markers,
                len(report_text.splitlines()),
                _capture_seconds(telemetry, man.get("reason")), card))
        launches_a = _launch_sum(fa, [inc[-1] for inc in incs])
        log("recover (a) crash at step {} of {}, {} layers, width {}, b{} "
            "s{} bf16 pallas adamw({:g}), commit every {} steps: restarts "
            "{}, failure {} at committed step {}; incarnations resumed at "
            "{}; B1-B3 launches per incarnation {} (sum {}); losses {}; "
            "step-{} weights differing from the in-process run: {}; restore "
            "{:.2f} s; card memory before each attempt: {}; seconds from "
            "the fault to detection {:.2f}, to the end of teardown {:.2f}, "
            "to the relaunch's first step {:.2f}; on {}".format(
                RECOVER_CRASH_AT, RECOVER_STEPS, layers,
                GPT2_SMALL["embed_dim"], CLUSTER_BATCH,
                GPT2_SMALL["max_seq_len"], CLUSTER_LR, RECOVER_INTERVAL,
                report["restarts"], report["failures"][0]["kind"],
                report["failures"][0]["committed_step"],
                [inc[0]["step"] for inc in incs],
                [inc[-1]["launches"]["flash_fwd"] for inc in incs],
                launches_a, ["{:.4f}".format(x) for x in losses],
                RECOVER_STEPS, differ or "none", restore_s, _mem_text(mem),
                times["detect"], times["teardown"], times["first_step"],
                card))
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError("recover (a) failed: {}".format(failed))
        for k in total:
            total[k] += launches_a[k]

        # (b) hang at 2 layers.
        def arm_hang(plan):
            plan.hang_at_step(RECOVER_HANG_AT)
            plan.drop_heartbeats_after(RECOVER_HANG_AT)

        report, lines, mem, teardown, _, _, bundles = _supervised(
            torch, telemetry, root, "hang", lm_small, RECOVER_HANG_STEPS,
            RECOVER_INTERVAL, arm_hang, RECOVER_HANG_HB)
        incs = _incarnations(lines)
        times = _fault_times(incs, teardown)
        steps_b = [line for inc in incs for line in inc[1:]]
        # Steady steps: an incarnation's first pays its lazy CUDA set-up.
        step_s = max(line["step_ms"] for inc in incs
                     for line in inc[2:]) / 1e3
        commit_s = max(line["commit_s"] for line in steps_b
                       if line["saved"])
        checks = {
            "restarts 1": report["restarts"] == 1,
            "failure classified hung":
                report["failures"][0]["kind"] == "hung",
            "detected within 5 s": times["detect"] < 5.0,
            "resumed at step {} and finished".format(RECOVER_HANG_AT):
                [inc[0]["step"] for inc in incs] == [0, RECOVER_HANG_AT]
                and report["committed_step"] == RECOVER_HANG_STEPS,
            "card memory back before the relaunch": _mem_ok(mem),
        }
        # A hung node's beats stopped: it cannot answer SNAP (the request
        # rides the HB reply), so the manifest names it missing, unless a
        # snapshot it published earlier is in its manager KV.
        man = _read_bundle(bundles[0])[0] if bundles else {}
        named = man.get("nodes_captured", []) + man.get("nodes_missing", [])
        checks.update({
            "one node_hung bundle before the teardown":
                len(bundles) == 1 and man.get("reason") == "node_hung",
            "manifest names executor 0": "0" in named,
        })
        log("recover (b) incident bundle {} before the teardown: reason {}, "
            "captured {} missing {}; capture {} s; on {}".format(
                os.path.basename(bundles[0]) if bundles else None,
                man.get("reason"), man.get("nodes_captured"),
                man.get("nodes_missing"),
                _capture_seconds(telemetry, "node_hung"), card))
        launches_b = _launch_sum(fa, [inc[-1] for inc in incs])
        log("recover (b) hang at step {} of {}, {} layers, heartbeats every "
            "{} s, {} missed: failure {}, restarts {}; incarnations resumed "
            "at {}; B1-B3 launches {}; steady step {:.3f} s (CUDA events) "
            "and commit {:.3f} s (host clock) at most; restore {:.2f} s; "
            "card memory "
            "before each attempt: {}; seconds from the fault to detection "
            "{:.2f}, to the end of teardown {:.2f}, to the relaunch's first "
            "step {:.2f}".format(
                RECOVER_HANG_AT, RECOVER_HANG_STEPS, RECOVER_LAYERS,
                RECOVER_HANG_HB["heartbeat_interval"],
                RECOVER_HANG_HB["heartbeat_miss_budget"],
                report["failures"][0]["kind"], report["restarts"],
                [inc[0]["step"] for inc in incs], launches_b, step_s,
                commit_s, incs[1][0]["restore_s"], _mem_text(mem),
                times["detect"], times["teardown"], times["first_step"]))
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError("recover (b) failed: {}".format(failed))
        for k in total:
            total[k] += launches_b[k]

        # (c) elastic preemption at 2 layers.
        grace = RECOVER_GRACE_STEPS * (step_s + commit_s)
        out = os.path.join(root, "elastic")
        log_dir = os.path.join(out, "logs")
        os.makedirs(log_dir)
        plan = faults.FaultPlan(os.path.join(out, "faults"))
        plan.preempt_node(RECOVER_PREEMPT_AT, grace=grace)
        rows = _cluster_rows(lm_small, RECOVER_ELASTIC_PARTS * CLUSTER_BATCH,
                             seed=22)
        parts = [rows[i:i + CLUSTER_BATCH]
                 for i in range(0, len(rows), CLUSTER_BATCH)]
        args = {"lm": lm_small, "ckpt_dir": os.path.join(out, "ckpt"),
                "plan_dir": plan.plan_dir, "log_dir": log_dir}
        pool = backend.LocalBackend(2, base_dir=os.path.join(out, "exec"))
        try:
            sup = cluster.run(
                pool, recover_elastic_node, args, num_executors=2,
                input_mode=cluster.InputMode.FEED, reservation_timeout=300,
                restart_policy=RestartPolicy(max_restarts=1, backoff=0.5),
                checkpoint_dir=args["ckpt_dir"],
                elastic=dict(min_nodes=1, rejoin_delay=1.0))
            report = sup.train(backend.Partitioned(parts), timeout=600)
        finally:
            pool.stop()
        member = report.get("membership", {})
        logs = {name: _incarnations(_read_audit(os.path.join(log_dir, name)))
                for name in sorted(os.listdir(log_dir))}
        preempted = [incs for incs in logs.values() if len(incs) >= 2]
        launches_c = _launch_sum(fa, [
            [line for line in inc if line["kind"] == "step"][-1]
            for incs in logs.values() for inc in incs
            if any(line["kind"] == "step" for line in inc)])
        reshapes = sum(line["kind"] == "reshape" for incs in logs.values()
                       for inc in incs for line in inc)
        checks = {
            "preemption fired": plan.fired(faults.PREEMPT) == 1,
            "restarts 0": report["restarts"] == 0,
            "departures >= 1": member.get("departures", 0) >= 1,
            "rejoins >= 1": member.get("rejoins", 0) >= 1,
            "epoch >= 2": member.get("epoch", 0) >= 2,
            "world size 2 at shutdown": member.get("world_size") == 2,
            "the replacement resumed above step 0": bool(preempted) and
                preempted[0][1][0]["step"] > 0,
            "B1-B3 in both incarnations of the preempted node":
                bool(preempted) and all(
                    any(line["kind"] == "step" and
                        min(line["launches"].values()) > 0 for line in inc)
                    for inc in preempted[0][:2]),
        }
        log("recover (c) elastic, 2 executors, {} layers, min_nodes 1, "
            "rejoin delay 1 s; preemption after step {} with a grace of "
            "{:.2f} s ({:g} x (step + commit) of (b)): restarts {}, "
            "membership {}; node incarnations resumed at {}; reshape "
            "barriers {}; B1-B3 launches {}".format(
                RECOVER_LAYERS, RECOVER_PREEMPT_AT, grace,
                RECOVER_GRACE_STEPS, report["restarts"],
                {k: member.get(k) for k in ("epoch", "world_size",
                                            "departures", "rejoins",
                                            "replacements")},
                {name: [inc[0]["step"] for inc in incs]
                 for name, incs in logs.items()}, reshapes, launches_c))
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError("recover (c) failed: {}".format(failed))
        for k in total:
            total[k] += launches_c[k]

        # (d) the Quickstart over two remote agents.
        out = os.path.join(root, "agents")
        os.makedirs(out)
        pool = backend_remote.RemoteBackend(2, listen=("127.0.0.1", 0))
        env = dict(os.environ, TPU_FRAMEWORK_AGENT_KEY=pool.authkey.hex(),
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t0 = time.perf_counter()
        agents = [sp.Popen(
            [sys.executable, "-m", "tensorflowonspark_tpu_torch.tools.agent",
             "--driver", "127.0.0.1:{}".format(pool.address[1]),
             "--base_dir", os.path.join(out, "agents")], env=env)
            for _ in range(2)]
        try:
            pool.wait_for_agents(timeout=120)
            agents_s = time.perf_counter() - t0
            rows = _cluster_rows(lm_small,
                                 2 * RECOVER_AGENT_STEPS * CLUSTER_BATCH,
                                 seed=23)
            half = len(rows) // 2
            infer_rows = _cluster_rows(lm_small, 2 * CLUSTER_BATCH, seed=24)
            infer_parts = [infer_rows[:CLUSTER_BATCH],
                           infer_rows[CLUSTER_BATCH:]]
            args = {"outdir": out, "steps": RECOVER_AGENT_STEPS,
                    "lm": lm_small, "infer": True, "save_params": True}
            t_run = time.perf_counter()
            c = cluster.run(pool, cluster_node, args, num_executors=2,
                            input_mode=cluster.InputMode.FEED,
                            reservation_timeout=300)
            ready_s = time.perf_counter() - t_run
            try:
                c.train(backend.Partitioned([rows[:half], rows[half:]]),
                        timeout=600)
                results = c.inference(backend.Partitioned(infer_parts),
                                      timeout=600)
            finally:
                c.shutdown(timeout=600)
        finally:
            pool.stop()
            for a in agents:
                try:
                    a.wait(timeout=30)
                except sp.TimeoutExpired:
                    a.kill()
                    a.wait(timeout=30)
        docs = []
        for r in range(2):
            with open(os.path.join(out, "node{}.json".format(r))) as f:
                docs.append(json.load(f))
        tr = _recover_lm(torch, {"lm": lm_small}, "cuda")
        state = tr.init(params=torch.load(os.path.join(out, "params.pt"),
                                          weights_only=True))
        want_pred = []
        for part in infer_parts:
            logits = tr.predict(state, np.asarray(part)[:, :-1].astype(
                np.int64))
            want_pred.append([int(t) for t in logits[:, -1].argmax(-1).cpu()])
        del tr, state
        torch.cuda.empty_cache()
        launches_d = dict.fromkeys(fa.launches, 0)
        for d in docs:
            for k in launches_d:
                launches_d[k] += d["train_launches"][k] + \
                    d["infer_launches"][k]
        want_train = dict.fromkeys(fa.launches,
                                   RECOVER_AGENT_STEPS * RECOVER_LAYERS)
        checks = {
            "predictions those of in-process predict": results == want_pred,
            "replicas bitwise equal every step": all(
                d["equal"] == [True] * RECOVER_AGENT_STEPS for d in docs),
            "each agent's executor launched B1-B3": all(
                d["train_launches"] == want_train for d in docs),
            "each agent's executor launched B1 in inference": all(
                d["infer_launches"]["flash_fwd"] == RECOVER_LAYERS
                for d in docs),
        }
        log("recover (d) Quickstart over 2 tools/agent.py agents, {} layers, "
            "data=2 over {}: agents up in {:.2f} s, cluster.run {:.2f} s; "
            "{} steps, losses {}; c.inference {} equal to in-process "
            "predict {}; B1-B3 launches per agent {}".format(
                RECOVER_LAYERS, docs[0]["backend"], agents_s, ready_s,
                RECOVER_AGENT_STEPS,
                ["{:.4f}".format(x) for x in docs[0]["losses"]], results,
                want_pred, [{k: d["train_launches"][k] + d["infer_launches"]
                             [k] for k in launches_d} for d in docs]))
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError("recover (d) failed: {}".format(failed))
        for k in total:
            total[k] += launches_d[k]
    finally:
        telemetry.disable()
        shutil.rmtree(root, ignore_errors=True)
    return total


def toy_greedy_phase(torch):
    """Toy fp32 geometry on the card: engine streams (solo, joined
    mid-batch, max-length) equal solo ``generate`` bitwise."""
    from tensorflowonspark_tpu_torch.models import decoding, factory
    from tensorflowonspark_tpu_torch.serving import ServingEngine

    model = factory.get_model("transformer", dtype=torch.float32,
                              device="cuda", seed=0, **TOY)
    engine = ServingEngine(model, None, max_slots=4, page_size=16,
                           num_pages=32, decode_horizon=1,
                           prefix_share=False, preempt="off", device="cuda")

    def prompt(n, seed):
        return np.random.RandomState(seed).randint(
            1, TOY["vocab_size"], size=n).astype(np.int32)

    def solo(p, n):
        out = decoding.generate(model, None, p[None], n, auto_cache=True)
        return out[0, len(p):].tolist()

    p1, p2, p3, p4 = prompt(12, 1), prompt(20, 2), prompt(7, 5), prompt(
        120, 13)
    h1 = engine.submit(p1, 16)
    engine.step()
    engine.step()
    h2 = engine.submit(p2, 12)
    engine.step()
    h3 = engine.submit(p3, 4)
    engine.run_until_idle()
    h4 = engine.submit(p4, 8)
    engine.run_until_idle()
    for h, (p, n) in zip((h1, h2, h3, h4),
                         ((p1, 16), (p2, 12), (p3, 4), (p4, 8))):
        got, want = h.result(timeout=5), solo(p, n)
        if got != want:
            raise AssertionError("toy engine stream {} != solo {}".format(
                got, want))
    engine.close()
    log("greedy toy fp32: 4 engine streams equal solo generate bitwise")
    toy_default_cases(model, prompt, solo)
    return model


def toy_default_cases(model, prompt, solo):
    """The engine's new features at the toy fp32 geometry on the card
    (horizon 4, prefix sharing, swap): a request joining a decoding batch
    with a budget no multiple of the horizon, two prefix sharers and a
    whole-prompt duplicate (COW), and a swap and a recompute resume (three
    100-token residents hold 24 of 31 pages; a priority-1 arrival evicts
    the newest). Every stream equals solo ``generate`` token for token."""
    from tensorflowonspark_tpu_torch.serving import ServingEngine

    engine = ServingEngine(model, None, max_slots=4, page_size=16,
                           num_pages=32, decode_horizon=4, device="cuda")
    cases = []
    h = engine.submit(prompt(12, 1), 30)
    engine.step()
    cases.append((h, prompt(12, 1), 30))
    cases.append((engine.submit(prompt(20, 2), 13), prompt(20, 2), 13))
    engine.run_until_idle()
    rs = np.random.RandomState(31)
    pre = rs.randint(1, TOY["vocab_size"], size=32)
    for p in [np.concatenate([pre, rs.randint(1, TOY["vocab_size"], size=3)])
              .astype(np.int32) for _ in range(2)] + [pre.astype(np.int32)]:
        cases.append((engine.submit(p, 10), p, 10))
        engine.run_until_idle()
    hits = engine.prefix_hits
    for mode, seeds in (("swap", (80, 81, 82, 90)),
                        ("recompute", (83, 84, 85, 91))):
        engine.preempt = mode
        for i, s in enumerate(seeds):
            p = prompt(100, s)
            cases.append((engine.submit(p, 10, priority=int(i == 3)), p, 10))
            if i == 2:
                engine.step()
        engine.run_until_idle()
    for h, p, n in cases:
        got, want = h.result(timeout=5), solo(p, n)
        if got != want:
            raise AssertionError("toy default-engine stream {} != solo {}"
                                 .format(got, want))
    if hits < 2 or engine.pool.stats()["cow_copies_total"] < 1 \
            or engine.preempt_swaps < 1 or engine.preempt_recomputes < 1 \
            or engine.pool.pages_in_use:
        raise AssertionError("toy default engine: {}".format(engine.stats()))
    engine.close()
    log("greedy toy fp32 horizon 4: a joining request, 2 prefix sharers + "
        "a COW duplicate, a swap and a recompute resume: {} streams equal "
        "solo generate bitwise".format(len(cases)))


def full_width_teacher_forced(torch):
    """GPT-2-small width in fp32: each engine stream against solo decode
    teacher-forced on the engine's own tokens. A differing token passes
    only where solo's top-2 logit gap is below 1e-4 there, and that
    stream's comparison stops at it."""
    from tensorflowonspark_tpu_torch.models import decoding, factory
    from tensorflowonspark_tpu_torch.serving import ServingEngine

    model = factory.get_model("transformer", dtype=torch.float32,
                              device="cuda", seed=3, **GPT2_SMALL)
    engine = ServingEngine(model, None, max_slots=8, page_size=128,
                           decode_horizon=1, prefix_share=False,
                           preempt="off", device="cuda")
    rs = np.random.RandomState(7)
    reqs = [(rs.randint(1, GPT2_SMALL["vocab_size"],
                        size=int(rs.randint(32, 300))), 24)
            for _ in range(6)]
    handles = [engine.submit(p, n) for p, n in reqs]
    engine.run_until_idle()
    compared = near_ties = 0
    for (p, n), h in zip(reqs, handles):
        toks = h.result(timeout=5)
        cache = decoding.init_cache(
            model, 1, decoding._bucketed_cache_len(len(p) + n, 1024))
        logits = model(torch.as_tensor(p[None], device="cuda").long(),
                       decode=True, cache=cache)[0, -1]
        for j, tok in enumerate(toks):
            top2 = torch.topk(logits, 2).values
            solo_tok = int(torch.argmax(logits))
            compared += 1
            if solo_tok != tok:
                gap = float(top2[0] - top2[1])
                if gap >= 1e-4:
                    raise AssertionError(
                        "full-width fp32 stream differs at step {}: engine "
                        "{} solo {} (top-2 gap {})".format(j, tok, solo_tok,
                                                           gap))
                near_ties += 1
                break
            if j + 1 < len(toks):
                logits = model(torch.tensor([[tok]], device="cuda"),
                               decode=True, cache=cache)[0, -1]
    engine.close()
    log("greedy full-width fp32 teacher-forced: {} tokens compared, {} "
        "near-tie stops".format(compared, near_ties))


# -- shard ----------------------------------------------------------------------

# Two ranks share the card over gloo (NCCL refuses two ranks on one card):
# GPT-2-small width at 2 layers, bf16, AdamW 3e-4.
SHARD_LM = dict(GPT2_SMALL, num_layers=2)
SHARD_WORLD = 2
SHARD_STEPS = 3
SHARD_BATCH = 4
SHARD_LONG = 2048
SHARD_LR = 3e-4
# Tolerances, relative: bf16 losses ((a) over 3 steps against the one-rank
# trainer, (b) step 1 against the one-rank flash route, (c) fsdp against
# data); (b) in f32, step 1's loss, gradient norms and each compared
# gradient's largest difference over its largest value (summation order
# apart). In bf16 (b)'s gradients are read, not held: the head's backward
# GEMM reduces over the vocabulary, and cuBLAS's bf16 reductions round
# apart at a rank's and at one rank's token counts (ln_f.scale's norm read
# 1.15e-2 apart in the first run on the card). (d) ResNet in f32.
SHARD_LOSS_RTOL = 5e-3
SHARD_F32_LOSS_RTOL = 1e-5
SHARD_F32_GRAD_RTOL = 1e-3
SHARD_BN_RTOL = 1e-4
SHARD_NORM_PARAMS = ("embed.embedding", "pos_embed",
                     "block_0.attn.qkv.kernel", "block_1.mlp.down.kernel",
                     "ln_f.scale")
SHARD_GRAD_PARAMS = ("block_0.attn.qkv.kernel", "block_1.attn.out.kernel",
                     "block_0.ln1.scale")


def _shard_lm(torch, dtype=None, **kw):
    from tensorflowonspark_tpu_torch.models import factory

    return factory.get_model("transformer", dtype=dtype or torch.bfloat16,
                             device="cuda", seed=0, **dict(SHARD_LM, **kw))


def _shard_grads(state, names):
    return {n: state.params[n].grad.detach().float().cpu()
            for n in names}


def _full_grads(state, names):
    """Step 1's gradients of ``names``, whole: rebuilt from every rank's
    shard where the mesh shards the parameter (collective)."""
    if state.sharding is None:
        return _shard_grads(state, names)
    return {n: state.sharding.full(n, state.params[n].grad.detach())
            .float().cpu() for n in names}


def _norms(grads):
    return {n: float(g.norm()) for n, g in grads.items()}


def _resnet_batch(batch, seed=3):
    rs = np.random.RandomState(seed)
    return {"x": rs.rand(batch, 64, 64, 3).astype(np.float32),
            "y": (np.arange(batch) * 7 % 1000).astype(np.int32)}


def shard_rank(rank, world, port, outdir):
    """One rank of the shard phase (top level: the spawned process
    re-imports this file). Runs cases (a)-(d) and saves its results."""
    _gloo_rank(rank, world, port, outdir,
               lambda torch: _shard_cases(torch, rank))


def _shard_cases(torch, rank):
    import gc

    from tensorflowonspark_tpu_torch.ops import attention
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.parallel import collectives as coll
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    out = {"launches": dict.fromkeys(fa.launches, 0)}

    def counted(fn):
        before = dict(fa.launches)
        result = fn()
        return result, {n: fa.launches[n] - before[n] for n in fa.launches}

    def add(counts):
        for n, c in counts.items():
            out["launches"][n] += c

    fa.reset_launches()
    # (a) tensor=2 on the flash route.
    mesh = MeshConfig(data=1, tensor=2).build()
    tr = Trainer(_shard_lm(torch, attention_impl="pallas"),
                 optimizer=trainer.adamw(SHARD_LR), mesh=mesh,
                 device="cuda")
    state = tr.init()
    batch = lm_batch(SHARD_BATCH, 1024, SHARD_LM["vocab_size"])
    losses, per_step, ms = [], [], []
    for _ in range(SHARD_STEPS):
        stop = _timer(torch)
        (state, m), counts = counted(lambda: tr.train_step(state, batch))
        losses.append(float(m["loss"]))
        ms.append(stop())
        per_step.append(counts)
        add(counts)
    out["tensor"] = {"losses": losses, "per_step": per_step, "ms": ms}
    del tr, state
    torch.cuda.empty_cache()

    # (b) seq=2 ring_flash, contiguous and zigzag, at s 2048.
    for layout in ("contiguous", "zigzag"):
        mesh = MeshConfig(data=1, seq=2).build()
        tr = Trainer(_shard_lm(torch, attention_impl="ring_flash",
                               ring_layout=layout, max_seq_len=SHARD_LONG),
                     optimizer=trainer.adamw(SHARD_LR), mesh=mesh,
                     device="cuda")
        state = tr.init()
        batch = lm_batch(2, SHARD_LONG, SHARD_LM["vocab_size"])
        if layout == "zigzag":
            batch = {k: attention.zigzag_layout(v, 2)
                     for k, v in batch.items()}
        coll.reset_traffic()
        stop = _timer(torch)
        (state, m), counts = counted(lambda: tr.train_step(state, batch))
        step_ms = stop()
        add(counts)
        out["seq_" + layout] = {
            "loss": float(m["loss"]), "counts": counts, "ms": step_ms,
            "norms": _norms(_shard_grads(state, SHARD_NORM_PARAMS)),
            "traffic": dict(coll.traffic)}
        del tr, state
        torch.cuda.empty_cache()
        tr = Trainer(_shard_lm(torch, attention_impl="ring_flash",
                               ring_layout=layout, max_seq_len=SHARD_LONG,
                               dtype=torch.float32),
                     optimizer=trainer.adamw(SHARD_LR), mesh=mesh,
                     device="cuda")
        state = tr.init()
        (state, m), counts = counted(lambda: tr.train_step(state, batch))
        add(counts)
        out["seq_" + layout]["f32"] = {
            "loss": float(m["loss"]), "counts": counts,
            "norms": _norms(_shard_grads(state, SHARD_NORM_PARAMS)),
            "grads": _shard_grads(state, SHARD_GRAD_PARAMS)}
        del tr, state
        torch.cuda.empty_cache()

    # (c) fsdp=2 against data=2: bytes held and peak memory a rank.
    batch = lm_batch(SHARD_BATCH, 1024, SHARD_LM["vocab_size"])
    for name, kw in (("data", dict(data=2)), ("fsdp", dict(data=1, fsdp=2))):
        # Collect the earlier cases' trainers first: a peak read while one
        # still waits for the collector counts its tensors too.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = MeshConfig(**kw).build()
        tr = Trainer(_shard_lm(torch, attention_impl="pallas"),
                     optimizer=trainer.adamw(SHARD_LR), mesh=mesh,
                     device="cuda")
        state = tr.init()
        rows = tr.batch_placer.rows(SHARD_BATCH)
        losses, ms = [], []
        for _ in range(2):
            stop = _timer(torch)
            (state, m), counts = counted(lambda: tr.train_step(
                state, {k: v[rows] for k, v in batch.items()}))
            ms.append(stop())
            add(counts)
            losses.append(float(m["loss"]))
        opt_bytes = sum(t.numel() * t.element_size()
                        for per in state.optimizer.state.values()
                        for t in per.values()
                        if isinstance(t, torch.Tensor) and t.dim())
        out[name] = {
            "losses": losses, "ms": ms,
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in state.params.values()),
            "opt_bytes": opt_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated()}
        del tr, state
    torch.cuda.empty_cache()

    # (d) ResNet-50 with global-batch BatchNorm, data=2, f32.
    mesh = MeshConfig(data=2).build()
    model = factory.get_model("resnet50", dtype=torch.float32,
                              device="cuda", seed=0)
    tr = Trainer(model, optimizer=trainer.sgd(0.1, momentum=0.9),
                 mesh=mesh, device="cuda")
    state = tr.init()
    batch = _resnet_batch(8)
    rows = tr.batch_placer.rows(8)
    state, m = tr.train_step(state, {k: v[rows] for k, v in batch.items()})
    out["bn"] = {"loss": float(m["loss"]),
                 "stats": {k: v.detach().cpu()
                           for k, v in state.model_state.items()}}
    return out


def ring_block_checks(torch, fa):
    """B1-B3 at the ring's block shapes against their plain versions, as
    the flash phase holds them: a zigzag stripe pair at s 2048 over two
    ranks (512 x 512, non-causal, packed segments), and a held block whose
    every key lies in another document (fully masked: ``out`` 0, ``lse``
    about -1e30, no gradient). Returns each kernel's largest error."""
    errs = dict.fromkeys(fa.launches, 0.0)
    for i, name in enumerate(("stripe", "masked")):
        c = flash_case(torch, fa, 300 + i, 2, 512, 12, 12, torch.bfloat16,
                       "packed", causal=False)
        if name == "masked":
            c["k_seg"] = c["q_seg"] + 7
            c["lens"] = fa._lengths(c["q_seg"], c["k_seg"])
        parts = flash_compare(torch, fa, c, name, "bf16", errs)
        log("shard  ring block {}: {}".format(name, ", ".join(parts)))
        if name == "masked":
            out, lse = fa.flash_forward(c["q"], c["k"], c["v"], c["q_seg"],
                                        c["k_seg"], causal=False)
            dq = fa.flash_bwd_dq(c["q"], c["k"], c["v"], c["do"], lse,
                                 c["delta"], c["q_seg"], c["k_seg"],
                                 causal=False)
            if out.abs().max() or dq.abs().max() or float(lse.max()) > -1e29:
                raise AssertionError("fully masked block: out {} lse {} dq "
                                     "{}".format(float(out.abs().max()),
                                                 float(lse.max()),
                                                 float(dq.abs().max())))
    return errs


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def shard_phase(torch, fa, card):
    """Phase ``shard``: two ranks share the card over gloo. (a) tensor=2
    on the flash route, 3 steps against the one-rank trainer, B1-B3 two
    launches a step a rank; (b) seq=2 ring_flash contiguous and zigzag at
    s 2048, step 1's loss and gradients against the one-rank flash route,
    B1-B3 launches a rank equal to the ring schedule's; (c) fsdp=2 against
    data=2: parameter, optimizer and peak bytes a rank; (d) ResNet-50 f32
    with global-batch BatchNorm under data=2 against one process on the
    concatenated batch, running statistics equal on both ranks. Returns
    the B1-B3 launches of both ranks."""
    import tempfile

    from tensorflowonspark_tpu_torch.ops import attention
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _run_group(torch, shard_rank, tmp, SHARD_WORLD)
    group_s = time.perf_counter() - t0
    layers = SHARD_LM["num_layers"]

    # (a)
    tr = Trainer(_shard_lm(torch, attention_impl="pallas"),
                 optimizer=trainer.adamw(SHARD_LR), device="cuda")
    state = tr.init()
    batch = lm_batch(SHARD_BATCH, 1024, SHARD_LM["vocab_size"])
    want, ref_ms = [], []
    for _ in range(SHARD_STEPS):
        stop = _timer(torch)
        state, m = tr.train_step(state, batch)
        want.append(float(m["loss"]))
        ref_ms.append(stop())
    per_layer = dict.fromkeys(fa.launches, layers)
    for r in ranks:
        got = r["tensor"]
        if any(c != per_layer for c in got["per_step"]):
            raise AssertionError("tensor=2 launches {}; want {} a step".format(
                got["per_step"], per_layer))
        errs = [_rel(a, b) for a, b in zip(got["losses"], want)]
        if max(errs) > SHARD_LOSS_RTOL:
            raise AssertionError("tensor=2 losses {} against {}".format(
                got["losses"], want))
    log("shard  (a) tensor=2 pallas GPT-2-small width 2 layers b{} s1024 "
        "bf16: losses {} against one rank {} (rel err max {:.2e}); step ms "
        "a rank {} against one rank {}; B1-B3 {} a step a rank".format(
            SHARD_BATCH, ["{:.5f}".format(x) for x in ranks[0]["tensor"][
                "losses"]], ["{:.5f}".format(x) for x in want],
            max(_rel(a, b) for a, b in zip(ranks[0]["tensor"]["losses"],
                                           want)),
            [["{:.1f}".format(x) for x in r["tensor"]["ms"]] for r in ranks],
            ["{:.1f}".format(x) for x in ref_ms], layers))
    del tr, state
    torch.cuda.empty_cache()

    # (b)
    refs = {}
    for dtype in (torch.bfloat16, torch.float32):
        tr = Trainer(_shard_lm(torch, attention_impl="pallas",
                               max_seq_len=SHARD_LONG, dtype=dtype),
                     optimizer=trainer.adamw(SHARD_LR), device="cuda")
        state = tr.init()
        state, m = tr.train_step(state, lm_batch(2, SHARD_LONG,
                                                 SHARD_LM["vocab_size"]))
        refs[dtype] = (float(m["loss"]),
                       _norms(_shard_grads(state, SHARD_NORM_PARAMS)),
                       _shard_grads(state, SHARD_GRAD_PARAMS))
        del tr, state
        torch.cuda.empty_cache()
    ref_loss, ref_norms, _ = refs[torch.bfloat16]
    f32_loss, f32_norms, f32_grads = refs[torch.float32]
    for layout in ("contiguous", "zigzag"):
        sched = attention.ring_flash_launches(SHARD_WORLD, layout)
        for idx, r in enumerate(ranks):
            got = r["seq_" + layout]
            want_counts = dict.fromkeys(fa.launches, sched[idx] * layers)
            for counts in (got["counts"], got["f32"]["counts"]):
                if counts != want_counts:
                    raise AssertionError(
                        "ring_flash {} rank {} launched {}; the schedule "
                        "wants {}".format(layout, idx, counts, want_counts))
            if _rel(got["loss"], ref_loss) > SHARD_LOSS_RTOL:
                raise AssertionError("ring_flash {} loss {} against {}".format(
                    layout, got["loss"], ref_loss))
            f32 = got["f32"]
            if _rel(f32["loss"], f32_loss) > SHARD_F32_LOSS_RTOL:
                raise AssertionError("ring_flash {} f32 loss {} against "
                                     "{}".format(layout, f32["loss"],
                                                 f32_loss))
            bad = {n: (f32["norms"][n], v) for n, v in f32_norms.items()
                   if _rel(f32["norms"][n], v) > SHARD_F32_GRAD_RTOL}
            for n, ref in f32_grads.items():
                err = float((f32["grads"][n] - ref).abs().max()
                            / ref.abs().max())
                if err > SHARD_F32_GRAD_RTOL:
                    bad[n] = err
            if bad:
                raise AssertionError("ring_flash {} f32 gradients: "
                                     "{}".format(layout, bad))
        g = ranks[0]["seq_" + layout]
        worst = max(ref_norms, key=lambda n: _rel(g["norms"][n],
                                                  ref_norms[n]))
        f32_worst = max(
            [_rel(g["f32"]["norms"][n], v) for n, v in f32_norms.items()]
            + [float((g["f32"]["grads"][n] - ref).abs().max()
                     / ref.abs().max()) for n, ref in f32_grads.items()])
        log("shard  (b) seq=2 ring_flash {} b2 s{}: bf16 loss {:.5f} against "
            "one rank {:.5f} (gradient norms read up to {:.2e} apart, {}); "
            "f32 loss {:.6f} against {:.6f}, gradients and norms within "
            "{:.2e}; B1 launches a rank {} (schedule {} a layer); step ms "
            "{}; collective bytes sent a rank {}".format(
                layout, SHARD_LONG, g["loss"], ref_loss,
                _rel(g["norms"][worst], ref_norms[worst]), worst,
                g["f32"]["loss"], f32_loss, f32_worst,
                [r["seq_" + layout]["counts"]["flash_fwd"] for r in ranks],
                sched, ["{:.1f}".format(r["seq_" + layout]["ms"])
                        for r in ranks], g["traffic"]["bytes"]))

    # (c)
    for r in ranks:
        errs = [_rel(a, b) for a, b in zip(r["fsdp"]["losses"],
                                           r["data"]["losses"])]
        if max(errs) > SHARD_LOSS_RTOL:
            raise AssertionError("fsdp losses {} against data {}".format(
                r["fsdp"]["losses"], r["data"]["losses"]))
        if not (r["fsdp"]["param_bytes"] < 0.6 * r["data"]["param_bytes"]
                and r["fsdp"]["opt_bytes"] < 0.6 * r["data"]["opt_bytes"]):
            raise AssertionError("fsdp holds {} / {} bytes against data's "
                                 "{} / {}".format(
                                     r["fsdp"]["param_bytes"],
                                     r["fsdp"]["opt_bytes"],
                                     r["data"]["param_bytes"],
                                     r["data"]["opt_bytes"]))
    log("shard  (c) a rank, data=2 / fsdp=2: parameter bytes {} / {}, "
        "optimizer bytes {} / {}, peak bytes {} / {}; step ms {} / {}; "
        "losses {} / {}".format(
            ranks[0]["data"]["param_bytes"], ranks[0]["fsdp"]["param_bytes"],
            ranks[0]["data"]["opt_bytes"], ranks[0]["fsdp"]["opt_bytes"],
            [r["data"]["peak_bytes"] for r in ranks],
            [r["fsdp"]["peak_bytes"] for r in ranks],
            ["{:.1f}".format(x) for x in ranks[0]["data"]["ms"]],
            ["{:.1f}".format(x) for x in ranks[0]["fsdp"]["ms"]],
            ranks[0]["data"]["losses"], ranks[0]["fsdp"]["losses"]))

    # (d)
    model = factory.get_model("resnet50", dtype=torch.float32,
                              device="cuda", seed=0)
    tr = Trainer(model, optimizer=trainer.sgd(0.1, momentum=0.9),
                 device="cuda")
    state = tr.init()
    state, m = tr.train_step(state, _resnet_batch(8))
    ref_loss = float(m["loss"])
    worst = 0.0
    for name, ref in state.model_state.items():
        ref = ref.detach().cpu()
        for r in ranks:
            if not torch.equal(r["bn"]["stats"][name],
                               ranks[0]["bn"]["stats"][name]):
                raise AssertionError("running statistic {} differs between "
                                     "ranks".format(name))
        err = float((ranks[0]["bn"]["stats"][name] - ref).abs().max()
                    / max(float(ref.abs().max()), 1e-6))
        worst = max(worst, err)
    if worst > SHARD_BN_RTOL or _rel(ranks[0]["bn"]["loss"],
                                     ref_loss) > SHARD_BN_RTOL:
        raise AssertionError("global BatchNorm: loss {} against {}, running "
                             "statistics off by {:.2e}".format(
                                 ranks[0]["bn"]["loss"], ref_loss, worst))
    log("shard  (d) ResNet-50 f32 data=2 global BatchNorm b8 64px: loss "
        "{:.6f} against one process {:.6f}; running statistics equal on "
        "both ranks, {:.2e} of the largest from one process".format(
            ranks[0]["bn"]["loss"], ref_loss, worst))
    del tr, state, model
    torch.cuda.empty_cache()
    ring_block_checks(torch, fa)
    launches = dict.fromkeys(fa.launches, 0)
    for r in ranks:
        for n, c in r["launches"].items():
            launches[n] += c
    log("shard  phase {:.1f} s (ranks {:.1f} s) on {}; B1-B3 launches of "
        "both ranks {}".format(time.perf_counter() - t0, group_s, card,
                               launches))
    return launches


# -- every mesh axis: MoE and pipeline -----------------------------------------

# bench.py:481-526 ``bench_moe``: GPT-2-small widths, 8 experts, every other
# layer MoE (six of twelve), flash route, no remat, bf16 compute over f32
# weights, AdamW 3e-4, b8 x s1024 of RandomState(0) tokens with y = x.
MOE_LM = dict(GPT2_SMALL, num_experts=8, moe_every=2,
              attention_impl="pallas")
MOE_STEPS = 4
# (c): two gloo ranks on the card under expert=2, GPT-2-small width at 2
# layers (layer 1 MoE), b4 x s1024.
MOE_SHARD_LM = dict(MOE_LM, num_layers=2)
MOE_GRAD_PARAMS = ("embed.embedding", "block_1.moe.router.kernel",
                   "block_0.attn.qkv.kernel", "ln_f.scale")
# The pipe phase: four gloo ranks on the card, ``pipelined_transformer``
# at GPT-2-small width, 4 layers, b8 x s1024 global, flash route, no
# remat: GPipe (2 stages) and interleaved (4 stages, 2 rounds) under (data
# 2, pipe 2), and GPipe with the pipe axis beside tensor, fsdp and seq.
PIPE_LM = dict(GPT2_SMALL, num_layers=4, attention_impl="pallas")
_PIPE_GPIPE = dict(num_stages=2, num_microbatches=4)
PIPE_CASES = {
    "gpipe": (dict(data=2, pipe=2), _PIPE_GPIPE),
    "interleaved": (dict(data=2, pipe=2),
                    dict(num_stages=4, num_rounds=2, num_microbatches=4)),
    "pipe2_tensor2": (dict(data=1, pipe=2, tensor=2), _PIPE_GPIPE),
    "fsdp2_pipe2": (dict(data=1, fsdp=2, pipe=2), _PIPE_GPIPE),
    "pipe2_seq2": (dict(data=1, pipe=2, seq=2), _PIPE_GPIPE),
}
# Step 1's gradients held against one rank, rebuilt whole from the shards.
PIPE_GRAD_PARAMS = ("embed.embedding", "pos_embed", "ln_f.scale", "qkv",
                    "down")
PIPE_WORLD = 4
AXES_WORLD = 2


def _run_group(torch, target, outdir, world=AXES_WORLD, timeout=600):
    """Run ``target(rank, world, port, outdir)`` on ``world`` spawned
    ranks; returns each rank's saved results."""
    import multiprocessing as mp
    import socket

    ctx = mp.get_context("spawn")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [ctx.Process(target=target, args=(r, world, port, outdir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [open(os.path.join(outdir, "rank{}.err".format(r))).read()
              for r in range(world)
              if os.path.exists(os.path.join(outdir, "rank{}.err".format(r)))]
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError("ranks failed (exit codes {}):\n{}".format(
            [p.exitcode for p in procs], "\n".join(errors)))
    return [torch.load(os.path.join(outdir, "rank{}.pt".format(r)),
                       weights_only=False) for r in range(world)]


def _gloo_rank(rank, world, port, outdir, cases):
    import traceback

    import torch
    import torch.distributed as dist

    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method="tcp://127.0.0.1:{}".format(port),
            world_size=world, rank=rank)
        results = cases(torch)
        torch.save(results, os.path.join(outdir, "rank{}.pt".format(rank)))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, "rank{}.err".format(rank)), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def _mesh_steps(torch, name, kw, mesh_kw, dtype, batch, steps, grads=()):
    """``steps`` train steps of ``name`` built from seed 0 under
    ``mesh_kw`` (one rank when None): losses, aux losses, step ms by CUDA
    events, each step's B1-B3 launches and collective bytes, the bytes of
    each parameter held, and step 1's gradients of ``grads`` with their
    norms."""
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.parallel import MeshConfig
    from tensorflowonspark_tpu_torch.parallel import collectives as coll
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    model = factory.get_model(name, dtype=dtype, device="cuda", seed=0, **kw)
    mesh = None if mesh_kw is None else MeshConfig(**mesh_kw).build()
    tr = Trainer(model, optimizer=trainer.adamw(3e-4), mesh=mesh,
                 device="cuda")
    state = tr.init()
    out = {"losses": [], "aux": [], "ms": [], "launches": [], "bytes": [],
           "held": {k: p.numel() * p.element_size()
                    for k, p in state.params.items()}}
    rows = tr.batch_placer.rows(len(batch["x"]))
    batch = {k: v[rows] for k, v in batch.items()}
    for i in range(steps):
        before = dict(fa.launches)
        coll.reset_traffic()
        stop = _timer(torch)
        state, m = tr.train_step(state, batch)
        out["ms"].append(stop())
        out["losses"].append(float(m["loss"]))
        out["aux"].append(float(m["aux_loss"]))
        out["launches"].append({n: fa.launches[n] - before[n]
                                for n in fa.launches})
        out["bytes"].append(coll.traffic["bytes"])
        if i == 0:
            out["grads"] = _full_grads(state, grads)
            out["norms"] = _norms(out["grads"])
    del tr, state, model
    torch.cuda.empty_cache()
    return out


def _moe_rank_cases(torch):
    batch = lm_batch(SHARD_BATCH, 1024, MOE_SHARD_LM["vocab_size"])
    return {"f32": _mesh_steps(torch, "moe_transformer", MOE_SHARD_LM,
                               dict(data=1, expert=2), torch.float32, batch,
                               1, MOE_GRAD_PARAMS),
            "bf16": _mesh_steps(torch, "moe_transformer", MOE_SHARD_LM,
                                dict(data=1, expert=2), torch.bfloat16,
                                batch, SHARD_STEPS)}


def moe_rank(rank, world, port, outdir):
    """One rank of the moe phase's (c) (top level: spawned ranks re-import
    this file)."""
    _gloo_rank(rank, world, port, outdir, _moe_rank_cases)


def _pipe_rank_cases(torch):
    batch = lm_batch(8, 1024, PIPE_LM["vocab_size"])
    out = {}
    for case, (mesh_kw, kw) in PIPE_CASES.items():
        kw = dict(PIPE_LM, **kw)
        out[case] = {
            "f32": _mesh_steps(torch, "pipelined_transformer", kw, mesh_kw,
                               torch.float32, batch, 1, PIPE_GRAD_PARAMS),
            "bf16": _mesh_steps(torch, "pipelined_transformer", kw, mesh_kw,
                                torch.bfloat16, batch, SHARD_STEPS)}
    return out


def pipe_rank(rank, world, port, outdir):
    """One rank of the pipe phase (top level, as :func:`moe_rank`)."""
    _gloo_rank(rank, world, port, outdir, _pipe_rank_cases)


def _f32_against(label, got, ref):
    """Step 1 in f32 of a rank against one rank: the loss, the gradient
    norms and each gradient's largest difference over its largest value
    (the shard phase's tolerances). Returns the worst relative error."""
    if _rel(got["losses"][0], ref["losses"][0]) > SHARD_F32_LOSS_RTOL:
        raise AssertionError("{} f32 loss {} against one rank's {}".format(
            label, got["losses"][0], ref["losses"][0]))
    errs = {n: _rel(got["norms"][n], v) for n, v in ref["norms"].items()}
    for n, g in ref["grads"].items():
        errs[n + " (max)"] = float((got["grads"][n] - g).abs().max()
                                   / g.abs().max())
    bad = {n: e for n, e in errs.items() if e > SHARD_F32_GRAD_RTOL}
    if bad:
        raise AssertionError("{} f32 gradients against one rank: "
                             "{}".format(label, bad))
    return max(errs.values())


def _falling(label, losses):
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("{} losses not finite and falling: {}".format(
            label, losses))


def _shared(label, held, full, shares):
    """Raises unless a rank holds ``1 / shares[n]`` of each parameter
    ``n``'s bytes; returns the bytes held and whole of them all."""
    for n, k in shares.items():
        if k * held[n] != full[n]:
            raise AssertionError("{}: {} holds {} of {} bytes, not 1/{}"
                                 .format(label, n, held[n], full[n], k))
    return sum(held[n] for n in shares), sum(full[n] for n in shares)


def _stage_shares(mesh_kw):
    """How many ways each stage parameter of the pipelined LM splits under
    ``mesh_kw``: stages over pipe, heads and MLP columns over tensor,
    ``embed`` over fsdp (the layer norms included)."""
    from tensorflowonspark_tpu_torch.models import pipelined

    pipe, tensor, fsdp = (mesh_kw.get(a, 1) for a in ("pipe", "tensor",
                                                      "fsdp"))
    return {k: pipe * fsdp * (tensor if k in ("qkv", "attn_out", "up",
                                              "down") else 1)
            for k in pipelined.STAGE_PARAM_KEYS}


class _routing:
    """Teacher-forced routing of every MoE layer
    (``models.moe._top_k_routing(picks=...)``): with no ``picks``, records
    the top-k picks of each routing call, the argmax's own, so the step is
    unchanged; with ``picks``, replays them in call order."""

    def __init__(self, picks=None):
        self.replay, self.picks = picks, []

    def __enter__(self):
        from tensorflowonspark_tpu_torch.models import moe

        self.moe, self.orig = moe, moe._top_k_routing
        replay = None if self.replay is None else iter(self.replay)

        def route(probs, k, capacity):
            if replay is not None:
                picks = next(replay)
            else:
                remaining, picks = probs.detach(), []
                for _ in range(k):
                    idx = remaining.argmax(-1)
                    picks.append(idx)
                    remaining = remaining.scatter(-1, idx[..., None], 0.0)
                self.picks.append(picks)
            return self.orig(probs, k, capacity, picks=picks)

        moe._top_k_routing = route
        return self

    def __exit__(self, *exc):
        self.moe._top_k_routing = self.orig

    def differ(self, other):
        """Routing decisions (token x layer) whose picks differ."""
        n = 0
        for a, b in zip(self.picks, other.picks):
            diff = a[0] != b[0]
            for x, y in zip(a[1:], b[1:]):
                diff |= x != y
            n += int(diff.sum())
        return n


def _step_gate(label, loss, norms, dloss, dnorms, note=""):
    """Raises unless the flash step's loss and gradient norms are within
    ``TRAIN_LOSS_RTOL`` and ``TRAIN_GRAD_NORM_RTOL`` of the reference
    step's."""
    rel = _rel(loss, dloss)
    norm_rel = {n: _rel(norms[n], v) for n, v in dnorms.items()}
    log("moe    (a) step 1 {} flash: loss {:.6f} vs {:.6f} (rel "
        "{:.2e}, limit {:g}); gradient norms rel {} (limit {:g}){}".format(
            label, loss, dloss, rel, TRAIN_LOSS_RTOL,
            {n: "{:.2e}".format(v) for n, v in norm_rel.items()},
            TRAIN_GRAD_NORM_RTOL, note))
    if rel > TRAIN_LOSS_RTOL or max(norm_rel.values()) > \
            TRAIN_GRAD_NORM_RTOL:
        raise AssertionError("moe step 1: flash and dense disagree in "
                             "{}".format(label))


@contextlib.contextmanager
def _plain_flash(fa):
    """B1-B3's plain versions for CUDA tensors too (the wrappers take them
    only for CPU tensors): the kernels' own rounding points — f32 scores,
    P rounded to bf16 for the PV product — on the card, launching
    nothing."""
    saved = fa._forward, fa._bwd_dq, fa._bwd_dkv

    def fwd(q, k, v, q_seg, k_seg, lens, causal, block_q, block_k):
        return fa.flash_forward_reference(q, k, v, q_seg, k_seg,
                                          causal=causal,
                                          block_k=block_k or fa.BLOCK)

    def dq(q, k, v, do, lse, delta, q_seg, k_seg, lens, causal, block_q,
           block_k):
        return fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, q_seg,
                                         k_seg, causal=causal,
                                         block_k=block_k or fa.BLOCK)

    def dkv(q, k, v, do, lse, delta, q_seg, k_seg, lens, causal, block_q,
            block_k):
        return fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, q_seg,
                                          k_seg, causal=causal,
                                          block_q=block_q or fa.BLOCK)

    fa._forward, fa._bwd_dq, fa._bwd_dkv = fwd, dq, dkv
    try:
        yield
    finally:
        fa._forward, fa._bwd_dq, fa._bwd_dkv = saved


def moe_step1_routes(torch, fa, initial, batch, flash_loss, flash_norms,
                     flash_routing):
    """Step 1 of ``bench_moe`` held to the flash step's loss and gradient
    norms (``_step_gate``) from its initial weights: in bf16 through
    B1-B3's plain versions on the card, routed by the flash step's picks
    (teacher-forced: top-k, a discrete choice, would flip near-tie tokens
    where the two round apart); in f32 through the dense attention route,
    each step routing by its own argmax. The bf16 dense route, whose
    scores round to bf16 where B1 keeps them f32, is read beside them.
    Returns the f32 flash step's B1-B3 launches."""
    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    def step1(dtype, impl, picks=None, plain=False):
        model = factory.get_model("moe_transformer", dtype=dtype,
                                  device="cuda", seed=0,
                                  **dict(MOE_LM, attention_impl=impl))
        model.load_state_dict(initial)
        tr = Trainer(model, optimizer=trainer.adamw(3e-4), device="cuda")
        before = dict(fa.launches)
        with _routing(picks) as routing, \
                (_plain_flash(fa) if plain else contextlib.nullcontext()):
            state, m = tr.train_step(tr.init(), batch)
        counts = {n: fa.launches[n] - before[n] for n in fa.launches}
        out = (float(m["loss"]), grad_norms(state, MOE_GRAD_PARAMS),
               routing, counts)
        del model, tr, state
        torch.cuda.empty_cache()
        return out

    picks = flash_routing.picks
    ploss, pnorms, _, pcounts = step1(torch.bfloat16, "pallas", picks,
                                      plain=True)
    dloss, dnorms, _, dcounts = step1(torch.bfloat16, "dense", picks)
    if any(pcounts.values()) or any(dcounts.values()):
        raise AssertionError("the plain and dense steps launched {} and "
                             "{}".format(pcounts, dcounts))
    _step_gate("bf16", flash_loss, flash_norms, ploss, pnorms,
               "; against B1-B3's plain versions, routing teacher-forced "
               "to the flash step's picks; the dense route reads loss rel "
               "{:.2e}, gradient norms rel {}".format(
                   _rel(flash_loss, dloss),
                   {n: "{:.2e}".format(_rel(flash_norms[n], v))
                    for n, v in dnorms.items()}))
    floss, fnorms, frouting, fcounts = step1(torch.float32, "pallas")
    want = dict.fromkeys(fa.launches, MOE_LM["num_layers"])
    if fcounts != want:
        raise AssertionError("f32 flash step launched {}; want {}".format(
            fcounts, want))
    dloss, dnorms, drouting, _ = step1(torch.float32, "dense")
    _step_gate("f32", floss, fnorms, dloss, dnorms,
               "; against the dense route, each by its own routing, {} "
               "decisions differ".format(frouting.differ(drouting)))
    return dict(fcounts)


def moe_phase(torch, fa, pa, card):
    """Phase ``moe``: ``bench_moe``'s model (a) trained 4 steps on the
    flash route, 12 B1-B3 launches a step, step 1 against B1-B3's plain
    versions in bf16 (routing teacher-forced) and the dense route in f32
    (``moe_step1_routes``), the load-balance
    term above 0; (b) served by a bf16 engine at horizon
    1 and at the defaults (horizon 8) on ``serve_default``'s load, B4
    launches = decode calls x horizon x 12, horizon 8's streams equal
    horizon 1's bitwise and solo decode teacher-forced to near ties; (c)
    expert=2 over two gloo ranks on the card at 2 layers, f32 step 1
    against one rank, bf16 losses falling, expert bytes a rank half.
    Returns the B1-B3 launches of (a) and (c) and B4's of (b)."""
    import gc
    import tempfile

    from tensorflowonspark_tpu_torch.models import decoding, factory
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # (a)
    model = factory.get_model("moe_transformer", dtype=torch.bfloat16,
                              device="cuda", seed=0, **MOE_LM)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, optimizer=trainer.adamw(3e-4), device="cuda")
    state = tr.init()
    batch = lm_batch(8, 1024, MOE_LM["vocab_size"])
    per_layer = dict.fromkeys(fa.launches, MOE_LM["num_layers"])
    fa.reset_launches()
    losses, aux, ms = [], [], []
    for i in range(MOE_STEPS):
        before = dict(fa.launches)
        stop = _timer(torch)
        if i == 0:
            with _routing() as flash_routing:
                state, m = tr.train_step(state, batch)
        else:
            state, m = tr.train_step(state, batch)
        ms.append(stop())
        losses.append(float(m["loss"]))
        aux.append(float(m["aux_loss"]))
        counts = {n: fa.launches[n] - before[n] for n in fa.launches}
        if counts != per_layer:
            raise AssertionError("moe step {} launched {}; want {}".format(
                i, counts, per_layer))
        if i == 0:
            norms = grad_norms(state, MOE_GRAD_PARAMS)
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    _falling("moe", losses)
    if not all(np.isfinite(aux)) or min(aux) <= 0:
        raise AssertionError("moe aux losses {}".format(aux))
    moe_layers = MOE_LM["num_layers"] // MOE_LM["moe_every"]
    balance = [a / (0.01 * moe_layers) for a in aux]
    step_ms = float(np.median(ms[1:]))
    log("moe    (a) bench_moe: GPT-2-small width, 8 experts, {} MoE layers, "
        "b8 s1024 bf16 pallas adamw(3e-4): losses {} aux {} (balance "
        "aux/(0.01 x {}) {}); B1-B3 {} a step; step {:.2f} ms median of "
        "steps 2-{} ({} ms), {:.0f} tokens/s; peak {:.2f} GB; {}".format(
            moe_layers, ["{:.4f}".format(x) for x in losses],
            ["{:.5f}".format(x) for x in aux], moe_layers,
            ["{:.4f}".format(x) for x in balance], MOE_LM["num_layers"],
            step_ms, MOE_STEPS, ["{:.1f}".format(x) for x in ms],
            8 * 1024 / step_ms * 1e3, peak / 2 ** 30, card))
    profile_train_step(torch, tr, state, batch, label="moe b8 s1024 bf16",
                       top_ops=8)
    launches = {n: launches[n] + 2 * MOE_LM["num_layers"]
                for n in launches}
    if dict(fa.launches) != launches:
        raise AssertionError("moe profiled steps launched {}; want "
                             "{}".format(fa.launches, launches))
    del tr, state
    torch.cuda.empty_cache()
    f32 = moe_step1_routes(torch, fa, initial, batch, losses[0], norms,
                           flash_routing)
    launches = {n: launches[n] + f32[n] for n in launches}
    f32_launches = f32["flash_fwd"]
    del initial
    torch.cuda.empty_cache()

    # (b) the trained weights served.
    variables = decoding.serving_variables(model.state_dict(),
                                           torch.bfloat16)
    vocab = MOE_LM["vocab_size"]
    rs = np.random.RandomState(0)
    shapes = SERVE_DEFAULT_SHAPES
    reqs = [(rs.randint(1, vocab, size=shapes[i % 4][0]).astype(np.int32),
             shapes[i % 4][1]) for i in range(24)]
    streams, b4 = {}, 0
    for horizon in (8, 1):
        engine = default_engine(model, variables, decode_horizon=horizon)
        streams[horizon], _, d = serve_counted(torch, engine, pa,
                                               submit_all(reqs))
        st = engine.stats()
        engine.close()
        b4 += d["launches"]
        log("moe    (b) serve horizon {}: requests 24 tokens {} decode calls "
            "{} B4 launches {} (calls x {} x {}) decode tok/s {:.1f} "
            "ttft_p50 {:.2f} ms ({})".format(
                horizon, sum(n for _, n in reqs), d["decode_steps"],
                d["launches"], horizon, MOE_LM["num_layers"],
                d["decode_tokens"] / d["decode_seconds"], st["ttft_ms_p50"],
                card))
    if streams[8] != streams[1]:
        bad = sum(a != b for a, b in zip(streams[8], streams[1]))
        raise AssertionError("moe: {} of 24 horizon-8 streams differ from "
                             "horizon 1".format(bad))
    compared, stops, worst = _solo_teacher_forced(torch, model, reqs,
                                                  streams[1])
    log("moe    (b) 24 horizon-8 streams equal horizon 1 bitwise; against "
        "solo decode teacher-forced: {} tokens, {} near-tie stops (largest "
        "gap {:.1f} bf16 steps)".format(compared, stops, worst))
    del model, variables
    gc.collect()
    torch.cuda.empty_cache()

    # (c) expert=2 over two gloo ranks on the card.
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _run_group(torch, moe_rank, tmp)
    group_s = time.perf_counter() - t1
    sbatch = lm_batch(SHARD_BATCH, 1024, MOE_SHARD_LM["vocab_size"])
    ref = _mesh_steps(torch, "moe_transformer", MOE_SHARD_LM, None,
                      torch.float32, sbatch, 1, MOE_GRAD_PARAMS)
    experts = [n for n in ref["held"] if n.endswith(("w_up", "w_down"))]
    worst = 0.0
    for idx, r in enumerate(ranks):
        worst = max(worst, _f32_against("expert=2 rank {}".format(idx),
                                        r["f32"], ref))
        _falling("expert=2 rank {}".format(idx), r["bf16"]["losses"])
        held, full = _shared("expert=2 rank {}".format(idx),
                             r["bf16"]["held"], ref["held"],
                             dict.fromkeys(experts, 2))
        want = dict.fromkeys(fa.launches, MOE_SHARD_LM["num_layers"])
        for counts in r["f32"]["launches"] + r["bf16"]["launches"]:
            if counts != want:
                raise AssertionError("expert=2 launched {}; want {}".format(
                    counts, want))
        for n in launches:
            launches[n] += sum(c[n] for c in r["f32"]["launches"]
                               + r["bf16"]["launches"])
        f32_launches += sum(c["flash_fwd"] for c in r["f32"]["launches"])
    r0 = ranks[0]
    log("moe    (c) expert=2 over gloo, 2 ranks on the card, GPT-2-small "
        "width 2 layers b{} s1024: f32 step 1 loss {:.6f} against one rank "
        "{:.6f}, gradients and norms within {:.2e}; bf16 losses {}; expert "
        "bytes a rank {} of {}; step ms a rank {}; collective bytes a rank "
        "a step {}; ranks {:.1f} s".format(
            SHARD_BATCH, r0["f32"]["losses"][0], ref["losses"][0], worst,
            ["{:.5f}".format(x) for x in r0["bf16"]["losses"]], held, full,
            [["{:.1f}".format(x) for x in r["bf16"]["ms"]] for r in ranks],
            r0["bf16"]["bytes"], group_s))
    log("moe    phase {:.1f} s; B1-B3 launches {} (each: {} of the f32 "
        "kernels, in the f32 steps), B4 {}".format(
            time.perf_counter() - t0, launches, f32_launches, b4))
    return launches, b4


def pipe_phase(torch, fa, card):
    """Phase ``pipe``: four gloo ranks on the card, the pipelined LM at
    GPT-2-small width and 4 layers, b8 x s1024 global, 4 microbatches, the
    flash route: GPipe (2 stages) and interleaved (4 stages, 2 rounds)
    under (data 2, pipe 2), and GPipe under (pipe 2, tensor 2), (fsdp 2,
    pipe 2) and (pipe 2, seq 2), where B1-B3 run on a rank's heads, on a
    rank's rows, and over the whole row gathered from the seq pair. Each
    case: f32 step 1 against one rank on the same weights (the sequential
    path), gradients rebuilt whole from the shards; bf16 losses falling;
    B1-B3 launches a rank = microbatches x local layers a step; each stage
    parameter's bytes a rank its share. Returns the ranks' B1-B3
    launches."""
    import tempfile

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _run_group(torch, pipe_rank, tmp, world=PIPE_WORLD)
    group_s = time.perf_counter() - t0
    batch = lm_batch(8, 1024, PIPE_LM["vocab_size"])
    launches = dict.fromkeys(fa.launches, 0)
    f32_launches = 0
    refs = {}
    for case, (mesh_kw, kw) in PIPE_CASES.items():
        kw = dict(PIPE_LM, **kw)
        key = tuple(sorted(kw.items()))
        if key not in refs:
            refs[key] = _mesh_steps(torch, "pipelined_transformer", kw, None,
                                    torch.float32, batch, 1,
                                    PIPE_GRAD_PARAMS)
        ref = refs[key]
        local = PIPE_LM["num_layers"] // mesh_kw["pipe"]
        # Each layer runs once a microbatch (parallel/pipeline.py).
        want = dict.fromkeys(fa.launches, kw["num_microbatches"] * local)
        worst = 0.0
        for idx, r in enumerate(ranks):
            got = r[case]
            label = "pipe {} rank {}".format(case, idx)
            worst = max(worst, _f32_against(label, got["f32"], ref))
            _falling(label, got["bf16"]["losses"])
            held, full = _shared(label, got["bf16"]["held"], ref["held"],
                                 _stage_shares(mesh_kw))
            for counts in got["f32"]["launches"] + got["bf16"]["launches"]:
                if counts != want:
                    raise AssertionError("{} launched {}; the schedule "
                                         "wants {}".format(label, counts,
                                                           want))
                for n in launches:
                    launches[n] += counts[n]
            f32_launches += sum(c["flash_fwd"]
                                for c in got["f32"]["launches"])
        r0 = ranks[0][case]
        log("pipe   {} {} {}: GPT-2-small width {} layers b8 s1024, {} "
            "microbatches: f32 step 1 loss {:.6f} against one rank {:.6f}, "
            "gradients and norms within {:.2e}; bf16 losses {}; B1-B3 {} a "
            "step a rank; stage bytes a rank {} of {}; step ms a rank {}; "
            "collective bytes a rank a step {}; on {}".format(
                case, mesh_kw, {k: v for k, v in kw.items()
                                if k in ("num_stages", "num_rounds")},
                PIPE_LM["num_layers"], kw["num_microbatches"],
                r0["f32"]["losses"][0], ref["losses"][0], worst,
                ["{:.5f}".format(x) for x in r0["bf16"]["losses"]],
                want["flash_fwd"], held, full,
                [["{:.1f}".format(x) for x in r[case]["bf16"]["ms"]]
                 for r in ranks], r0["bf16"]["bytes"], card))
    log("pipe   phase {:.1f} s (ranks {:.1f} s) on {}; B1-B3 launches of "
        "the four ranks {} (each: {} of the f32 kernels, in the f32 steps)"
        .format(time.perf_counter() - t0, group_s, card, launches,
                f32_launches))
    return launches


# -- HTTP ----------------------------------------------------------------------

_CLIENT = r"""
import json, sys, urllib.request
port, prompt, n = int(sys.argv[1]), json.loads(sys.argv[2]), int(sys.argv[3])
req = urllib.request.Request(
    "http://127.0.0.1:{}/v1/generate".format(port),
    data=json.dumps({"prompt": prompt, "max_new_tokens": n}).encode(),
    headers={"Content-Type": "application/json"})
with urllib.request.urlopen(req, timeout=120) as resp:
    lines = [json.loads(l) for l in resp.read().decode().splitlines() if l]
with urllib.request.urlopen(
        "http://127.0.0.1:{}/v1/serving".format(port), timeout=30) as resp:
    stats = json.loads(resp.read().decode())
print(json.dumps({"lines": lines, "stats": stats}))
"""


def http_phase(torch, toy_model):
    from tensorflowonspark_tpu_torch.models import decoding
    from tensorflowonspark_tpu_torch.serving import ServingEngine
    from tensorflowonspark_tpu_torch.train.metrics import MetricsServer

    engine = ServingEngine(toy_model, None, max_slots=4, page_size=16,
                           num_pages=32, decode_horizon=1,
                           prefix_share=False, preempt="off",
                           device="cuda").start()
    server = MetricsServer(engine=engine)
    server.start()
    try:
        p = np.random.RandomState(21).randint(1, TOY["vocab_size"], size=15)
        out = subprocess.run(
            [sys.executable, "-c", _CLIENT, str(server.port),
             json.dumps(p.tolist()), "10"],
            capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError("HTTP client failed: " + out.stderr)
        doc = json.loads(out.stdout.strip().splitlines()[-1])
    finally:
        server.stop()
        engine.close()
    tail = doc["lines"][-1]
    tokens = [line["token"] for line in doc["lines"][:-1]]
    want = decoding.generate(toy_model, None, p[None], 10,
                             auto_cache=True)[0, len(p):].tolist()
    if not (tail.get("done") and tail.get("state") == "FINISHED"
            and tail.get("ttft_ms") is not None):
        raise AssertionError("bad terminal line: {}".format(tail))
    if tokens != want:
        raise AssertionError("HTTP stream {} != solo {}".format(tokens,
                                                                want))
    if doc["stats"].get("finished") != 1:
        raise AssertionError("/v1/serving stats: {}".format(doc["stats"]))
    log("http   POST /v1/generate from pid-separate client: {} tokens, "
        "ttft {} ms, equal to solo".format(len(tokens), tail["ttft_ms"]))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # One host: every cluster of the run advertises loopback.
    os.environ.setdefault("TPU_FRAMEWORK_HOST", "127.0.0.1")
    # The continuous sampler stays off in the processes whose steps the
    # script times; cluster (a) runs its executor with it, timed off and
    # on.
    os.environ["TFOS_PROFILING"] = "0"
    from tensorflowonspark_tpu_torch import device_info
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops import fused_resnet_block as frb
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi_line()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda)

    t0 = time.perf_counter()
    libs = _build.build_all()
    log("build: {} kernel librar{} in {:.1f} s".format(
        len(libs), "y" if len(libs) == 1 else "ies",
        time.perf_counter() - t0))
    phases = []

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases.append((name, time.perf_counter() - t0))
        log("phase {} {:.1f} s".format(name, phases[-1][1]))
        return out

    max_err, timings = timed("kernels", kernel_phase, torch, pa, device_info)
    flash_errs, flash_timed = timed("flash", flash_phase, torch, fa)
    flash_times = timed("flash timings", flash_timings, torch, fa,
                        device_info, flash_errs, flash_timed)
    del flash_timed
    fa.reset_launches()
    launches = timed("serve", main_phase, torch, pa)
    launches += timed("serve_default", serve_default_phase, torch, pa, card)
    launches += timed("spec", spec_phase, torch, pa, card)
    launches += timed("fleet", fleet_phase, torch, pa, card)
    if any(fa.launches.values()):
        raise AssertionError("serving launched flash kernels: {}".format(
            fa.launches))
    flash_launches, plain_step_ms = timed("train", training_phase, torch, fa,
                                          pa, card)
    timed("whole", whole_path_phase, torch, fa, pa, card, plain_step_ms)
    export_launches, export_b4 = timed("export", export_phase, torch, fa, pa,
                                       card)
    fa.reset_launches()
    frb.reset_launches()
    fused_errs, fused_timings, fused_launches = timed(
        "resnet", resnet_phase, torch, frb, device_info, card)
    if any(fa.launches.values()):
        raise AssertionError("the resnet phase launched flash kernels: "
                             "{}".format(fa.launches))
    cluster_launches = timed("cluster", cluster_phase, torch, fa, card)
    files_launches = timed("files", files_phase, torch, fa, card)
    recover_launches = timed("recover", recover_phase, torch, fa, card)
    shard_launches = timed("shard", shard_phase, torch, fa, card)
    fa.reset_launches()
    moe_launches, moe_b4 = timed("moe", moe_phase, torch, fa, pa, card)
    pipe_launches = timed("pipe", pipe_phase, torch, fa, card)
    toy_model = timed("greedy", toy_greedy_phase, torch)
    timed("teacher-forced", full_width_teacher_forced, torch)
    timed("http", http_phase, torch, toy_model)
    log("phases (s): " + ", ".join("{} {:.1f}".format(n, t)
                                   for n, t in phases))

    t = timings[("main", "bf16")]
    rows = [dict(name="paged_decode",
                 source="tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
                 replaces="tensorflowonspark_tpu/ops/paged_attention.py:65",
                 launches=launches + moe_b4 + export_b4, max_abs_err=max_err,
                 **t)]
    replaces = {"flash_fwd": 127, "flash_bwd_dq": 195, "flash_bwd_dkv": 256}
    for name, line in replaces.items():
        rows.append(dict(
            name=name,
            source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
            replaces="tensorflowonspark_tpu/ops/flash_attention.py:{}".format(
                line),
            launches=flash_launches[name] + export_launches[name]
            + cluster_launches[name]
            + files_launches[name] + recover_launches[name]
            + shard_launches[name]
            + moe_launches[name] + pipe_launches[name],
            **flash_times[name]))
    # B5's row: one launch of a stage-1 block, the mean of its two (K1
    # without, K3 with the prologue); B6's: the stage-1 block's K2.
    k1, k3 = fused_timings[("stage1", "K1")], fused_timings[("stage1", "K3")]
    b5 = {k: (k1[k] + k3[k]) / 2 for k in ("ms", "call_ms", "plain_ms",
                                           "library_ms", "bound_ms")}
    b5["bound_by"] = k1["bound_by"] if k1["bound_by"] == k3["bound_by"] \
        else "bytes, operations"
    for name, line, t in (("matmul_stats", 53, b5),
                          ("conv3x3_stats", 112,
                           fused_timings[("stage1", "K2")])):
        rows.append(dict(
            name=name,
            source="tensorflowonspark_tpu_torch/csrc/fused_resnet_block.cu",
            replaces="tensorflowonspark_tpu/ops/fused_resnet_block.py:"
                     "{}".format(line),
            launches=fused_launches[name], max_abs_err=fused_errs[name],
            **t))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = {"kernels": [{k: dict(row, route="cuda")[k] for k in keys}
                           for row in rows]}
    log("total {:.1f} s".format(time.perf_counter() - t_start))
    log("card:", card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
