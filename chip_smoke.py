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
               called twice and held bitwise equal to itself), and the
               flash-attention forward,
               dQ and dK/dV kernels (B1-B3) at the training shapes, packed,
               GQA, f32, ragged (s 1000) and non-causal rectangular, and at
               GPT-2-small's width split into head widths 32 and 128 (SDPA's
               forward, and its backward alone, timed at each width);
3. serve    — ``ServingEngine`` at GPT-2-small width (bf16, random seeded
               weights, page_size 128, decode_horizon 1) serves mixed
               requests, once with a bf16 pool and once with an int8 pool;
               every decode step of every layer must launch B4; then a
               profiler window over steady decode steps says where a step's
               time goes (device busy, kernels a step, B4's share);
4. train    — ``Trainer.train_step`` at GPT-2-small width (``bench.py``'s
               ``_lm_trainer``: b8 x s1024, bf16 compute, f32 weights,
               ``attention_impl="pallas"``, AdamW 3e-4) takes 4 steps with
               the loss falling and B1, B2 and B3 each launched 12 times a
               step; a remat step (24 B1 launches), a packed step, step 1
               against the dense attention route, and a profiled window;
               then step 1 at ``examples/transformer/train_lm.py``'s
               geometry (head width 32) against the dense route;
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
6. greedy   — engine streams equal solo ``generate`` bitwise at the toy
               fp32 geometry, and teacher-forced at full width in fp32;
7. http     — ``POST /v1/generate`` from a separate process over TCP.

The last two lines of standard output are the ``kernels`` JSON record and
``{"ok": true, "device": {...}}``. In the record, ``ms`` and ``library_ms``
are device times (:func:`device_ms`: the call's kernels alone, timed with
the card held busy until the host has queued the call); ``call_ms`` and
``plain_ms`` are CUDA events around the whole call (:func:`time_cold`), the
wrapper's host work included.
"""

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
# the last six split GPT-2-small's width 768 into heads of 32 and 128, the
# kernels' other instances ("main_d32" and "main_d128" are timed beside
# "main").
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
]
# The cases timed in flash_timings, by head width.
FLASH_TIMED = {64: "main", 32: "main_d32", 128: "main_d128"}


def flash_phase(torch, fa):
    """Every case of FLASH_CASES against the plain versions; returns the
    largest error of each kernel and the timed cases ({d: case})."""
    errs = {name: 0.0 for name in fa.launches}
    timed = {}
    for i, (case, kind, kw) in enumerate(FLASH_CASES):
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        c = flash_case(torch, fa, 100 + i, dtype=dtype, **kw)
        ref_out, ref_lse = fa.flash_forward_reference(
            c["q"], c["k"], c["v"], c["q_seg"], c["k_seg"],
            causal=c["causal"])
        c["lse"] = ref_lse
        c["delta"] = (ref_out.float() * c["do"].float()).sum(dim=-1)
        got = {n: fn() for n, fn in flash_calls(fa, c, "kernel").items()}
        torch.cuda.synchronize()
        ref = {n: fn() for n, fn in flash_calls(fa, c, "plain").items()}
        pairs = {
            "flash_fwd": (("out", got["flash_fwd"][0], ref_out),
                          ("lse", got["flash_fwd"][1], ref_lse)),
            "flash_bwd_dq": (("dq", got["flash_bwd_dq"],
                              ref["flash_bwd_dq"]),),
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
                            name, case, differing, label,
                            BF16_MAX_DIFFERING))
                errs[name] = max(errs[name], err)
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
                           decode_horizon=1, kv_cache_dtype=kv_cache_dtype,
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
                           device="cuda")
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
    return launches


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


def toy_greedy_phase(torch):
    """Toy fp32 geometry on the card: engine streams (solo, joined
    mid-batch, max-length) equal solo ``generate`` bitwise."""
    from tensorflowonspark_tpu_torch.models import decoding, factory
    from tensorflowonspark_tpu_torch.serving import ServingEngine

    model = factory.get_model("transformer", dtype=torch.float32,
                              device="cuda", seed=0, **TOY)
    engine = ServingEngine(model, None, max_slots=4, page_size=16,
                           num_pages=32, device="cuda")

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
    return model


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
                           device="cuda")
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
                           num_pages=32, device="cuda").start()
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
    max_err, timings = kernel_phase(torch, pa, device_info)
    flash_errs, flash_timed = flash_phase(torch, fa)
    flash_times = flash_timings(torch, fa, device_info, flash_errs,
                                flash_timed)
    del flash_timed
    fa.reset_launches()
    launches = main_phase(torch, pa)
    if any(fa.launches.values()):
        raise AssertionError("serving launched flash kernels: {}".format(
            fa.launches))
    flash_launches = training_phase(torch, fa, pa, card)
    fa.reset_launches()
    frb.reset_launches()
    fused_errs, fused_timings, fused_launches = resnet_phase(
        torch, frb, device_info, card)
    if any(fa.launches.values()):
        raise AssertionError("the resnet phase launched flash kernels: "
                             "{}".format(fa.launches))
    toy_model = toy_greedy_phase(torch)
    full_width_teacher_forced(torch)
    http_phase(torch, toy_model)

    t = timings[("main", "bf16")]
    rows = [dict(name="paged_decode",
                 source="tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
                 replaces="tensorflowonspark_tpu/ops/paged_attention.py:65",
                 launches=launches, max_abs_err=max_err, **t)]
    replaces = {"flash_fwd": 127, "flash_bwd_dq": 195, "flash_bwd_dkv": 256}
    for name, line in replaces.items():
        rows.append(dict(
            name=name,
            source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
            replaces="tensorflowonspark_tpu/ops/flash_attention.py:{}".format(
                line),
            launches=flash_launches[name], **flash_times[name]))
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
