"""Smoke run of the PyTorch/H100 port on one card: ``python3 chip_smoke.py``.

Drives ``tensorflowonspark_tpu_torch`` through the entry points a user
calls and fails (non-zero exit) if any phase fails:

1. device   — requires CUDA; prints the card's name and power limit;
2. kernels  — builds every CUDA kernel from ``tensorflowonspark_tpu_torch/
               csrc`` and holds each against its plain PyTorch version on
               the card, at the repo's bench shapes and the main path's
               shapes, timing kernel, plain version and a PyTorch yardstick;
3. main     — ``ServingEngine`` at GPT-2-small width (bf16, random seeded
               weights, page_size 128, decode_horizon 1) serves mixed
               requests, once with a bf16 pool and once with an int8 pool;
               every decode step of every layer must launch the kernel;
               then a profiler window over steady decode steps says where
               a step's time goes;
4. greedy   — engine streams equal solo ``generate`` bitwise at the toy
               fp32 geometry, and teacher-forced at full width in fp32;
5. http     — ``POST /v1/generate`` from a separate process over TCP.

The last two lines of standard output are the ``kernels`` JSON record and
``{"ok": true, "device": {...}}``.
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


def kernel_phase(torch, pa, device_info):
    bench = dict(h=12, h_kv=12, d=64, ps=64, tw=8,
                 lens=[5, 60, 64, 130, 200, 300, 450, 511])
    main = dict(h=12, h_kv=12, d=64, ps=128, tw=8,
                lens=[96, 200, 333, 512, 640, 777, 900, 1023])
    cases = []
    for shape_name, shape in (("bench", bench), ("main", main)):
        for kind, dtype, quant, h_kv in (
                ("f32", torch.float32, False, shape["h_kv"]),
                ("bf16", torch.bfloat16, False, shape["h_kv"]),
                ("int8", torch.float32, True, shape["h_kv"]),
                ("int8_bf16", torch.bfloat16, True, shape["h_kv"]),
                ("gqa_f32", torch.float32, False, 4)):
            kw = dict(shape, h_kv=h_kv)
            c = paged_case(torch, len(cases), dtype, quant, kw["h"], h_kv,
                           kw["d"], kw["ps"], kw["tw"], kw["lens"])
            got = call(pa.paged_attention, c)
            torch.cuda.synchronize()
            ref = call(pa.paged_attention_reference, c)
            err = float((got.float() - ref.float()).abs().max())
            differing = float((got != ref).float().mean())
            tol = TOL[kind.replace("gqa_", "")]
            log("kernel paged_decode {:5s} {:10s} max_abs_err {:.3e} "
                "(tol {:g}) differing {:.4f}".format(shape_name, kind, err,
                                                     tol, differing))
            if not err <= tol:
                raise AssertionError("paged_decode {} {} disagrees with its "
                                     "plain version: {} > {}".format(
                                         shape_name, kind, err, tol))
            if dtype == torch.bfloat16 and not (
                    differing <= BF16_MAX_DIFFERING):
                raise AssertionError(
                    "paged_decode {} {}: {:.4f} of the bf16 outputs differ "
                    "from the plain version (limit {})".format(
                        shape_name, kind, differing, BF16_MAX_DIFFERING))
            cases.append((shape_name, kind, c, err))
    peak_bw = device_info.peak_bandwidth()
    if peak_bw is None:
        raise RuntimeError("no bandwidth figure for this card: {}".format(
            torch.cuda.get_device_name(0)))
    timings = {}
    for shape_name, kind, c, _ in cases:
        if kind not in ("bf16", "int8_bf16"):
            continue
        ms = time_cold(torch, lambda: call(pa.paged_attention, c))
        plain_ms = time_cold(torch,
                             lambda: call(pa.paged_attention_reference, c))
        lib_ms = (time_cold(torch, sdpa_yardstick(torch, c))
                  if kind == "bf16" else None)
        bound_ms, bound_by = paged_bound_ms(torch, c, peak_bw,
                                            device_info.peak_ops)
        timings[(shape_name, kind)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by)
        log("time   paged_decode {:5s} {:10s} kernel {:.4f} ms  plain {:.4f} "
            "ms  sdpa {}  bound {:.4f} ms ({})".format(
                shape_name, kind, ms, plain_ms,
                "-" if lib_ms is None else "{:.4f} ms".format(lib_ms),
                bound_ms, bound_by))
    return max(err for *_, err in cases), timings


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
    by_name = {}
    count = 0
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (
                ev.self_device_time_total / 1e3)
            count += 1
    busy_ms = sum(by_name.values()) / steps
    log("profile decode step (8 rows, bf16 pool): host {:.3f} ms/step "
        "unprofiled; profiled window {:.3f} ms/step, device busy {:.3f} "
        "ms/step, idle share {:.3f}, {:.0f} device kernels/step".format(
            host_ms, window_ms, busy_ms, 1.0 - busy_ms / window_ms,
            count / steps))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log("profile   {:7.4f} ms/step {:5.1%}  {}".format(
            ms / steps, ms / steps / busy_ms, name[:90]))


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
    launches = main_phase(torch, pa)
    toy_model = toy_greedy_phase(torch)
    full_width_teacher_forced(torch)
    http_phase(torch, toy_model)

    t = timings[("main", "bf16")]
    kernels = {"kernels": [{
        "name": "paged_decode",
        "route": "cuda",
        "source": "tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        "replaces": "tensorflowonspark_tpu/ops/paged_attention.py:65",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]}
    log("total {:.1f} s".format(time.perf_counter() - t_start))
    log("card:", card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
