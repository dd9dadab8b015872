"""A/B of two builds of the port's flash-attention kernels, on one card, in
one process.

Builds ``tensorflowonspark_tpu_torch/csrc/flash_attention.cu`` and a
baseline source (an earlier commit's file, e.g. ``git show
<rev>:tensorflowonspark_tpu_torch/csrc/flash_attention.cu >
build/flash_ab/base.cu``) into two libraries with ``nvcc -Xptxas -v``,
printing ptxas's registers and spills of every kernel. Each library is
called through its own source's ``extern "C"`` declarations, argument by
name, so a baseline whose entry points take no head width ``d`` (built
for d = 64 alone) still runs against the current build at d = 64. At the
training shapes (b8 x s1024, h = 768 / d, bf16, causal; ``--d`` picks the
widths, 64 by default) it holds each build's B1, B2 and B3 against the
plain versions, then times each in turns (baseline, current, current,
baseline) two ways, L2 flushed before every call: the kernel's own
duration, the median launch in a ``torch.profiler`` window
(:func:`kernel_ms`), and ``chip_smoke.device_ms`` (CUDA events around the
launch, the card held busy until it is queued), which SDPA's forward and
backward get in the same process. A build that does not take a width is
skipped there.

Usage, from the root of the checkout on a machine with the card:
``python3 scripts/torch_flash_ab.py --baseline build/flash_ab/base.cu
[--d 32 64 128]``
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def declarations(src):
    """``{name: [(ctype, parameter name)]}`` of the ``flash_*`` C entry
    points declared in ``src``."""
    with open(src) as f:
        decls = dict(_DECL.findall(f.read()))
    out = {}
    for name in NAMES:
        params = []
        for p in decls[name].split(","):
            kind, pname = p.split()[0], p.split()[-1]
            params.append((ctypes.c_void_p if "*" in p else _CTYPES[kind],
                           pname.lstrip("*")))
        out[name] = params
    return out


def build(src, out_dir):
    """nvcc ``src`` into ``out_dir/libflash.so`` with the port's flags and
    ``-Xptxas -v``; returns (library path, ptxas's report lines)."""
    from tensorflowonspark_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libflash.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
         src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for {}:\n{}{}".format(
            src, proc.stdout, proc.stderr))
    report = [line.strip() for line in (proc.stdout + proc.stderr)
              .splitlines() if "Compiling entry" in line or "Used" in line
              or "spill" in line]
    return lib, report


def bind(path, decls):
    """The library at ``path`` with each entry point's argument types set
    from ``decls`` (:func:`declarations` of the source it was built
    from)."""
    lib = ctypes.CDLL(path)
    for name in NAMES:
        fn = getattr(lib, name)
        fn.argtypes = [ctype for ctype, _ in decls[name]]
        fn.restype = ctypes.c_int
    return lib


def takes(decls, d):
    """Whether a build with these declarations computes head width d: one
    without a ``d`` argument is built for 64 alone."""
    return d == 64 or all(any(p == "d" for _, p in params)
                          for params in decls.values())


def calls(torch, fa, lib, decls, c):
    """The three kernels of library ``lib`` on case ``c``, as ``{name:
    fn}``; each allocates its outputs as the wrappers do and passes every
    argument by its name in ``decls``."""
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    b, h, s_q, d = q.shape
    common = dict(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), dout=do.data_ptr(),
        q_seg=c["q_seg"].data_ptr(), k_seg=c["k_seg"].data_ptr(),
        q_len=c["lens"][0].data_ptr(), k_len=c["lens"][1].data_ptr(), b=b,
        h=h, h_kv=k.shape[1], s_q=s_q, s_k=k.shape[2], d=d,
        scale=fa._scale(d), causal=int(c["causal"]),
        dtype=fa._DTYPE_CODES[q.dtype],
        stream=torch.cuda.current_stream().cuda_stream)

    def run(name, **tensors):
        vals = dict(common, **{n: t.data_ptr() for n, t in tensors.items()})
        err = getattr(lib, name)(*[vals[p] for _, p in decls[name]])
        if err:
            raise RuntimeError("{} launch failed: CUDA error {}".format(
                name, err))

    def fwd():
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s_q), dtype=torch.float32, device="cuda")
        run("flash_fwd", out=out, lse=lse)
        return out, lse

    def dq():
        dq = torch.empty_like(q)
        run("flash_bwd_dq", lse=c["lse"], delta=c["delta"], dq=dq)
        return dq

    def dkv():
        dk = torch.empty(k.shape, dtype=torch.float32, device="cuda")
        dv = torch.empty_like(dk)
        run("flash_bwd_dkv", lse=c["lse"], delta=c["delta"], dk=dk, dv=dv)
        return dk, dv

    return {"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv}


def kernel_ms(torch, cs, fn, reps):
    """Median duration of the ``flash_*`` kernel that ``fn`` launches,
    over ``reps`` calls in one ``torch.profiler`` window, each after an L2
    flush by a read. The profiler can drop device activities in a short
    window, so the median is over the launches it kept, and a window that
    kept none is taken again, up to three times; (median, kept)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                       device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        times = [ev.self_device_time_total / 1e3 for ev in prof.events()
                 if str(getattr(ev, "device_type", "")).endswith("CUDA")
                 and "flash_" in ev.name]
        if times:
            return float(np.median(times)), len(times)
    raise RuntimeError("kernel_ms: no flash kernel recorded in three "
                       "windows")


def check(torch, label, fns, plain):
    """Holds one build's three kernels against the plain versions' results
    ``plain`` and prints the largest error and the share of values that
    differ, per output."""
    parts = []
    for name, fn in fns.items():
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        want = plain[name]
        want = want if isinstance(want, tuple) else (want,)
        for a, r in zip(got, want):
            parts.append("{} {:.3e} ({:.4f} differ)".format(
                name, float((a.float() - r.float()).abs().max()),
                float((a != r).float().mean())))
    torch.cuda.synchronize()
    print("check {:8s} {}".format(label, ", ".join(parts)), flush=True)


def ab(torch, fa, cs, libs, d, reps):
    """Checks and times every build that takes head width ``d`` at b8 x
    s1024 x h(768 / d), bf16, causal."""
    c = cs.flash_case(torch, fa, 100, b=8, s=1024, h=768 // d,
                      h_kv=768 // d, dtype=torch.bfloat16, segments="none",
                      d=d)
    ref_out, ref_lse = fa.flash_forward_reference(
        c["q"], c["k"], c["v"], c["q_seg"], c["k_seg"])
    c["lse"] = ref_lse
    c["delta"] = (ref_out.float() * c["do"].float()).sum(dim=-1)
    plain = {n: fn() for n, fn in cs.flash_calls(fa, c, "plain").items()}
    plain["flash_fwd"] = (ref_out, ref_lse)
    runs = {label: calls(torch, fa, lib, decls, c)
            for label, (lib, decls) in libs.items() if takes(decls, d)}
    for label in libs:
        if label not in runs:
            print("d{}: {} takes no head width, built for 64 alone: "
                  "skipped".format(d, label))
    for label, fns in runs.items():
        check(torch, "{} d{}".format(label, d), fns, plain)

    times = {(label, name): [] for label in runs for name in NAMES}
    events = {(label, name): [] for label in runs for name in NAMES}
    kept = []
    order = list(runs)
    for label in order + order[::-1]:
        for name in NAMES:
            ms, n = kernel_ms(torch, cs, runs[label][name], reps)
            times[(label, name)].append(ms)
            kept.append(n)
            events[(label, name)].append(
                cs.device_ms(torch, runs[label][name], reps=reps))
    sdpa_fwd, sdpa_bwd = cs.sdpa_yardsticks(torch, c)
    sdpa = (cs.device_ms(torch, sdpa_fwd, reps=reps),
            cs.device_ms(torch, sdpa_bwd, reps=reps))
    print("device ms, b8 s1024 h{} d{} bf16 causal, {} calls a reading, in "
          "the order {} and back; kernel (profiler, {}-{} launches kept of "
          "{}) | events; speedup over {}:".format(
              768 // d, d, reps, ", ".join(order), min(kept), max(kept),
              reps, order[0]))
    for name in NAMES:
        base = times[(order[0], name)]
        base_ev = events[(order[0], name)]
        for label in order:
            got, ev = times[(label, name)], events[(label, name)]
            print("  {:13s} {:10s} {}  {:.2f}x | {}  {:.2f}x".format(
                name, label, " ".join("{:.4f}".format(x) for x in got),
                sum(base) / sum(got),
                " ".join("{:.4f}".format(x) for x in ev),
                sum(base_ev) / sum(ev)))
    print("  sdpa (events) forward {:.4f}  backward (dq, dk, dv) "
          "{:.4f}".format(*sdpa), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="flash_attention.cu to compare against")
    ap.add_argument("--d", type=int, nargs="+", default=[64],
                    help="head widths to time (32, 64, 128)")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print("card:", cs.nvidia_smi_line(), flush=True)
    current = os.path.join(ROOT, "tensorflowonspark_tpu_torch", "csrc",
                           "flash_attention.cu")
    out_root = os.path.join(ROOT, "build", "flash_ab")
    libs = {}
    for label, src in (("baseline", os.path.abspath(args.baseline)),
                       ("current", current)):
        path, report = build(src, os.path.join(out_root, label))
        decls = declarations(src)
        libs[label] = (bind(path, decls), decls)
        print("ptxas {}:".format(label))
        for line in report:
            print("  " + line.split("ptxas info    : ")[-1])
    for d in args.d:
        ab(torch, fa, cs, libs, d, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
