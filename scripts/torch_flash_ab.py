"""A/B of two builds of the port's flash-attention kernels, on one card, in
one process.

Builds ``tensorflowonspark_tpu_torch/csrc/flash_attention.cu`` and a
baseline source with the same C interface (an earlier commit's file, e.g.
``git show <rev>:tensorflowonspark_tpu_torch/csrc/flash_attention.cu >
build/flash_ab/base.cu``) into two libraries with ``nvcc -Xptxas -v``,
printing ptxas's registers and spills of every kernel. At
the training shapes (b8 x s1024 x h12, d64, bf16, causal) it holds both
builds' B1, B2 and B3 against the plain versions, then times each in
turns (baseline, current, current, baseline) two ways, L2 flushed before
every call: the kernel's own duration, the median launch in a
``torch.profiler`` window (:func:`kernel_ms`), and ``chip_smoke.device_ms``
(CUDA events around the launch, the card held busy until it is queued),
which SDPA's forward and backward get in the same process.

Usage, from the root of the checkout on a machine with the card:
``python3 scripts/torch_flash_ab.py --baseline build/flash_ab/base.cu``
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


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


def bind(path):
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    lib = ctypes.CDLL(path)
    for name in NAMES:
        fn = getattr(lib, name)
        fn.argtypes = fa._argtypes(name)
        fn.restype = ctypes.c_int
    return lib


def calls(torch, fa, lib, c):
    """The three kernels of library ``lib`` on case ``c``, as ``{name:
    fn}``; each allocates its outputs as the wrappers do."""
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    segs = (c["q_seg"].data_ptr(), c["k_seg"].data_ptr(),
            c["lens"][0].data_ptr(), c["lens"][1].data_ptr())
    dims = fa._dims(q, k, c["causal"])
    b, h, s_q, _ = q.shape

    def check(name, err):
        if err:
            raise RuntimeError("{} launch failed: CUDA error {}".format(
                name, err))

    def fwd():
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s_q), dtype=torch.float32, device="cuda")
        check("flash_fwd", lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *segs, out.data_ptr(),
            lse.data_ptr(), *dims))
        return out, lse

    def dq():
        dq = torch.empty_like(q)
        check("flash_bwd_dq", lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            c["lse"].data_ptr(), c["delta"].data_ptr(), *segs, dq.data_ptr(),
            *dims))
        return dq

    def dkv():
        dk = torch.empty(k.shape, dtype=torch.float32, device="cuda")
        dv = torch.empty_like(dk)
        check("flash_bwd_dkv", lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            c["lse"].data_ptr(), c["delta"].data_ptr(), *segs, dk.data_ptr(),
            dv.data_ptr(), *dims))
        return dk, dv

    return {"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv}


def kernel_ms(torch, cs, fn, reps):
    """Median duration of the ``flash_*`` kernel that ``fn`` launches,
    over ``reps`` calls in one ``torch.profiler`` window, each after an L2
    flush by a read. The profiler can drop device activities in a short
    window, so the median is over the launches it kept; (median, kept)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                       device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    times = [ev.self_device_time_total / 1e3 for ev in prof.events()
             if str(getattr(ev, "device_type", "")).endswith("CUDA")
             and "flash_" in ev.name]
    if not times:
        raise RuntimeError("kernel_ms: no flash kernel recorded")
    return float(np.median(times)), len(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="flash_attention.cu to compare against")
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
        libs[label] = bind(path)
        print("ptxas {}:".format(label))
        for line in report:
            print("  " + line.split("ptxas info    : ")[-1])

    c = cs.flash_case(torch, fa, 100, b=8, s=1024, h=12, h_kv=12,
                      dtype=torch.bfloat16, segments="none")
    ref_out, ref_lse = fa.flash_forward_reference(
        c["q"], c["k"], c["v"], c["q_seg"], c["k_seg"])
    c["lse"] = ref_lse
    c["delta"] = (ref_out.float() * c["do"].float()).sum(dim=-1)
    plain = {n: fn() for n, fn in cs.flash_calls(fa, c, "plain").items()}
    plain["flash_fwd"] = (ref_out, ref_lse)
    runs = {label: calls(torch, fa, lib, c) for label, lib in libs.items()}
    for label, fns in runs.items():
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

    times = {(label, name): [] for label in runs for name in NAMES}
    events = {(label, name): [] for label in runs for name in NAMES}
    kept = []
    order = list(runs)
    for label in order + order[::-1]:
        for name in NAMES:
            ms, n = kernel_ms(torch, cs, runs[label][name], args.reps)
            times[(label, name)].append(ms)
            kept.append(n)
            events[(label, name)].append(
                cs.device_ms(torch, runs[label][name], reps=args.reps))
    sdpa_fwd, sdpa_bwd = cs.sdpa_yardsticks(torch, c)
    sdpa = (cs.device_ms(torch, sdpa_fwd, reps=args.reps),
            cs.device_ms(torch, sdpa_bwd, reps=args.reps))
    print("device ms, b8 s1024 h12 d64 bf16 causal, {} calls a reading, "
          "in the order {} and back; kernel (profiler, {}-{} launches kept "
          "of {}) | events; speedup over the baseline:".format(
              args.reps, ", ".join(order), min(kept), max(kept),
              args.reps))
    for name in NAMES:
        base, base_ev = times[("baseline", name)], events[("baseline", name)]
        for label in order:
            got, ev = times[(label, name)], events[(label, name)]
            print("  {:13s} {:10s} {}  {:.2f}x | {}  {:.2f}x".format(
                name, label, " ".join("{:.4f}".format(x) for x in got),
                sum(base) / sum(got),
                " ".join("{:.4f}".format(x) for x in ev),
                sum(base_ev) / sum(ev)))
    print("  sdpa (events) forward {:.4f}  backward (dq, dk, dv) "
          "{:.4f}".format(*sdpa))
    return 0


if __name__ == "__main__":
    sys.exit(main())
