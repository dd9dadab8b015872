"""A/B of two builds of the port's fused ResNet bottleneck kernels (B5
``matmul_stats``, B6 ``conv3x3_stats``), on one card, in one process.

Builds ``tensorflowonspark_tpu_torch/csrc/fused_resnet_block.cu`` and a
baseline source (an earlier commit's file, e.g. ``git show
<rev>:tensorflowonspark_tpu_torch/csrc/fused_resnet_block.cu >
build/block_ab/base.cu``) into two libraries with ``nvcc -Xptxas -v``,
printing ptxas's registers, spills and shared memory of every kernel
instance. Each library is called through its own source's ``extern "C"``
declarations, argument by name: a build whose entry points take a launch
plan (``block_n``, ``smem``, B6's strips) gets the wrapper's plan
(``matmul_plan``, ``conv3x3_plan``), one that takes only ``groups`` gets
the first design's (64 x 64 tiles, 8 blocks an SM).

At the six b256 slots of ``chip_smoke.py``'s two blocks (stage 1: 56x56,
256 -> 64; stage 3: 14x14, 1024 -> 256; K1 = B5 without, K2 = B6, K3 = B5
with the bn+relu prologue; operands from the plain chain) it holds each
build against the plain version (``chip_smoke.fused_compare``'s limits)
and against a second call of itself (y and both sums bitwise), then times
each in turns (baseline, current, current, baseline; variants after), L2
flushed before every call, two ways: the kernels' own durations in a
``torch.profiler`` window (:func:`kernel_ms`: the conv kernel's median
launch plus the statistics reduction's) and ``chip_smoke.device_ms`` (CUDA
events around the call, the card held busy until it is queued). The
library rendition (``torch.matmul``/``F.conv2d`` + sums, device ms) and the
bound are printed beside them.

Usage, from the root of the checkout on a machine with the card:
``python3 scripts/torch_block_ab.py --baseline build/block_ab/base.cu
[--variants build/block_ab/probe.cu ...] [--check-only]``; a variant (a
copy of the source changed for a probe) is built, checked and timed the
same way.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("matmul_stats", "conv3x3_stats")
_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float}
# The first design's grid: 64 x 64 tiles, 8 blocks an SM.
_FIRST_TILE = 64
_FIRST_BLOCKS_PER_SM = 8


def declarations(src):
    """``{name: [(ctype, parameter name)]}`` of the C entry points declared
    in ``src``."""
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
    """nvcc ``src`` into ``out_dir/libblock.so`` with the port's flags and
    ``-Xptxas -v``; returns (library path, ptxas's report lines)."""
    from tensorflowonspark_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libblock.so")
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
    """``{name: (function, declaration)}`` of the library at ``path``."""
    lib = ctypes.CDLL(path)
    fns = {}
    for name, decl in decls.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctype for ctype, _ in decl]
        fn.restype = ctypes.c_int
        fns[name] = (fn, decl)
    return fns


def caller(torch, frb, fn, decl, slot, args):
    """A call of one build's entry point on one slot's operands, as the
    wrapper makes it: outputs and scratch allocated per call, every
    argument passed by its name in ``decl``."""
    x, w, scale, shift = args
    dev = x.device
    sm = frb._sm_count(dev)
    names = {p for _, p in decl}
    f = w.shape[-1]
    if slot == "K2":
        b, h, w_sp, c = x.shape
        n = b * h * w_sp
        plan = frb.conv3x3_plan(b, h, w_sp, f, x.dtype, sm)
    else:
        n, c = x.shape
        plan = frb.matmul_plan(n, c, f, x.dtype, sm)
    if "block_n" in names:
        groups = plan.groups
    else:
        col_tiles = -(-f // _FIRST_TILE)
        groups = min(-(-n // _FIRST_TILE),
                     max(1, -(-_FIRST_BLOCKS_PER_SM * sm // col_tiles)))
    vals = dict(
        x=x.data_ptr(), w=w.data_ptr(),
        scale=None if scale is None else scale.reshape(-1).data_ptr(),
        shift=None if shift is None else shift.reshape(-1).data_ptr(),
        n=n, cin=c, fout=f, groups=groups, block_n=plan.block_n,
        smem=plan.smem, prologue=int(scale is not None),
        dtype=frb._DTYPE_CODES[x.dtype], strip_rows=plan.strip_rows,
        strips_per_block=plan.strips_per_block, f=f)
    if slot == "K2":
        vals.update(b=x.shape[0], height=x.shape[1], width=x.shape[2])

    def run():
        y = torch.empty(tuple(x.shape[:-1]) + (f,), dtype=x.dtype,
                        device=dev)
        parts = torch.empty((2, groups, f), dtype=torch.float32, device=dev)
        stats = torch.empty((2, f), dtype=torch.float32, device=dev)
        call = dict(vals, y=y.data_ptr(), part_s=parts[0].data_ptr(),
                    part_q=parts[1].data_ptr(), s=stats[0].data_ptr(),
                    q=stats[1].data_ptr(),
                    stream=torch.cuda.current_stream().cuda_stream)
        err = fn(*[call[p] for _, p in decl])
        if err:
            raise RuntimeError("launch failed: CUDA error {}".format(err))
        return y, stats[0], stats[1]
    return run


def kernel_ms(torch, cs, fn, reps):
    """(median conv kernel ms, median reduction ms, launches kept) of
    ``reps`` calls in one ``torch.profiler`` window, each after an L2 flush
    by a read. The profiler can drop device activities in a short window,
    so medians are over what it kept, and a window that kept no conv
    kernel is taken again, up to three times."""
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
        conv, red = [], []
        for ev in prof.events():
            if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
                continue
            ms = ev.self_device_time_total / 1e3
            if "conv_stats" in ev.name:
                conv.append(ms)
            elif "stats_reduce" in ev.name:
                red.append(ms)
        if conv:
            return (float(np.median(conv)),
                    float(np.median(red)) if red else 0.0, len(conv))
    raise RuntimeError("kernel_ms: no conv kernel recorded in three "
                       "windows")


def check(torch, cs, label, case, run, ref, diagnostic):
    """The build's call against the plain version and against a second
    call; a diagnostic build (a variant) that computes something else is
    reported, the baseline and current builds must hold the limits."""
    got, again = run(), run()
    torch.cuda.synchronize()
    try:
        y_err, past, differing, sum_err = cs.fused_compare(torch, got, ref)
    except AssertionError as err:
        if not diagnostic:
            raise
        print("check {:10s} {}: differs (diagnostic build): {}".format(
            label, case, err), flush=True)
        return
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print("check {:10s} {}: y max_abs_err {:.3e} ({:.5f} differ, near-zero "
          "{:.3e}), sums rel err {:.3e}, repeat {}".format(
              label, case, y_err, differing, past, sum_err,
              "equal" if same else "DIFFERS"), flush=True)
    if not same:
        raise AssertionError("{} {}: a second call differs".format(label,
                                                                   case))


def ab(torch, frb, cs, device_info, builds, reps, check_only):
    peak_bw = device_info.peak_bandwidth()
    order = list(builds)
    for i, (block, spatial, c, f) in enumerate(cs.BLOCKS):
        inputs = cs.block_inputs(torch, frb, spatial, c, f, cs.BLOCK_BATCH,
                                 300 + 1 + i)
        for slot, args in inputs["slots"].items():
            name = "conv3x3_stats" if slot == "K2" else "matmul_stats"
            case = "{} {}".format(block, slot)
            _, plain, lib = cs.fused_calls(frb, slot, args)
            ref = plain()
            runs = {label: caller(torch, frb, *fns[name], slot, args)
                    for label, fns in builds.items()}
            for label, run in runs.items():
                check(torch, cs, label, case, run, ref,
                      label not in ("baseline", "current"))
            del ref
            if check_only:
                continue
            times = {label: [] for label in order}
            events = {label: [] for label in order}
            kept = []
            for label in order[:2] + order[:2][::-1] + order[2:]:
                conv_ms, red_ms, n = kernel_ms(torch, cs, runs[label], reps)
                times[label].append((conv_ms, red_ms))
                kept.append(n)
                events[label].append(cs.device_ms(torch, runs[label],
                                                  reps=reps))
            bound, bound_by = cs.fused_bound_ms(torch, slot, args, peak_bw,
                                                device_info.peak_ops)
            lib_ms = cs.device_ms(torch, lib, reps=reps)
            print("device ms, {}, {} calls a reading, in the order {} and "
                  "back; kernel (profiler: conv + reduction, {}-{} launches "
                  "kept) | events; speedup over {}:".format(
                      case, reps, ", ".join(order[:2]), min(kept), max(kept),
                      order[0]), flush=True)
            base = sum(a + b for a, b in times[order[0]])
            base_ev = sum(events[order[0]]) / len(events[order[0]])
            for label in order:
                got, ev = times[label], events[label]
                tot = sum(a + b for a, b in got)
                print("  {:10s} {}  {:.2f}x | {}  {:.2f}x".format(
                    label, " ".join("{:.4f}+{:.4f}".format(a, b)
                                    for a, b in got),
                    base / len(times[order[0]]) / (tot / len(got)),
                    " ".join("{:.4f}".format(x) for x in ev),
                    base_ev / (sum(ev) / len(ev))), flush=True)
            print("  library (events) {:.4f}  bound {:.4f} ({})".format(
                lib_ms, bound, bound_by), flush=True)
        del inputs
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="fused_resnet_block.cu to compare against")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="more sources checked and timed beside the two "
                         "(diagnostic builds), each labelled by its file "
                         "name")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--check-only", action="store_true",
                    help="build, print ptxas's lines and check; no timing")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_block_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tensorflowonspark_tpu_torch import device_info
    from tensorflowonspark_tpu_torch.ops import fused_resnet_block as frb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("card:", cs.nvidia_smi_line(), flush=True)
    current = os.path.join(ROOT, "tensorflowonspark_tpu_torch", "csrc",
                           "fused_resnet_block.cu")
    out_root = os.path.join(ROOT, "build", "block_ab")
    sources = [("baseline", os.path.abspath(args.baseline)),
               ("current", current)]
    sources += [(os.path.splitext(os.path.basename(v))[0],
                 os.path.abspath(v)) for v in args.variants]
    builds = {}
    for label, src in sources:
        path, report = build(src, os.path.join(out_root, "lib_" + label))
        builds[label] = bind(path, declarations(src))
        print("ptxas {}:".format(label))
        for line in report:
            print("  " + line.split("ptxas info    : ")[-1])
    ab(torch, frb, cs, device_info, builds, args.reps, args.check_only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
