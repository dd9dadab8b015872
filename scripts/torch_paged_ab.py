"""A/B of two builds of the port's paged decode kernel (B4), on one card, in
one process.

Builds ``tensorflowonspark_tpu_torch/csrc/paged_attention.cu`` and a
baseline source (an earlier commit's file, e.g. ``git show
<rev>:tensorflowonspark_tpu_torch/csrc/paged_attention.cu >
build/paged_ab/base.cu``) into two libraries with ``nvcc -Xptxas -v``,
printing ptxas's registers, spills and shared memory of every kernel. Each
library is called through its own source's ``extern "C"`` declaration,
argument by name, so a baseline that takes no scratch or state buffer runs
beside the current build. At ``chip_smoke.py``'s bench and main shapes
(8 rows, 12 heads of 64, pages of 64 and 128), bf16 and int8_bf16, it
holds each build against the plain version (largest difference, share of
outputs that differ), then times each in turns (baseline, current,
current, baseline) two ways, L2 flushed before every call: the kernels'
own durations in a ``torch.profiler`` window (:func:`kernel_ms`, the
median call) and ``chip_smoke.device_ms`` (CUDA events around the call,
the card held busy until it is queued); SDPA over the same K/V,
pre-gathered, and the bound are printed beside them.

Usage, from the root of the checkout on a machine with the card:
``python3 scripts/torch_paged_ab.py --baseline build/paged_ab/base.cu
[--variants build/paged_ab/probe.cu ...]``; a variant (a copy of the
source changed for a probe) is built, checked and timed the same way.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "paged_decode"
_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float}
KINDS = ("bf16", "int8_bf16")


def declaration(src):
    """``[(ctype, parameter name)]`` of the ``paged_decode`` C entry point
    declared in ``src``."""
    with open(src) as f:
        decls = dict(_DECL.findall(f.read()))
    params = []
    for p in decls[NAME].split(","):
        kind, pname = p.split()[0], p.split()[-1]
        params.append((ctypes.c_void_p if "*" in p else _CTYPES[kind],
                       pname.lstrip("*")))
    return params


def build(src, out_dir):
    """nvcc ``src`` into ``out_dir/libpaged.so`` with the port's flags and
    ``-Xptxas -v``; returns (library path, ptxas's report lines)."""
    from tensorflowonspark_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libpaged.so")
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


def bind(path, decl):
    """The entry point of the library at ``path``, its argument types set
    from ``decl`` (:func:`declaration` of the source it was built from)."""
    fn = getattr(ctypes.CDLL(path), NAME)
    fn.argtypes = [ctype for ctype, _ in decl]
    fn.restype = ctypes.c_int
    return fn


def caller(torch, pa, fn, decl, c):
    """A call of ``fn`` on case ``c`` as the wrapper makes it: output and
    scratch allocated per call, the state words kept (zeroed once) for the
    build, every argument passed by its name in ``decl``."""
    q = c["q"]
    b, _, h, d = q.shape
    n_pages, ps, h_kv, _ = c["k_pages"].shape
    tw = c["page_table"].shape[1]
    state = torch.zeros(2 * b * h_kv + b * h * tw, dtype=torch.int64,
                        device="cuda")
    quant = c["k_scales"] is not None
    common = dict(
        q=q.data_ptr(), k_pages=c["k_pages"].data_ptr(),
        v_pages=c["v_pages"].data_ptr(),
        k_scales=c["k_scales"].data_ptr() if quant else None,
        v_scales=c["v_scales"].data_ptr() if quant else None,
        page_table=c["page_table"].data_ptr(),
        seq_lens=c["seq_lens"].data_ptr(), state=state.data_ptr(), b=b, h=h,
        h_kv=h_kv, d=d, page_size=ps, table_width=tw, num_pages=n_pages,
        scale=pa._scale(d), dtype=pa._DTYPE_CODES[q.dtype], quant=int(quant),
        stream=torch.cuda.current_stream().cuda_stream)

    def run():
        run.state = state  # held as long as the caller is
        out = torch.empty_like(q)
        vals = dict(common, out=out.data_ptr())
        if any(p == "scratch" for _, p in decl):
            scratch = torch.empty(b * h * tw * (d + 2), dtype=torch.float32,
                                  device="cuda")
            vals["scratch"] = scratch.data_ptr()
        err = fn(*[vals[p] for _, p in decl])
        if err:
            raise RuntimeError("{} launch failed: CUDA error {}".format(
                NAME, err))
        return out
    return run


def kernel_ms(torch, cs, fn, reps):
    """Median duration of the ``paged_decode`` kernel (one a call in both
    designs) over ``reps`` calls in one ``torch.profiler`` window, each
    after an L2 flush by a read. The profiler can drop device
    activities in a short window, so the median is over the launches it
    kept, and a window that kept none is taken again, up to three times;
    (median, kept)."""
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
                 and NAME in ev.name]
        if times:
            return float(np.median(times)), len(times)
    raise RuntimeError("kernel_ms: no {} kernel recorded in three "
                       "windows".format(NAME))


def ab(torch, pa, cs, device_info, fns, reps):
    """Checks and times every build at the bench and main shapes."""
    peak_bw = device_info.peak_bandwidth()
    order = list(fns)
    for shape_name, shape in (("bench", cs.PAGED_BENCH),
                              ("main", cs.PAGED_MAIN)):
        for kind in KINDS:
            c = cs.paged_case(torch, 200, torch.bfloat16, kind == "int8_bf16",
                              shape["h"], shape["h_kv"], shape["d"],
                              shape["ps"], shape["tw"], shape["lens"])
            ref = cs.call(pa.paged_attention_reference, c)
            runs = {label: caller(torch, pa, fn, decl, c)
                    for label, (fn, decl) in fns.items()}
            for label, run in runs.items():
                got, again = run(), run()
                torch.cuda.synchronize()
                print("check {:8s} {:5s} {:9s} max_abs_err {:.3e} differing "
                      "{:.4f} repeat {}".format(
                          label, shape_name, kind,
                          float((got.float() - ref.float()).abs().max()),
                          float((got != ref).float().mean()),
                          "equal" if torch.equal(got, again) else "DIFFERS"),
                      flush=True)
            times = {label: [] for label in order}
            events = {label: [] for label in order}
            kept = []
            for label in order + order[::-1]:
                ms, n = kernel_ms(torch, cs, runs[label], reps)
                times[label].append(ms)
                kept.append(n)
                events[label].append(cs.device_ms(torch, runs[label],
                                                  reps=reps))
            bound, bound_by = cs.paged_bound_ms(torch, c, peak_bw,
                                                device_info.peak_ops)
            sdpa = (cs.device_ms(torch, cs.sdpa_yardstick(torch, c),
                                 reps=reps) if kind == "bf16" else None)
            print("device ms, {} {}, {} calls a reading, in the order {} and "
                  "back; kernel (profiler, {}-{} launches kept) | events; "
                  "speedup over {}:".format(
                      shape_name, kind, reps, ", ".join(order), min(kept),
                      max(kept), order[0]))
            base, base_ev = times[order[0]], events[order[0]]
            for label in order:
                got, ev = times[label], events[label]
                print("  {:10s} {}  {:.2f}x | {}  {:.2f}x".format(
                    label, " ".join("{:.4f}".format(x) for x in got),
                    sum(base) / sum(got),
                    " ".join("{:.4f}".format(x) for x in ev),
                    sum(base_ev) / sum(ev)))
            print("  bound {:.4f} ({}){}".format(
                bound, bound_by, "" if sdpa is None else
                "  sdpa (events) {:.4f}".format(sdpa)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="paged_attention.cu to compare against")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="more sources timed beside the two (diagnostic "
                         "builds), each labelled by its file name")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_paged_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tensorflowonspark_tpu_torch import device_info
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    print("card:", cs.nvidia_smi_line(), flush=True)
    current = os.path.join(ROOT, "tensorflowonspark_tpu_torch", "csrc",
                           "paged_attention.cu")
    out_root = os.path.join(ROOT, "build", "paged_ab")
    fns = {}
    builds = [("baseline", os.path.abspath(args.baseline)),
              ("current", current)]
    builds += [(os.path.splitext(os.path.basename(v))[0], os.path.abspath(v))
               for v in args.variants]
    for label, src in builds:
        path, report = build(src, os.path.join(out_root, label))
        decl = declaration(src)
        fns[label] = (bind(path, decl), decl)
        print("ptxas {}:".format(label))
        for line in report:
            print("  " + line.split("ptxas info    : ")[-1])
    ab(torch, pa, cs, device_info, fns, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
