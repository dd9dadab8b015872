"""Fused ResNet bottleneck forward: CUDA kernel wrappers, their plain
versions and the block (port of ``ops/fused_resnet_block.py``).

The stride-1, no-projection bottleneck (12 of ResNet-50's 16 blocks) with
train-mode BatchNorm, as the JAX package chains it: three conv kernels and
one elementwise tail, each conv's batch statistics complete before its
normalised output feeds the next conv.

  K1  conv1 1x1 (C->F)              + sum/sumsq   B5 ``matmul_stats``
  K2  bn1+relu | conv2 3x3 (F->F)   + sum/sumsq   B6 ``conv3x3_stats``
  K3  bn2+relu | conv3 1x1 (F->C)   + sum/sumsq   B5 ``matmul_stats``
  T   bn3 + residual add + relu                   plain PyTorch

Two hand-written CUDA kernels in ``csrc/fused_resnet_block.cu`` replace the
two Pallas kernels of the JAX package:

* B5, ``_matmul_stats_kernel`` (``tensorflowonspark_tpu/ops/
  fused_resnet_block.py:53``): ``y = [relu(x*scale+shift)] . W`` with the
  prologue in f32, f32 accumulation, ``y`` rounded to the input dtype, and
  the f32 per-channel sums of ``y`` and ``y^2`` taken from the f32 product;
* B6, ``_conv3x3_stats_kernel`` (``:112``): the prologue in the input dtype
  (``scale``/``shift`` rounded to it first, each operation rounded), the
  SAME zero padding applied to the normalised activation, per image, then
  the 3x3 conv as nine shifted products with the same statistics.

Both write per-block partial sums to an f32 scratch that a second kernel
of the same launch sums in a fixed order: the statistics repeat to the
last bit from run to run.

Routes. The wrappers ``_conv1x1_stats`` and ``_conv3x3_stats`` run their
plain versions (``matmul_stats_reference``, ``conv3x3_stats_reference``:
the same rounding points in PyTorch; B6's nine shifted products over an
explicitly padded tile in the JAX tap order) only for tensors that lie on
the CPU; for CUDA tensors they launch the kernel or raise. The JAX
arguments ``interpret``, ``block_rows`` and ``images_per_step`` are gone:
they sized the TPU's VMEM tiles (``:157-165`` there) and chose its
interpreter, and here the tensors' device picks the route. The launch
plan (:func:`matmul_plan`, :func:`conv3x3_plan`: column tile, strips, grid
and shared memory, sized by the card's SM count) is made here and checked
by the kernels' C entry points, so the CPU tests hold the plan that runs.

``impls`` in :func:`bottleneck_forward` keeps the JAX values per conv slot:
``"pallas"`` is the hand-written kernel, ``"xla"`` the library rendition
(``_xla_conv1x1_stats``: ``torch.matmul``; ``_xla_conv3x3_stats``:
``F.conv2d``, i.e. cuDNN on the card; each followed by the sums). The
library renditions are the per-slot A/B route of ``scripts/block_bench.py
parts`` and the yardstick that ``chip_smoke.py`` times as each kernel's
``library_ms``; the default path never calls them. Neither library call
returns the f32 product of bf16 operands, so their statistics are taken
from the rounded ``y`` (JAX's take them from the f32 product): f32 sums of
the stored values in one reduction each, with no f32 copy of ``y``.

Parameters keep the JAX layout: ``w1`` (C, F), ``w2`` (3, 3, F, F) HWIO,
``w3`` (F, C) in the activation dtype; ``gamma*``/``beta*`` f32.
"""

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch.initializers import truncated_normal_

EPS = 1e-5

# Kernel launches since the last reset, per kernel: the counts a caller reads
# to show that a path really went through the kernels.
launches = {"matmul_stats": 0, "conv3x3_stats": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The C entry points' arguments in csrc/fused_resnet_block.cu: this many
# pointers, then this many ints, then the stream.
_SIGNATURES = {"matmul_stats": (9, 8), "conv3x3_stats": (9, 10)}

# The launch plan. The kernels' geometry (csrc/fused_resnet_block.cu): bf16
# blocks of 256 threads (8 warps, one block an SM), 64-channel chunks staged
# in rows of 72 elements, at most 227 KB of shared memory a block; the f32
# parity kernel's 64 x 64 tiles, 8 blocks an SM. A block walks a fixed
# share of the work items (row tiles, or groups of image strips) and writes
# one row of partial statistics, so the grid is one wave of the card.
_THREADS = 256
_KC = 64
_LDA = _KC + 8
_SMEM_LIMIT = 232448
_F32_TILE = 64
_F32_BLOCKS_PER_SM = 8

Plan = collections.namedtuple("Plan", [
    "groups",            # blocks along the rows: grid (groups, col_tiles)
    "block_n",           # output channels of a column tile
    "col_tiles",
    "items",             # row tiles (B5) or strip groups (B6)
    "rows",              # output rows of a block: B5 row tile, B6 layout
    "strip_rows",        # B6 (bf16): output rows of one image a strip
    "strips_per_block",  # B6 (bf16): strips of one item
    "smem",              # bf16: dynamic shared bytes (f32: 0)
])


def _cdiv(a, b):
    return -(-a // b)


def _tile(block_n):
    """(warp columns, warps along the rows, rows of a B5 item) of the bf16
    kernel at column tile ``block_n``: 8 warps of 64 rows each."""
    wn = 32 if block_n == 64 else 64
    warps_m = 8 // (block_n // wn)
    return wn, warps_m, 64 * warps_m


def _smem_bf16(taps, block_n, a_rows, cin):
    """Dynamic shared bytes of the bf16 kernel (``smem_bytes`` in the
    source): A stages of ``a_rows`` rows, weight stages (all ``taps`` tiles
    resident where one 64-channel chunk covers ``cin``), y staging, the
    cross-warp sums, the row table and the copy masks."""
    wn, warps_m, bm = _tile(block_n)
    sa, sw = (3, 3) if taps == 1 else (2, 4)
    if cin <= _KC:
        sw = taps
    return (sa * a_rows * _LDA * 2 + sw * _KC * (block_n + 8) * 2
            + 8 * 16 * (wn + 8) * 2 + 2 * warps_m * block_n * 4 + bm * 4
            + sa * _THREADS * 4)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _f32_plan(n, fout, sm_count):
    col_tiles = _cdiv(fout, _F32_TILE)
    items = _cdiv(n, _F32_TILE)
    groups = min(items, max(1, _cdiv(_F32_BLOCKS_PER_SM * sm_count,
                                     col_tiles)))
    return Plan(groups, _F32_TILE, col_tiles, items, _F32_TILE, 0, 0, 0)


@functools.lru_cache(maxsize=256)
def matmul_plan(n, cin, fout, dtype, sm_count):
    """B5's launch for ``(n, cin) . (cin, fout)`` on a card of ``sm_count``
    SMs. bf16 column tiles are as wide as ``fout`` up to 256, so x is read
    once per 256 output channels; row tiles of 256 (128 at 256 columns)."""
    if dtype == torch.float32:
        return _f32_plan(n, fout, sm_count)
    block_n = 64 if fout <= 64 else 128 if fout <= 128 else 256
    rows = _tile(block_n)[2]
    col_tiles = _cdiv(fout, block_n)
    items = _cdiv(n, rows)
    groups = min(items, max(1, sm_count // col_tiles))
    return Plan(groups, block_n, col_tiles, items, rows, 0, 0,
                _smem_bf16(1, block_n, rows, cin))


@functools.lru_cache(maxsize=256)
def conv3x3_plan(b, h, w, f, dtype, sm_count):
    """B6's launch for a (b, h, w, f) activation. bf16: a block's 256 rows
    hold strips of ``strip_rows`` output rows of one image (several whole
    images when one fits), as many as its halo tile — (rows + 2) x (w + 2)
    pixels a strip, two chunk stages — leaves room for in 227 KB."""
    if dtype == torch.float32:
        return _f32_plan(b * h * w, f, sm_count)
    block_n = 64 if f <= 64 else 128
    rows = _tile(block_n)[2]
    col_tiles = _cdiv(f, block_n)
    strip_rows = min(h, rows // w)
    while True:
        if strip_rows < 1:
            raise ValueError("conv3x3_stats kernel: images {} pixels wide "
                             "do not fit its tiles".format(w))
        spi = _cdiv(h, strip_rows)
        strip_rows = _cdiv(h, spi)
        per_block = min(rows // (strip_rows * w) if spi == 1 else 1, b * spi)
        smem = lambda k: _smem_bf16(  # noqa: E731
            9, block_n, k * (strip_rows + 2) * (w + 2), f)
        while per_block > 1 and smem(per_block) > _SMEM_LIMIT:
            per_block -= 1
        if smem(per_block) <= _SMEM_LIMIT:
            break
        strip_rows -= 1
    total = b * spi
    items = _cdiv(total, per_block)
    per_block = _cdiv(total, items)
    groups = min(items, max(1, sm_count // col_tiles))
    return Plan(groups, block_n, col_tiles, items,
                per_block * strip_rows * w, strip_rows, per_block,
                smem(per_block))


def reset_launches():
    for name in launches:
        launches[name] = 0


# -- plain versions ------------------------------------------------------------


def _row(v, width):
    """A per-channel vector given as (width,) or (1, width), as (width,)."""
    return v.reshape(width)


def matmul_stats_reference(x2d, w, scale=None, shift=None):
    """Plain version of B5. ``x2d`` (N, C), ``w`` (C, F) in one dtype; with
    ``scale``/``shift`` (C,) f32 the input is ``relu(x*scale + shift)`` in
    f32, rounded once. Returns ``(y (N, F) in x's dtype, sum (F,), sumsq
    (F,))``, the sums f32 from the f32 product."""
    c = x2d.shape[1]
    if scale is not None:
        x2d = torch.clamp_min(x2d.float() * _row(scale, c) + _row(shift, c),
                              0.0).to(x2d.dtype)
    y = x2d.float() @ w.float()
    return y.to(x2d.dtype), y.sum(dim=0), (y * y).sum(dim=0)


def conv3x3_stats_reference(x, w, scale, shift):
    """Plain version of B6. ``x`` (B, H, W, F), ``w`` (3, 3, F, F) HWIO;
    the prologue ``relu(x*scale + shift)`` runs in x's dtype with ``scale``
    and ``shift`` rounded to it and each operation rounded, as the JAX
    kernel does; the zero border goes in after it. Returns ``(y (B, H, W,
    F), sum (F,), sumsq (F,))``."""
    b, h, w_sp, f = x.shape
    dt = x.dtype
    xb = torch.clamp_min(x * _row(scale, f).to(dt) + _row(shift, f).to(dt),
                         0.0)
    xp = F.pad(xb, (0, 0, 1, 1, 1, 1))          # (B, H+2, W+2, F)
    acc = torch.zeros((b * h * w_sp, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            sl = xp[:, dy:dy + h, dx:dx + w_sp].reshape(b * h * w_sp, f)
            acc = acc + sl.float() @ w[dy, dx].float()
    y = acc.reshape(b, h, w_sp, -1).to(dt)
    return y, acc.sum(dim=0), (acc * acc).sum(dim=0)


# -- kernel wrappers -----------------------------------------------------------


def _argtypes(name):
    n_ptrs, n_ints = _SIGNATURES[name]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return [vp] * n_ptrs + [ci] * n_ints + [vp]


def _kernel_fn(name):
    from tensorflowonspark_tpu_torch.ops import _build

    fn = getattr(_build.load_library("fused_resnet_block"), name)
    if fn.argtypes is None:
        fn.argtypes = _argtypes(name)
        fn.restype = ctypes.c_int
    return fn


def _check_kernel(name, x, w, vectors):
    if x.device.type != "cuda":
        raise ValueError("{} runs on CPU tensors (plain version) or CUDA "
                         "tensors (the kernel); got {}".format(name, x.device))
    if x.dtype not in _DTYPE_CODES:
        raise ValueError("{} kernel takes f32 or bf16; got {}".format(
            name, x.dtype))
    if w.dtype != x.dtype:
        raise ValueError("{}: weights must share the input dtype {}; got "
                         "{}".format(name, x.dtype, w.dtype))
    vec = 16 // x.element_size()
    if x.shape[-1] % vec or w.shape[-1] % vec:
        raise ValueError("{} kernel needs channel counts divisible by {} "
                         "(16-byte loads); got {} -> {}".format(
                             name, vec, x.shape[-1], w.shape[-1]))
    for t in (x, w):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("{} takes contiguous, 16-byte aligned operands "
                             "on one device".format(name))
    for t in vectors:
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("{}: scale and shift must be contiguous f32 on "
                             "the input's device".format(name))


def _outputs(x, plan, f_out, shape):
    dev = x.device
    y = torch.empty(shape, dtype=x.dtype, device=dev)
    parts = torch.empty((2, plan.groups, f_out), dtype=torch.float32,
                        device=dev)
    stats = torch.empty((2, f_out), dtype=torch.float32, device=dev)
    return y, parts, stats


def _raise_on(name, err):
    if err:
        raise RuntimeError("{} launch failed: CUDA error {}".format(name, err))


def _conv1x1_stats(x2d, w, scale=None, shift=None):
    """B5. ``x2d`` (N, C), ``w`` (C, F) -> ``(y (N, F), sum (F,), sumsq
    (F,))``; with ``scale``/``shift`` ((C,) or (1, C) f32) the input is
    ``relu(x*scale + shift)`` first (the previous norm's affine form)."""
    n, c = x2d.shape
    if w.shape[0] != c:
        raise ValueError("x2d {} and w {} disagree on C".format(
            tuple(x2d.shape), tuple(w.shape)))
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if x2d.device.type == "cpu":
        return matmul_stats_reference(x2d, w, scale, shift)
    vectors = [] if scale is None else [_row(scale, c), _row(shift, c)]
    _check_kernel("matmul_stats", x2d, w, vectors)
    f = w.shape[1]
    plan = matmul_plan(n, c, f, x2d.dtype, _sm_count(x2d.device))
    y, parts, stats = _outputs(x2d, plan, f, (n, f))
    ptr = lambda i: vectors[i].data_ptr() if vectors else None  # noqa: E731
    err = _kernel_fn("matmul_stats")(
        x2d.data_ptr(), w.data_ptr(), ptr(0), ptr(1), y.data_ptr(),
        parts[0].data_ptr(), parts[1].data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), n, c, f, plan.groups, plan.block_n, plan.smem,
        int(bool(vectors)), _DTYPE_CODES[x2d.dtype],
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _raise_on("matmul_stats", err)
    launches["matmul_stats"] += 1
    return y, stats[0], stats[1]


def _conv3x3_stats(x, w, scale, shift):
    """B6. ``x`` (B, H, W, F) raw previous conv output, ``w`` (3, 3, F, F)
    HWIO -> ``(y (B, H, W, F), sum (F,), sumsq (F,))``; applies
    ``relu(x*scale + shift)`` first."""
    b, h, w_sp, f = x.shape
    if tuple(w.shape) != (3, 3, f, f):
        raise ValueError("w must be (3, 3, {0}, {0}); got {1}".format(
            f, tuple(w.shape)))
    if x.device.type == "cpu":
        return conv3x3_stats_reference(x, w, scale, shift)
    vectors = [_row(scale, f), _row(shift, f)]
    _check_kernel("conv3x3_stats", x, w, vectors)
    plan = conv3x3_plan(b, h, w_sp, f, x.dtype, _sm_count(x.device))
    y, parts, stats = _outputs(x, plan, f, x.shape)
    err = _kernel_fn("conv3x3_stats")(
        x.data_ptr(), w.data_ptr(), vectors[0].data_ptr(),
        vectors[1].data_ptr(), y.data_ptr(), parts[0].data_ptr(),
        parts[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), b, h,
        w_sp, f, plan.groups, plan.strip_rows, plan.strips_per_block,
        plan.block_n, plan.smem, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on("conv3x3_stats", err)
    launches["conv3x3_stats"] += 1
    return y, stats[0], stats[1]


# -- library renditions --------------------------------------------------------


def _stats_of(y, dims):
    """f32 sum and sum of squares of ``y`` over ``dims``, one reduction
    each, accumulated in f32 without an f32 copy of ``y``."""
    s = torch.sum(y, dim=dims, dtype=torch.float32)
    q = torch.linalg.vector_norm(y, 2, dim=dims, dtype=torch.float32)
    return s, q.square()


def _xla_conv1x1_stats(x2d, w, scale=None, shift=None):
    """Library rendition of the K1/K3 slot: the f32 prologue, then
    ``torch.matmul`` in the input dtype; the statistics come from the
    rounded y."""
    c = x2d.shape[1]
    if scale is not None:
        x2d = torch.clamp_min(x2d.float() * _row(scale, c) + _row(shift, c),
                              0.0).to(x2d.dtype)
    y = torch.matmul(x2d, w)
    return (y, *_stats_of(y, 0))


def _xla_conv3x3_stats(x, w, scale, shift):
    """Library rendition of the K2 slot, as the JAX one: the prologue in
    f32, then ``F.conv2d`` with SAME padding on the NHWC activation (a
    channels-last view) in the input dtype; the statistics come from the
    rounded y."""
    f = x.shape[-1]
    xf = torch.clamp_min(x.float() * _row(scale, f) + _row(shift, f),
                         0.0).to(x.dtype)
    y = F.conv2d(xf.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1).contiguous()
    return (y, *_stats_of(y, (0, 1, 2)))


# -- statistics and the block --------------------------------------------------


def _affine(s, q, count, gamma, beta):
    """Raw sum/sumsq -> the bn-apply affine ``(scale, shift)`` (each (1, F)
    f32) and the batch ``(mean, var)``: the normalised output is
    ``x*scale + shift`` (biased variance, like flax)."""
    mean = s / count
    var = torch.clamp_min(q / count - mean * mean, 0.0)
    scale = gamma / torch.sqrt(var + EPS)
    shift = beta - mean * scale
    return scale[None], shift[None], mean, var


def init_params(c_in, f, dtype=torch.bfloat16, device="cuda", generator=None):
    """He-normal conv weights (truncated, variance 2 / fan_in: C for
    ``w1``, 9F for ``w2``, F for ``w3``) and identity norms, the final
    norm's scale zero as in ``models/resnet.py``. ``generator`` is a CPU
    ``torch.Generator``; the draws cannot match ``jax.random``'s, so tests
    carry the JAX weights across (``convert.fused_block_params_from_jax``).
    """
    dev = device_info.resolve_device(device)
    gen = generator if generator is not None else torch.Generator()
    params = {}
    for name, shape, fan_in in (("w1", (c_in, f), c_in),
                                ("w2", (3, 3, f, f), 9 * f),
                                ("w3", (f, c_in), f)):
        params[name] = truncated_normal_(torch.empty(shape), 2.0 / fan_in,
                                         gen).to(dtype)
    for i, width, g0 in (("1", f, 1.0), ("2", f, 1.0), ("3", c_in, 0.0)):
        params["gamma" + i] = torch.full((width,), g0)
        params["beta" + i] = torch.zeros(width)
    return {k: v.to(dev) for k, v in params.items()}


_SLOTS = {
    "pallas": (_conv1x1_stats, _conv3x3_stats),
    "xla": (_xla_conv1x1_stats, _xla_conv3x3_stats),
}


def bottleneck_forward(params, x, impls=("pallas", "pallas", "pallas")):
    """Stride-1 bottleneck forward, train-mode BN. ``x`` (B, H, W, C).

    ``impls`` picks ``"pallas"`` (the hand-written kernel) or ``"xla"``
    (the library rendition) per conv slot. Returns ``(out, stats)`` with
    ``out`` (B, H, W, C) and ``stats`` the three ``(mean, var)`` pairs (what
    a training step folds into running stats)."""
    bad = [i for i in impls if i not in _SLOTS]
    if len(impls) != 3 or bad:
        raise ValueError("impls must name 'pallas' or 'xla' for each of the "
                         "three conv slots; got {}".format(impls))
    b, h, w_sp, c = x.shape
    f = params["w1"].shape[1]
    n = b * h * w_sp
    x2d = x.reshape(n, c)

    y1, s1, q1 = _SLOTS[impls[0]][0](x2d, params["w1"])
    sc1, sh1, m1, v1 = _affine(s1, q1, n, params["gamma1"], params["beta1"])
    y2, s2, q2 = _SLOTS[impls[1]][1](y1.reshape(b, h, w_sp, f), params["w2"],
                                     sc1, sh1)
    sc2, sh2, m2, v2 = _affine(s2, q2, n, params["gamma2"], params["beta2"])
    y3, s3, q3 = _SLOTS[impls[2]][0](y2.reshape(n, f), params["w3"], sc2,
                                     sh2)
    sc3, sh3, m3, v3 = _affine(s3, q3, n, params["gamma3"], params["beta3"])

    # Elementwise tail: bn3-apply + residual + relu.
    out = torch.clamp_min(y3.float() * sc3 + sh3 + x2d.float(),
                          0.0).to(x.dtype)
    return out.reshape(b, h, w_sp, c), ((m1, v1), (m2, v2), (m3, v3))


def reference_forward(params, x):
    """Plain equivalent of the flax block's math (``reference_forward`` of
    the JAX module): f32 convs rounded to the input dtype, two-pass
    batch statistics."""
    dt = x.dtype

    def bn(y, gamma, beta):
        yf = y.float()
        mean = yf.mean(dim=(0, 1, 2))
        var = yf.var(dim=(0, 1, 2), unbiased=False)
        return ((yf - mean) / torch.sqrt(var + EPS) * gamma + beta).to(dt)

    def conv1x1(y, w):
        return (y.float() @ w.float()).to(dt)

    y = conv1x1(x, params["w1"])
    y = torch.relu(bn(y, params["gamma1"], params["beta1"]))
    y = F.conv2d(y.float().permute(0, 3, 1, 2),
                 params["w2"].float().permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1).to(dt)
    y = torch.relu(bn(y, params["gamma2"], params["beta2"]))
    y = conv1x1(y, params["w3"])
    y = bn(y, params["gamma3"], params["beta3"])
    return torch.relu(y.float() + x.float()).to(dt)
