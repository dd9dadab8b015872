"""The port's fused ResNet bottleneck (``ops/fused_resnet_block.py``) held
against the JAX package's, whose Pallas kernels run in interpret mode.

The same numpy-seeded inputs and the JAX ``init_params`` weights (carried
by ``convert.fused_block_params_from_jax``) go through both at the shapes
of ``tests/test_fused_block.py`` (b4, 8x8, C 32/64, F 16) with non-identity
norms. On the CPU the wrappers run their plain versions, so these tests
pin the plain versions' arithmetic: B5's f32 prologue, B6's bf16 prologue
with the zero border after it, the f32 statistics of the f32 product.

Tolerances, each with its reading (largest over the cases):
* y: f32 2e-6 (read 4.8e-7 at values up to 3; 1.9e-6 at values up to 7.8
  in the border case, held at 4e-6); bf16 within one rounding of JAX's
  in at most 1% of the values (read: bitwise) — f32 sums in another order
  may flip a rounding;
* the sums of y and y^2: 1e-6 of their largest value (read 1.6e-7);
* block output: f32 5e-6 (read 1.9e-6 at values up to 4.6); bf16 one
  rounding in at most 1% of values (read 1.5e-8 on one value of 8192);
  the batch means and variances 4e-6 of their largest (read 6.4e-7);
* the JAX tests' own 5e-2 where a test of theirs is ported.

The launch-plan tests need no JAX: they hold the bf16 kernels' plans
(``matmul_plan``, ``conv3x3_plan``) to covering every output once, keeping
each halo inside its image and fitting a block's shared memory, through a
model of the kernels' index arithmetic kept below.
"""

import ctypes
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.ops import fused_resnet_block as jfrb
from tensorflowonspark_tpu_torch import convert, initializers
from tensorflowonspark_tpu_torch.ops import fused_resnet_block as frb

B, S, F_ = 4, 8, 16
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}
Y_TOL = 2e-6
BORDER_TOL = 4e-6
BF16_MAX_DIFFERING = 0.01
SUM_RTOL = 1e-6
OUT_TOL = 5e-6
STAT_RTOL = 4e-6
_JAX = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_params(c, f, seed=0, dtype=jnp.bfloat16):
    """``tests/test_fused_block.py``'s ``_params``: the JAX init, then
    non-identity norms."""
    params = jfrb.init_params(jax.random.PRNGKey(seed), c, f, dtype=dtype)
    rng = np.random.RandomState(seed + 1)
    for i, width in (("1", f), ("2", f), ("3", c)):
        params["gamma" + i] = jnp.asarray(
            1.0 + 0.2 * rng.randn(width), jnp.float32)
        params["beta" + i] = jnp.asarray(0.1 * rng.randn(width), jnp.float32)
    return params


def _port(params):
    return convert.fused_block_params_from_jax(jax.device_get(params))


def _x(seed, c, jdt, b=B):
    return jnp.asarray(np.random.RandomState(seed).randn(b, S, S, c) * 0.5,
                       jdt)


def _t(a):
    """A JAX array as a torch tensor of the same dtype."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr.view(np.uint16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _affine_vectors(width, seed):
    rng = np.random.RandomState(seed)
    scale = (1.0 + 0.3 * rng.randn(1, width)).astype(np.float32)
    shift = (0.3 * rng.randn(1, width)).astype(np.float32)
    return scale, shift


def _check_y(kind, got, want, tol=Y_TOL):
    got, want = _f32(got), _f32(want)
    if kind == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        return
    # One bf16 rounding apart at most, in a small share of the values.
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6)
    assert (got != want).mean() <= BF16_MAX_DIFFERING


def _check_sums(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=SUM_RTOL * np.abs(want).max())


# -- B5 ------------------------------------------------------------------------


@pytest.mark.parametrize("prologue", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_conv1x1_stats_plain_matches_pallas(kind, prologue):
    jdt, tdt = DTYPES[kind]
    params = _jax_params(32, F_, seed=2, dtype=jdt)
    if prologue:        # K3: (N, F) . (F, C) after the bn2 affine
        w = params["w3"]
        scale, shift = _affine_vectors(F_, 5)
    else:               # K1: (N, C) . (C, F)
        w = params["w1"]
        scale = shift = None
    x2d = _x(3, w.shape[0], jdt).reshape(-1, w.shape[0])
    js = None if scale is None else jnp.asarray(scale)
    jh = None if shift is None else jnp.asarray(shift)
    want = jfrb._conv1x1_stats(x2d, w, js, jh, block_rows=64, interpret=True)
    ts = None if scale is None else torch.from_numpy(scale)
    th = None if shift is None else torch.from_numpy(shift)
    got = frb._conv1x1_stats(_t(x2d), _t(w), ts, th)
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    _check_y(kind, got[0], want[0])
    _check_sums(got[1], want[1])
    _check_sums(got[2], want[2])
    assert frb.launches == {"matmul_stats": 0, "conv3x3_stats": 0}


# -- B6 ------------------------------------------------------------------------


def _conv3x3_case(kind, shift_offset=0.0):
    jdt, _ = DTYPES[kind]
    params = _jax_params(32, F_, seed=4, dtype=jdt)
    x = _x(6, F_, jdt)
    scale, shift = _affine_vectors(F_, 7)
    shift = shift + shift_offset
    want = jfrb._conv3x3_stats(x, params["w2"], jnp.asarray(scale),
                               jnp.asarray(shift), interpret=True)
    got = frb._conv3x3_stats(_t(x), _t(params["w2"]),
                             torch.from_numpy(scale), torch.from_numpy(shift))
    return got, want


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_conv3x3_stats_plain_matches_pallas(kind):
    for offset, tol in ((0.0, Y_TOL), (3.0, BORDER_TOL)):
        got, want = _conv3x3_case(kind, shift_offset=offset)
        assert got[0].shape == (B, S, S, F_)
        _check_y(kind, got[0], want[0], tol=tol)
        _check_sums(got[1], want[1])
        _check_sums(got[2], want[2])


def test_conv3x3_border_is_zero_after_the_prologue():
    """With a large positive shift, relu(x*scale + shift) is far from zero
    everywhere inside the image: a version that padded first and applied the
    prologue to the padding would add relu(shift) on every border pixel.
    The plain version matches JAX at the border, and the padding-first
    variant visibly does not."""
    got, want = _conv3x3_case("bf16", shift_offset=3.0)
    y, ref = _f32(got[0]), _f32(want[0])
    border = np.ones((S, S), bool)
    border[1:-1, 1:-1] = False
    np.testing.assert_allclose(y[:, border], ref[:, border], rtol=2.0 ** -8,
                               atol=1e-6)
    _check_y("bf16", got[0], want[0])
    # Padding first: the border taps see relu(0 * scale + shift).
    params = _jax_params(32, F_, seed=4)
    x = _t(_x(6, F_, jnp.bfloat16))
    scale, shift = _affine_vectors(F_, 7)
    shift = torch.from_numpy(shift + 3.0).to(torch.bfloat16)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    xb = torch.clamp_min(xp * torch.from_numpy(scale).to(torch.bfloat16)
                         + shift, 0.0)
    wrong = torch.nn.functional.conv2d(
        xb.float().permute(0, 3, 1, 2),
        _t(params["w2"]).float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    assert np.abs(wrong.numpy()[:, border] - ref[:, border]).max() > 1.0


# -- the block -----------------------------------------------------------------


def _jax_block(kind, c, seed_x, seed_p):
    key = (kind, c, seed_x, seed_p)
    if key not in _JAX:
        jdt, _ = DTYPES[kind]
        params = _jax_params(c, F_, seed=seed_p, dtype=jdt)
        x = _x(seed_x, c, jdt)
        out, stats = jfrb.bottleneck_forward(params, x, interpret=True)
        _JAX[key] = (params, x, out, stats)
    return _JAX[key]


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_bottleneck_forward_matches_pallas_chain(kind):
    params, x, want, want_stats = _jax_block(kind, 32, 0, 0)
    got, stats = frb.bottleneck_forward(_port(params), _t(x))
    assert got.dtype == DTYPES[kind][1] and got.shape == (B, S, S, 32)
    _check_y(kind, got, want, tol=OUT_TOL)
    for (gm, gv), (wm, wv) in zip(stats, want_stats):
        for a, b in ((gm, wm), (gv, wv)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=STAT_RTOL * np.abs(b).max())


def test_forward_matches_reference():
    """``tests/test_fused_block.py::test_forward_matches_reference`` across
    the two packages: the port's chain against JAX's ``reference_forward``
    (the flax block's math) at 5e-2, the conv-1 moments against x . w1; and
    the port's ``reference_forward`` against JAX's."""
    params, x, _, _ = _jax_block("bf16", 32, 0, 0)
    p, xt = _port(params), _t(x)
    ref = _f32(jfrb.reference_forward(params, x))
    out, stats = frb.bottleneck_forward(p, xt)
    np.testing.assert_allclose(_f32(out), ref, atol=5e-2, rtol=5e-2)
    (m1, v1), _, _ = stats
    y1 = _f32(xt.reshape(-1, 32)) @ _f32(p["w1"])
    np.testing.assert_allclose(m1.numpy(), y1.mean(0), atol=2e-2)
    np.testing.assert_allclose(v1.numpy(), y1.var(0), rtol=5e-2, atol=2e-2)
    # Both reference_forwards: bf16 roundings of f32 convs summed in
    # another order (read: bitwise).
    _check_y("bf16", frb.reference_forward(p, xt), ref)


def test_forward_matches_flax_block():
    """``tests/test_fused_block.py::test_forward_matches_flax_block``: the
    port's chain against the flax ``BottleneckBlock`` in train mode with the
    same weights (c == 4f, the stride-1 no-projection geometry)."""
    import flax.linen as nn

    from tensorflowonspark_tpu.models.resnet import BottleneckBlock

    c = 64
    x = _x(1, c, jnp.bfloat16)
    params = _jax_params(c, F_, seed=3)
    conv = functools.partial(nn.Conv, use_bias=False, dtype=jnp.bfloat16)
    norm = functools.partial(
        nn.BatchNorm, use_running_average=False, momentum=0.9,
        epsilon=1e-5, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    block = BottleneckBlock(filters=F_, strides=1, conv=conv, norm=norm)
    variables = block.init(jax.random.PRNGKey(0), x)
    fparams = jax.tree_util.tree_map(lambda v: v, variables["params"])
    for mod, name, val in (
            ("Conv_0", "kernel", np.asarray(params["w1"])[None, None]),
            ("Conv_1", "kernel", np.asarray(params["w2"])),
            ("Conv_2", "kernel", np.asarray(params["w3"])[None, None]),
            ("BatchNorm_0", "scale", params["gamma1"]),
            ("BatchNorm_0", "bias", params["beta1"]),
            ("BatchNorm_1", "scale", params["gamma2"]),
            ("BatchNorm_1", "bias", params["beta2"]),
            ("BatchNorm_2", "scale", params["gamma3"]),
            ("BatchNorm_2", "bias", params["beta3"])):
        fparams[mod][name] = jnp.asarray(val)
    want, _ = block.apply({"params": fparams,
                           "batch_stats": variables["batch_stats"]},
                          x, mutable=["batch_stats"])
    got, _ = frb.bottleneck_forward(_port(params), _t(x))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("impls", [
    ("xla", "pallas", "pallas"),
    ("pallas", "xla", "pallas"),
    ("pallas", "pallas", "xla"),
])
def test_impl_swaps_are_equivalent(impls):
    """The per-slot library renditions compute the same block (JAX's
    5e-2)."""
    params, x, _, _ = _jax_block("bf16", 32, 4, 7)
    p, xt = _port(params), _t(x)
    want, _ = frb.bottleneck_forward(p, xt)
    got, _ = frb.bottleneck_forward(p, xt, impls=impls)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=5e-2, rtol=5e-2)


def test_bad_impls_raise():
    params, x, _, _ = _jax_block("bf16", 32, 4, 7)
    with pytest.raises(ValueError, match="impls"):
        frb.bottleneck_forward(_port(params), _t(x), impls=("mosaic",) * 3)


# -- parameters ----------------------------------------------------------------


def test_init_params_layout_and_scale():
    c, f = 256, 64
    p = frb.init_params(c, f, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    want = jax.device_get(jfrb.init_params(jax.random.PRNGKey(0), c, f))
    for name, val in p.items():
        assert tuple(val.shape) == want[name].shape, name
        assert str(val.dtype).split(".")[-1] == want[name].dtype.name, name
    assert float(p["gamma3"].abs().sum()) == 0.0
    assert float(p["gamma1"].sum()) == f
    # Truncated he-normal: variance 2 / fan_in, nothing past 2 std.
    for name, fan_in in (("w1", c), ("w2", 9 * f), ("w3", f)):
        w = p[name].float()
        std = (2.0 / fan_in) ** 0.5 / initializers.TRUNC_STD
        assert abs(float(w.var()) * fan_in / 2.0 - 1.0) < 0.1, name
        assert float(w.abs().max()) <= 2.0 * std * 1.01, name


def test_fused_block_params_from_jax_checks_shapes():
    params = jax.device_get(_jax_params(32, F_))
    p = convert.fused_block_params_from_jax(params)
    assert p["w1"].dtype == torch.bfloat16 and p["gamma1"].dtype == \
        torch.float32
    np.testing.assert_array_equal(p["w2"].float().numpy(),
                                  np.asarray(params["w2"], np.float32))
    bad = dict(params, w3=np.zeros((F_, 16), np.float32))
    with pytest.raises(ValueError, match="w3"):
        convert.fused_block_params_from_jax(bad)
    with pytest.raises(ValueError, match="missing"):
        convert.fused_block_params_from_jax(
            {k: v for k, v in params.items() if k != "beta2"})


def test_wrappers_check_their_operands():
    x = torch.zeros(64, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="disagree"):
        frb._conv1x1_stats(x, torch.zeros(16, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="together"):
        frb._conv1x1_stats(x, torch.zeros(32, 8, dtype=torch.bfloat16),
                           scale=torch.ones(32))
    with pytest.raises(ValueError, match="3, 3"):
        frb._conv3x3_stats(torch.zeros(1, 4, 4, 8), torch.zeros(1, 1, 8, 8),
                           torch.ones(8), torch.zeros(8))


def test_ctypes_signatures_match_the_cuda_source():
    """Each wrapper's ctypes argument list is the C declaration's in
    ``csrc/fused_resnet_block.cu``: a slot typed ``int`` where the source
    takes a pointer, or one missing, would pass a truncated address or
    stream to the host entry point on the card."""
    src = os.path.join(os.path.dirname(frb.__file__), os.pardir, "csrc",
                       "fused_resnet_block.cu")
    with open(src) as f:
        decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                f.read()))
    assert sorted(decls) == sorted(frb._SIGNATURES)
    for name, params in decls.items():
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in params.split(",")]
        assert all("*" in p or p.split()[0] == "int"
                   for p in params.split(",")), name
        assert frb._argtypes(name) == want, name



# -- launch plan ---------------------------------------------------------------

# (b, h, w, C, F): the JAX test shape, ResNet-50's stride-1 stages 1-4 at
# b256, and a ragged shape (429 pixels, no multiple of a tile; F = 40, part
# of a column tile).
PLAN_SHAPES = {
    "jax_test": (B, S, S, 32, F_),
    "stage1": (256, 56, 56, 256, 64),
    "stage2": (256, 28, 28, 512, 128),
    "stage3": (256, 14, 14, 1024, 256),
    "stage4": (256, 7, 7, 2048, 512),
    "ragged": (3, 13, 11, 24, 40),
}
# H100 SXM and PCIe SM counts: the grid is one wave of whichever card.
SM_COUNTS = (132, 114)


def _block_items(plan, x):
    """The items block row ``x`` walks, in order."""
    return range(x, plan.items, plan.groups)


# A model of the bf16 kernels' index arithmetic (csrc/fused_resnet_block.cu),
# for the plan tests. ``item`` may be a column of items.


def _strip_pixels(plan, b, h, w, item):
    """B6: the output pixel of each of the 256 rows of ``item``, or -1
    (``strip_pixel`` in the source)."""
    m = torch.arange(256)
    per = plan.strip_rows * w
    g, rem = m // per, m % per
    yy, xx = rem // w, rem % w
    spi = frb._cdiv(h, plan.strip_rows)
    st = item * plan.strips_per_block + g
    img, y0 = st // spi, (st % spi) * plan.strip_rows
    ok = (g < plan.strips_per_block) & (st < b * spi) & (y0 + yy < h)
    return torch.where(ok, (img * h + y0 + yy) * w + xx, -1)


def _halo_centres(plan, w):
    """B6: the halo pixel each block row reads at the centre tap
    (tap (dy, dx) reads it plus dy * (w + 2) + dx); rows past the layout
    read a pixel whose nine taps stay in the tile."""
    m = torch.arange(256)
    per = plan.strip_rows * w
    g, rem = m // per, m % per
    yy, xx = rem // w, rem % w
    base = (g * (plan.strip_rows + 2) + yy + 1) * (w + 2) + xx + 1
    return torch.where(m < plan.rows, base, w + 3)


def _halo_pixels(plan, b, h, w, item):
    """B6: the source pixel of each halo pixel of ``item``, or -1
    where the tile holds a zero (outside the image, or past the last
    strip)."""
    hr, hw = plan.strip_rows + 2, w + 2
    hp = torch.arange(plan.strips_per_block * hr * hw)
    g, rem = hp // (hr * hw), hp % (hr * hw)
    hy, gx = rem // hw, rem % hw - 1
    spi = frb._cdiv(h, plan.strip_rows)
    st = item * plan.strips_per_block + g
    img = st // spi
    gy = (st % spi) * plan.strip_rows + hy - 1
    ok = (st < b * spi) & (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    return torch.where(ok, (img * h + gy) * w + gx, -1)


def _covered_once(counts):
    return bool((counts == 1).all())


def _check_columns(plan, fout):
    starts = torch.arange(plan.col_tiles) * plan.block_n
    assert int(starts[-1]) < fout <= int(starts[-1]) + plan.block_n
    cols = torch.cat([torch.arange(s, min(s + plan.block_n, fout))
                      for s in starts.tolist()])
    assert _covered_once(torch.bincount(cols, minlength=fout))


def _walked_items(plan):
    """Every item the grid's block rows walk, with repeats."""
    return torch.tensor([i for x in range(plan.groups)
                         for i in _block_items(plan, x)])


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_matmul_plan_covers_every_row_and_channel_once(shape, dtype):
    """B5's plan (K1: C -> F, K3: F -> C) hands every row tile to exactly
    one block row and every output channel to exactly one column tile,
    stays in the shared memory of a block and launches one wave."""
    b, h, w, c, f = PLAN_SHAPES[shape]
    n = b * h * w
    for sm in SM_COUNTS:
        for cin, fout in ((c, f), (f, c)):
            plan = frb.matmul_plan(n, cin, fout, dtype, sm)
            items = _walked_items(plan)
            assert _covered_once(torch.bincount(items,
                                                minlength=plan.items))
            rows = (items[:, None] * plan.rows
                    + torch.arange(plan.rows)).reshape(-1)
            assert _covered_once(torch.bincount(rows[rows < n], minlength=n))
            assert int(rows.max()) >= n - 1
            _check_columns(plan, fout)
            if dtype == torch.bfloat16:
                assert plan.block_n >= min(fout, 256)
                assert plan.smem == frb._smem_bf16(1, plan.block_n,
                                                   plan.rows, cin)
                assert 0 < plan.smem <= frb._SMEM_LIMIT
                assert plan.groups * plan.col_tiles <= sm
            else:
                assert plan.smem == 0 and plan.block_n == 64


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_conv3x3_plan_covers_every_pixel_once_inside_its_image(shape):
    """B6's bf16 plan: the strips of all items hold every output pixel
    exactly once; each item's halo tile holds only pixels of its strips'
    own images (zeros elsewhere), and every tap of every output pixel,
    read at the tile offset the kernel reads, is that pixel's neighbour or
    a zero where the neighbour is outside the image; the tile and its
    stages stay in a block's shared memory."""
    b, h, w, _, f = PLAN_SHAPES[shape]
    n = b * h * w
    for sm in SM_COUNTS:
        plan = frb.conv3x3_plan(b, h, w, f, torch.bfloat16, sm)
        halo_rows = plan.strips_per_block * (plan.strip_rows + 2) * (w + 2)
        assert plan.rows == plan.strips_per_block * plan.strip_rows * w
        assert plan.rows <= 256
        assert plan.smem == frb._smem_bf16(9, plan.block_n, halo_rows, f)
        assert plan.smem <= frb._SMEM_LIMIT
        assert plan.groups * plan.col_tiles <= sm
        _check_columns(plan, f)
        items = _walked_items(plan)
        assert _covered_once(torch.bincount(items, minlength=plan.items))
        item = torch.arange(plan.items)[:, None]
        pix = _strip_pixels(plan, b, h, w, item)
        assert _covered_once(torch.bincount(pix[pix >= 0], minlength=n))
        halo = _halo_pixels(plan, b, h, w, item)
        assert halo.shape == (plan.items, halo_rows)
        # Halo pixel -> the image of its strip.
        hp = torch.arange(halo_rows)
        strip = item * plan.strips_per_block + hp // (halo_rows
                                                      // plan.strips_per_block)
        img = strip // -(-h // plan.strip_rows)
        inside = halo >= 0
        assert bool((halo[inside] // (h * w) == img.expand_as(halo)[inside])
                    .all())
        centre = _halo_centres(plan, w)
        valid = pix >= 0
        yy, xx = (pix // w) % h, pix % w
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                got = halo[:, centre + dy * (w + 2) + dx]
                ny, nx = yy + dy, xx + dx
                want = torch.where((ny >= 0) & (ny < h) & (nx >= 0)
                                   & (nx < w), pix + dy * w + dx, -1)
                assert torch.equal(got[valid], want[valid]), (dy, dx)


@pytest.mark.watchdog_timeout(120)
def test_conv3x3_plan_f32_and_limits():
    """The f32 parity kernel's plan is its 64 x 64 tiles, 8 blocks an SM;
    an image too wide for a strip of one row raises."""
    for b, h, w, _, f in PLAN_SHAPES.values():
        plan = frb.conv3x3_plan(b, h, w, f, torch.float32, 132)
        assert plan.block_n == 64 and plan.smem == 0
        assert plan.groups == min(-(-b * h * w // 64),
                                  -(-8 * 132 // plan.col_tiles))
    with pytest.raises(ValueError, match="wide"):
        frb.conv3x3_plan(1, 4, 300, 64, torch.bfloat16, 132)
