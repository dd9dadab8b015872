"""Port of the paged-attention decode step, held against the JAX package.

The port's plain version (the one its wrapper runs for CPU tensors) is
compared on the same seeded operands with the JAX Pallas kernel in
interpret mode — the JAX tests' own way off-TPU — and with the JAX lax
walk ``_paged_cache_attention``, at the tolerances of
``tests/test_ops_paged_attention.py``: f32 1e-5, bf16 2e-2, int8 pages
1e-4. The CUDA kernel itself runs only on the card (``chip_smoke.py``
holds it against this plain version); here the wrapper must refuse any
tensor that is not on the CPU instead of computing elsewhere.
"""

import ctypes
import importlib.util
import os
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import transformer as jax_transformer
from tensorflowonspark_tpu.ops import paged_attention as jax_pa
from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.ops import paged_attention as pa


def _case(seed, dtype, quant, h, h_kv, d=16, b=3, ps=8, tw=6, n_pages=20,
          lens=(5, 17, 40)):
    """Numpy operands of ``tests/test_ops_paged_attention.py``'s ``_case``:
    b rows holding tw pool pages each in a permuted table, staggered
    extents. ``dtype`` is "f32" or "bf16"."""
    rs = np.random.default_rng(seed)
    np_dtype = np.float32 if dtype == "f32" else ml_dtypes.bfloat16
    q = rs.standard_normal((b, 1, h, d)).astype(np_dtype)
    table = rs.permutation(np.arange(1, n_pages))[:b * tw].reshape(
        b, tw).astype(np.int32)
    seq_lens = np.asarray(lens, np.int32)
    if quant:
        kp = rs.integers(-127, 128, (n_pages, ps, h_kv, d)).astype(np.int8)
        vp = rs.integers(-127, 128, (n_pages, ps, h_kv, d)).astype(np.int8)
        ks = (rs.random((n_pages, ps, h_kv)) * 0.02 + 1e-3).astype(np.float32)
        vs = (rs.random((n_pages, ps, h_kv)) * 0.02 + 1e-3).astype(np.float32)
    else:
        kp = rs.standard_normal((n_pages, ps, h_kv, d)).astype(np_dtype)
        vp = rs.standard_normal((n_pages, ps, h_kv, d)).astype(np_dtype)
        ks = vs = None
    return dict(q=q, k_pages=kp, v_pages=vp, page_table=table,
                seq_lens=seq_lens, page_size=ps, k_scales=ks, v_scales=vs)


def _to_torch(x):
    if x is None:
        return None
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _to_jax(x):
    return None if x is None else jnp.asarray(x)


def _port(case):
    c = {k: _to_torch(v) if isinstance(v, np.ndarray) else v
         for k, v in case.items()}
    return pa.paged_attention(
        c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["seq_lens"],
        page_size=c["page_size"], k_scales=c["k_scales"],
        v_scales=c["v_scales"])


def _jax_both(case):
    c = {k: _to_jax(v) if isinstance(v, np.ndarray) else v
         for k, v in case.items()}
    kernel = jax_pa.paged_attention(
        c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["seq_lens"],
        page_size=c["page_size"], k_scales=c["k_scales"],
        v_scales=c["v_scales"])
    walk = jax_transformer._paged_cache_attention(
        c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["seq_lens"],
        c["page_size"], k_scales=c["k_scales"], v_scales=c["v_scales"])
    return (np.asarray(kernel, np.float32), np.asarray(walk, np.float32))


@pytest.mark.parametrize("name,args,atol", [
    ("f32", (0, "f32", False, 4, 4), 1e-5),
    ("bf16", (1, "bf16", False, 4, 4), 2e-2),
    ("int8", (2, "f32", True, 4, 4), 1e-4),
    ("gqa", (3, "f32", False, 8, 2), 1e-5),
    ("gqa_int8_bf16", (4, "bf16", True, 8, 4), 2e-2),
])
def test_plain_version_matches_jax_kernel_and_walk(name, args, atol):
    case = _case(*args)
    got = _port(case)
    assert got.shape == case["q"].shape
    assert got.dtype == (torch.float32 if args[1] == "f32"
                         else torch.bfloat16)
    got = got.float().numpy()
    kernel, walk = _jax_both(case)
    np.testing.assert_allclose(got, kernel, atol=atol)
    np.testing.assert_allclose(got, walk, atol=atol)


def test_out_of_extent_pages_are_inert():
    """Pool pages no row's extent reaches (garbage in them) must not move
    the output: poisoned and clean pools give bitwise equal results."""
    case = _case(5, "f32", False, 4, 4, lens=(3, 9, 20))
    clean = _port(case)
    ps = case["page_size"]
    live = {0}
    for r in range(case["page_table"].shape[0]):
        live.update(case["page_table"][r, :int(case["seq_lens"][r]) // ps
                                       + 1].tolist())
    for pg in range(case["k_pages"].shape[0]):
        if pg not in live:
            case["k_pages"][pg] = 1e6
            case["v_pages"][pg] = -1e6
    poisoned = _port(case)
    assert torch.equal(clean, poisoned)
    kernel, _ = _jax_both(case)
    np.testing.assert_allclose(poisoned.numpy(), kernel, atol=1e-5)


def test_validation_is_loud():
    c = {k: _to_torch(v) if isinstance(v, np.ndarray) else v
         for k, v in _case(6, "f32", False, 4, 4).items()}
    args = (c["k_pages"], c["v_pages"], c["page_table"], c["seq_lens"])
    with pytest.raises(ValueError):  # multi-token step
        pa.paged_attention(torch.zeros(3, 2, 4, 16), *args, page_size=8)
    with pytest.raises(ValueError):  # page_size / pool page dim mismatch
        pa.paged_attention(c["q"], *args, page_size=16)
    with pytest.raises(ValueError):  # GQA needs h divisible by h_kv
        pa.paged_attention(torch.zeros(3, 1, 6, 16), *args, page_size=8)
    with pytest.raises(ValueError):  # unscaled pages in another dtype
        pa.paged_attention(c["q"].to(torch.bfloat16), *args, page_size=8)


def test_wrapper_never_computes_off_the_cpu():
    """The plain version is for CPU tensors only: any other device must
    launch the kernel or raise — here (no card) it raises."""
    c = {k: _to_torch(v) if isinstance(v, np.ndarray) else v
         for k, v in _case(7, "f32", False, 4, 4).items()}
    meta = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
            for k, v in c.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_attention(
            meta["q"], meta["k_pages"], meta["v_pages"], meta["page_table"],
            meta["seq_lens"], page_size=8)
    before = pa.launches
    pa.paged_attention(c["q"], c["k_pages"], c["v_pages"], c["page_table"],
                       c["seq_lens"], page_size=8)
    assert pa.launches == before  # the plain version is not a launch


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build.os, "makedirs", lambda *a, **k: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def _walk_skipping(c, skip):
    """The plain walk with one of its bf16 roundings skipped: ``"score"``
    keeps q·k in f32, ``"pv"`` keeps p and the page's PV partial in f32."""
    q, k_pages, v_pages = c["q"], c["k_pages"], c["v_pages"]
    b, _, h, d = q.shape
    ps = c["page_size"]
    lens = c["seq_lens"].long()
    scale = pa._scale(d)
    m = torch.full((b, h, 1), -1e30)
    l = torch.zeros((b, h, 1))
    acc = torch.zeros((b, h, 1, d))
    for chunk in range((int(lens.max()) + ps) // ps):
        ids = c["page_table"][:, chunk].long()
        k_c, v_c = k_pages[ids], v_pages[ids]
        if skip == "score":
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_c.float())
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", q, k_c).float()
        visible = ((chunk * ps + torch.arange(ps))[None, :]
                   <= lens[:, None])[:, None, None, :]
        s = torch.where(visible, s * scale, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(visible, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        if skip == "pv":
            pv = torch.einsum("bhqk,bkhd->bhqd", p, v_c.float())
        else:
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v_c.dtype),
                              v_c).float()
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l[..., None]).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("skip", ["score", "pv"])
def test_bf16_bit_check_catches_a_skipped_rounding(skip):
    """``chip_smoke.py`` lets at most ``BF16_MAX_DIFFERING`` of the
    kernel's bf16 outputs differ from the plain version. A walk that skips
    one of the roundings the kernel must mirror differs in far more, at
    the bench shapes the check runs (h=12, d=64, page_size 64)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    case = _case(8, "bf16", False, 12, 12, d=64, b=8, ps=64, tw=8,
                 n_pages=65, lens=(5, 60, 64, 130, 200, 300, 450, 511))
    c = {k: _to_torch(v) if isinstance(v, np.ndarray) else v
         for k, v in case.items()}
    ref = pa.paged_attention_reference(
        c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["seq_lens"],
        page_size=c["page_size"])
    differing = float((_walk_skipping(c, skip) != ref).float().mean())
    assert differing > 10 * smoke.BF16_MAX_DIFFERING


def _pages(c, chunk):
    """Page ``chunk`` of every row as the plain walk gathers it: K and V
    dequantized to q's dtype and repeated over the query heads of each KV
    head."""
    tw = c["page_table"].shape[1]
    ids = c["page_table"][:, min(chunk, tw - 1)].long()
    k_c, v_c = c["k_pages"][ids], c["v_pages"][ids]
    if c["k_scales"] is not None:
        k_c = pa._kv_dequantize(k_c, c["k_scales"][ids], c["q"].dtype)
        v_c = pa._kv_dequantize(v_c, c["v_scales"][ids], c["q"].dtype)
    reps = c["q"].shape[2] // k_c.shape[2]
    if reps > 1:
        k_c = torch.repeat_interleave(k_c, reps, dim=2)
        v_c = torch.repeat_interleave(v_c, reps, dim=2)
    return k_c, v_c


def _split_walk(c, local_max=False):
    """The page walk split as the kernel splits it, on the same per-page
    einsums as ``paged_attention_reference``: every page's scores and
    maximum first (independent pages); the running max m_c of each page by
    ``torch.cummax``; every page's p, sum and rounded PV partial against
    its m_c (independent again); then the walk's sequential combine over
    each row's own pages. ``local_max=True`` is the usual split-KV instead:
    each page against its own maximum, rescaled to the row's maximum at
    the combine."""
    q = c["q"]
    b, _, h, d = q.shape
    ps = c["page_size"]
    lens = c["seq_lens"].long()
    scale = pa._scale(d)
    n_chunks = (int(lens.max()) + ps) // ps
    scores, visible, values = [], [], []
    for chunk in range(n_chunks):
        k_c, v_c = _pages(c, chunk)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_c).float() * scale
        vis = ((chunk * ps + torch.arange(ps))[None, :]
               <= lens[:, None])[:, None, None, :]
        scores.append(torch.where(vis, s, -1e30))
        visible.append(vis)
        values.append(v_c)
    page_max = torch.stack([s.amax(dim=-1) for s in scores])
    m_c = page_max if local_max else torch.cummax(page_max, dim=0).values
    sums, pvs = [], []
    for chunk in range(n_chunks):
        p = torch.where(visible[chunk],
                        torch.exp(scores[chunk] - m_c[chunk][..., None]), 0.0)
        sums.append(p.sum(dim=-1))
        pvs.append(torch.einsum("bhqk,bkhd->bhqd", p.to(values[chunk].dtype),
                                values[chunk]).float())
    # A row's pages: 0 .. seq_len // page_size; the kernel reads no other.
    own = [(chunk <= lens // ps)[:, None, None] for chunk in range(n_chunks)]
    if local_max:
        m = torch.stack([torch.where(o, mc, -1e30)
                         for o, mc in zip(own, m_c)]).amax(dim=0)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(pvs[0])
        for chunk in range(n_chunks):
            w = torch.where(own[chunk], torch.exp(m_c[chunk] - m), 0.0)
            l = l + sums[chunk] * w
            acc = acc + pvs[chunk] * w[..., None]
    else:
        m = torch.full_like(m_c[0], -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(pvs[0])
        for chunk in range(n_chunks):
            corr = torch.exp(m - m_c[chunk])
            o = own[chunk]
            l = torch.where(o, l * corr + sums[chunk], l)
            acc = torch.where(o[..., None], acc * corr[..., None] + pvs[chunk],
                              acc)
            m = torch.where(o, m_c[chunk], m)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.watchdog_timeout(120)
@pytest.mark.parametrize("name,args", [
    ("f32", (20, "f32", False, 4, 4)),
    ("bf16", (21, "bf16", False, 4, 4)),
    ("int8", (22, "f32", True, 4, 4)),
    ("int8_bf16", (23, "bf16", True, 4, 4)),
    ("gqa_f32", (24, "f32", False, 8, 2)),
    ("gqa_bf16", (25, "bf16", False, 8, 2)),
    ("mqa_f32", (26, "f32", False, 8, 1)),
    ("mqa_bf16", (27, "bf16", False, 8, 1)),
])
def test_split_walk_is_the_sequential_walk_bit_for_bit(name, args):
    """The kernel's split of the walk across pages (every page's scores
    and maximum, the prefix max, every page's p, sum and rounded PV
    partial against it, then the sequential combine) computes exactly what
    the sequential walk computes, in every rounding: rows empty but for
    the new token, one short of a page, a page, one past it, the whole
    table, and one in between."""
    c = {k: _to_torch(v) if isinstance(v, np.ndarray) else v
         for k, v in _case(*args, b=6, ps=8, tw=6, n_pages=40,
                           lens=(0, 7, 8, 9, 47, 20)).items()}
    ref = pa.paged_attention_reference(
        c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["seq_lens"],
        page_size=c["page_size"], k_scales=c["k_scales"],
        v_scales=c["v_scales"])
    assert torch.equal(_split_walk(c), ref)


@pytest.mark.watchdog_timeout(120)
def test_bf16_bit_check_catches_the_local_max_split():
    """The usual split-KV combine (each page against its own maximum,
    rescaled at the end) rounds p and each PV partial elsewhere than the
    walk: at the bench shapes its bf16 outputs differ from the plain
    version in far more than ``chip_smoke.py``'s ``BF16_MAX_DIFFERING``,
    so the card's bit check would catch a kernel that took it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    case = _case(8, "bf16", False, 12, 12, d=64, b=8, ps=64, tw=8,
                 n_pages=65, lens=(5, 60, 64, 130, 200, 300, 450, 511))
    c = {k: _to_torch(v) if isinstance(v, np.ndarray) else v
         for k, v in case.items()}
    ref = pa.paged_attention_reference(
        c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["seq_lens"],
        page_size=c["page_size"])
    assert torch.equal(_split_walk(c), ref)
    differing = float((_split_walk(c, local_max=True) != ref).float().mean())
    assert differing > 10 * smoke.BF16_MAX_DIFFERING


@pytest.mark.watchdog_timeout(120)
def test_kernel_argtypes_match_the_c_declaration():
    """The wrapper's ctypes argument list is ``paged_decode``'s declaration
    in ``csrc/paged_attention.cu``: a slot typed ``int`` where the source
    takes a pointer would pass a truncated address to the card."""
    src = os.path.join(os.path.dirname(pa.__file__), os.pardir, "csrc",
                       "paged_attention.cu")
    with open(src) as f:
        decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                f.read()))
    assert sorted(decls) == ["paged_decode"]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
            for p in decls["paged_decode"].split(",")]
    assert pa._argtypes() == want


@pytest.mark.watchdog_timeout(120)
def test_state_words_are_zeroed_once_and_kept_per_stream(monkeypatch):
    """The kernel's state words: made zero, reused by every later call on
    the same device and stream (the kernel leaves them zero), grown by
    doubling when a call needs more, separate for another stream."""
    monkeypatch.setattr(pa, "_state", {})
    dev = torch.device("cpu")
    a = pa._state_words(dev, 7, 100)
    assert a.dtype == torch.int64 and a.numel() == 100
    assert not a.any()
    assert pa._state_words(dev, 7, 60) is a
    grown = pa._state_words(dev, 7, 150)
    assert grown.numel() == 200 and not grown.any()
    assert pa._state_words(dev, 7, 200) is grown
    assert pa._state_words(dev, 8, 10) is not grown
