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

import importlib.util
import os

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
