"""The port's flash attention held against the JAX package's Pallas kernels.

The same numpy inputs go through ``flash_attention_with_lse`` (Pallas in
interpret mode, as ``tests/test_flash_folded.py`` runs it) and through the
port, whose wrappers take their plain versions for CPU tensors: ``out``,
``lse`` and the three gradients (with an lse cotangent, which the backward
folds into delta) across MHA, GQA (h 4 over h_kv 2 and 1), packed segments
with padding, non-causal rectangular attention, and bf16; each case at
head width 16 and again at 32 and 128, the kernels' other widths, where
the scale 1 / sqrt(d) is not a power of two. Block sizes 32 on both sides.
The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against these plain versions there).

Tolerance 1e-5 for every result. Measured: at most 1.43e-6 in f32 (dv of
the MQA case, values up to 7.8; 2.62e-6 at widths 32 and 128, dk of the
MQA case at 128), and in bf16 out, dq, dk and dv are bitwise equal — both
sides round P and dS to bf16 at the same points — with lse (f32) within
4.8e-7. One exception, at the
added widths in bf16: where an f32 sum lands within an f32 step of a bf16
rounding midpoint, the two sides' summation orders round it to
neighbouring bf16 values (read: one ``out`` value of 65,536 at width 128,
0.0483398 against 0.0485840, whose f32 sum sits one f32 step below the
midpoint). There, a bf16 result may differ by one bf16 step in at most
BF16_FLIP_SHARE of its values, and elsewhere is held to 1e-5.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.ops import flash_attention as jax_fa
from tensorflowonspark_tpu_torch.ops import attention, flash_attention as fa

B, S, H, D = 2, 64, 4, 16
BLOCK = 32
TOL = 1e-5
BF16_FLIP_SHARE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _segments(kind, s):
    seg = np.ones((B, s), np.int32)
    if kind == "packed":
        # Two documents per row and a padded tail; row 1's padding covers
        # its whole second block, which the kernels skip.
        seg[:, s // 2:] = 2
        seg[0, -s // 8:] = 0
        seg[1, BLOCK - 8:] = 0
        seg[1, :4] = 3
    return seg


# name: (h_kv, s_q, s_k, segments, causal, dtype)
BASE_CASES = {
    "mha": (H, S, S, "none", True, "f32"),
    "gqa2_packed": (2, S, S, "packed", True, "f32"),
    "mqa1_packed": (1, S, S, "packed", True, "f32"),
    "rect_full": (2, BLOCK, S, "packed", False, "f32"),
    "mha_bf16": (H, S, S, "packed", True, "bf16"),
}
# Each case at head width D, and at the kernels' widths 32 and 128 as
# "<name>_d<width>": name: (base case, head width).
CASES = {name: (name, D) for name in BASE_CASES}
CASES.update({"{}_d{}".format(name, d): (name, d) for name in BASE_CASES
              for d in fa.KERNEL_HEAD_DIMS if d != 64})
_JAX = {}


def _inputs(name):
    base, d = CASES[name]
    h_kv, s_q, s_k, seg_kind, causal, dtype = BASE_CASES[base]
    seed = sorted(BASE_CASES).index(base)
    rng = np.random.RandomState(seed if d == D else seed + d)
    arrays = dict(
        q=rng.randn(B, s_q, H, d), k=rng.randn(B, s_k, h_kv, d),
        v=rng.randn(B, s_k, h_kv, d), g=rng.randn(B, s_q, H, d),
        g_lse=rng.randn(B, H, s_q))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    if dtype == "bf16":
        # Values exactly representable in bf16 on both sides.
        arrays = {k: np.asarray(torch.tensor(v).bfloat16().float())
                  for k, v in arrays.items()}
    seg = _segments(seg_kind, s_q) if seg_kind != "none" else None
    kv_seg = None
    if seg is not None and s_k != s_q:
        kv_seg = _segments(seg_kind, s_k)
    return arrays, seg, kv_seg, causal, dtype


def _jax_result(name, grads=True):
    """(out, lse) of the Pallas kernels in interpret mode and, with
    ``grads``, (dq, dk, dv) after them, as f32 numpy; computed once per
    case. Without ``grads`` only the forward kernel is lowered, so a worker
    that runs the forward test alone does not pay for the backward's."""
    if (name, True) in _JAX:
        return _JAX[name, True] if grads else _JAX[name, True][:2]
    if (name, grads) not in _JAX:
        arrays, seg, kv_seg, causal, dtype = _inputs(name)
        jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        g = jnp.asarray(arrays["g"], jdt)
        g_lse = jnp.asarray(arrays["g_lse"])

        def forward(q, k, v):
            return jax_fa.flash_attention_with_lse(
                q, k, v, segment_ids=None if seg is None else jnp.asarray(
                    seg), kv_segment_ids=None if kv_seg is None else
                jnp.asarray(kv_seg), block_q=BLOCK, block_k=BLOCK,
                interpret=True, causal=causal)

        def loss(q, k, v):
            out, lse = forward(q, k, v)
            total = jnp.sum(out.astype(jnp.float32) * g.astype(jnp.float32))
            return total + jnp.sum(lse * g_lse), (out, lse)

        args = [jnp.asarray(arrays[n], jdt) for n in "qkv"]
        if grads:
            fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                            has_aux=True))
            (_, (out, lse)), dqkv = fn(*args)
        else:
            (out, lse), dqkv = jax.jit(forward)(*args), ()
        _JAX[name, grads] = [np.asarray(x, np.float32)
                             for x in (out, lse) + tuple(dqkv)]
    return _JAX[name, grads]


def _port_result(name):
    arrays, seg, kv_seg, causal, dtype = _inputs(name)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v = (torch.tensor(arrays[n]).to(tdt).requires_grad_()
               for n in "qkv")
    out, lse = fa.flash_attention_with_lse(
        q, k, v, segment_ids=None if seg is None else torch.tensor(seg),
        kv_segment_ids=None if kv_seg is None else torch.tensor(kv_seg),
        block_q=BLOCK, block_k=BLOCK, causal=causal)
    total = (out.float() * torch.tensor(arrays["g"])).sum()
    (total + (lse * torch.tensor(arrays["g_lse"])).sum()).backward()
    return [x.detach().float().numpy()
            for x in (out, lse, q.grad, k.grad, v.grad)]


def _assert_matches(name, label, a, b):
    """``a`` (port) against ``b`` (Pallas) to TOL; a bf16 result of an added
    width may instead sit one bf16 step away in at most BF16_FLIP_SHARE of
    its values (module docstring)."""
    assert a.shape == b.shape, label
    base, d = CASES[name]
    if d != D and BASE_CASES[base][5] == "bf16" and label != "lse":
        differ = np.abs(a - b) > TOL
        assert differ.mean() <= BF16_FLIP_SHARE, label
        step = 2.0 ** (np.floor(np.log2(np.abs(b[differ]))) - 7)
        assert np.all(np.abs(a - b)[differ] <= step), label
        return
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=label)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_lse_match_pallas(name):
    got, want = _port_result(name), _jax_result(name, grads=False)
    for label, a, b in zip(("out", "lse"), got[:2], want[:2]):
        _assert_matches(name, label, a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match_pallas_with_lse_cotangent(name):
    got, want = _port_result(name), _jax_result(name)
    for label, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        _assert_matches(name, label, a, b)


def test_head_major_entry_matches_folded_pallas():
    """The model's head-major entry against ``flash_attention_folded`` on
    the same logical tensors (q (b, h, s, d); the folded API takes K/V
    transposed to (b, h_kv, d, s)): output and all three gradients."""
    arrays, seg, _, _, _ = _inputs("gqa2_packed")
    q = arrays["q"].transpose(0, 2, 1, 3)
    k = arrays["k"].transpose(0, 2, 1, 3)
    v = arrays["v"].transpose(0, 2, 1, 3)
    w = arrays["g"].transpose(0, 2, 1, 3)

    def loss(q, kT, vT):
        out = jax_fa.flash_attention_folded(
            q, kT, vT, segment_ids=jnp.asarray(seg), block_q=BLOCK,
            block_k=BLOCK, interpret=True)
        return jnp.sum(out * w), out

    (_, want_out), (dq, dkT, dvT) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(q), jnp.asarray(k.transpose(0, 1, 3, 2)),
            jnp.asarray(v.transpose(0, 1, 3, 2)))
    tq, tk, tv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention_head_major(
        tq, tk, tv, segment_ids=torch.tensor(seg), block_q=BLOCK,
        block_k=BLOCK)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=TOL)
    np.testing.assert_allclose(tq.grad.numpy(), dq, atol=TOL)
    np.testing.assert_allclose(tk.grad.numpy(),
                               np.asarray(dkT).transpose(0, 1, 3, 2), atol=TOL)
    np.testing.assert_allclose(tv.grad.numpy(),
                               np.asarray(dvT).transpose(0, 1, 3, 2), atol=TOL)


def test_flash_causal_attention_is_the_lse_call_without_lse():
    arrays, seg, _, _, _ = _inputs("mqa1_packed")
    q, k, v = (torch.tensor(arrays[n]) for n in "qkv")
    got = fa.flash_causal_attention(q, k, v, segment_ids=torch.tensor(seg),
                                    block_q=BLOCK, block_k=BLOCK)
    want = _jax_result("mqa1_packed", grads=False)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_padded_rows_give_zero_out_and_zero_grads():
    """A fully padded query row: out 0, lse -1e30 + log(1e-30) (which is
    -1e30 in f32), and no gradient flows to or from it."""
    arrays, seg, _, _, _ = _inputs("mqa1_packed")
    q, k, v = (torch.tensor(arrays[n]).requires_grad_() for n in "qkv")
    out, lse = fa.flash_attention_with_lse(
        q, k, v, segment_ids=torch.tensor(seg), block_q=BLOCK, block_k=BLOCK)
    (out.sum() + lse.sum()).backward()
    pad = torch.tensor(seg == 0)
    assert pad.any()
    assert torch.equal(out.detach()[pad], torch.zeros_like(out[pad]))
    want_lse = torch.tensor(-1e30, dtype=torch.float32) + torch.log(
        torch.tensor(1e-30, dtype=torch.float32))
    assert torch.equal(lse.detach().transpose(1, 2)[pad],
                       want_lse.expand(int(pad.sum()), H))
    for grad in (q.grad, k.grad, v.grad):
        assert torch.equal(grad[pad], torch.zeros_like(grad[pad]))


def test_cpu_route_launches_no_kernel():
    fa.reset_launches()
    arrays, _, _, _, _ = _inputs("mha")
    q, k, v = (torch.tensor(arrays[n]).requires_grad_() for n in "qkv")
    fa.flash_causal_attention(q, k, v).sum().backward()
    assert fa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}


def test_dispatcher_routes_pallas_and_rejects_sequence_parallel():
    arrays, seg, _, _, _ = _inputs("gqa2_packed")
    q, k, v = (torch.tensor(arrays[n]) for n in "qkv")
    seg = torch.tensor(seg)
    got = attention.causal_attention(q, k, v, impl="pallas", segment_ids=seg)
    want = fa.flash_causal_attention(q, k, v, segment_ids=seg)
    assert torch.equal(got, want)
    dense = attention.causal_attention(q, k, v, impl="dense",
                                       segment_ids=seg)
    # Flash and dense sum in other orders: measured 3.6e-7.
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-6)
    for impl in ("ring", "ring_flash", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            attention.causal_attention(q, k, v, impl=impl)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        attention.causal_attention(q, k, v, impl="ring_flash",
                                   ring_layout="zigzag")
    with pytest.raises(ValueError, match="zigzag"):
        attention.causal_attention(q, k, v, impl="pallas",
                                   ring_layout="zigzag")
    with pytest.raises(ValueError, match="ring_layout"):
        attention.causal_attention(q, k, v, ring_layout="striped")
    with pytest.raises(ValueError, match="unknown"):
        attention.causal_attention(q, k, v, impl="sparse")


def test_wrappers_reject_what_they_do_not_take():
    q = torch.zeros(B, H, S, D)
    k = torch.zeros(B, 3, S, D)
    ones = torch.ones(B, S, dtype=torch.int32)
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_forward(q, k, k, ones, ones)
    k = torch.zeros(B, H, S // 2, D)
    with pytest.raises(ValueError, match="rectangular attention is "
                                         "non-causal"):
        fa.flash_forward(q, k, k, ones, ones[:, :S // 2])
    with pytest.raises(ValueError, match="kv_segment_ids"):
        fa.flash_attention_with_lse(q.transpose(1, 2), k.transpose(1, 2),
                                    k.transpose(1, 2), segment_ids=ones,
                                    causal=False)
    k = torch.zeros(B, H, S, D)
    rows = torch.zeros(B, H, S)
    with pytest.raises(ValueError, match="lse and delta"):
        fa.flash_bwd_dq(q, k, k, q, rows[:, :, :-1], rows, ones, ones)
    with pytest.raises(ValueError, match="shaped like q"):
        fa.flash_bwd_dkv(q, k, k, q[:1], rows, rows, ones, ones)
    with pytest.raises(ValueError, match="CPU tensors"):
        fa.flash_forward(q.to("meta"), q.to("meta"), q.to("meta"),
                         ones.to("meta"), ones.to("meta"))


def _entry_points():
    """``{name: (parameter names, body)}`` of each ``flash_*`` C entry point
    in ``csrc/flash_attention.cu``."""
    src = os.path.join(os.path.dirname(fa.__file__), os.pardir, "csrc",
                       "flash_attention.cu")
    with open(src) as f:
        text = f.read()
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)\s*\{(.*?)\n\}',
                         text, re.S):
        names = [p.split()[-1].lstrip("*") for p in m.group(2).split(",")]
        out[m.group(1)] = (names, m.group(3))
    return out


def test_kernel_head_dims_match_the_cuda_dispatch(monkeypatch):
    """Each C entry point takes the head width ``d`` in the slot where
    ``_dims`` passes ``q``'s, and dispatches it to an instance for each of
    ``KERNEL_HEAD_DIMS`` and no other; any other width returns an error."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    entries = _entry_points()
    assert sorted(entries) == sorted(fa._POINTERS)
    for name, (params, body) in entries.items():
        scalars = params[fa._POINTERS[name]:]
        assert scalars == ["b", "h", "h_kv", "s_q", "s_k", "d", "scale",
                           "causal", "dtype", "stream"], name
        for d in fa.KERNEL_HEAD_DIMS:
            q = torch.zeros(2, 4, 8, d)
            k = torch.zeros(2, 2, 8, d)
            passed = dict(zip(scalars, fa._dims(q, k, True)))
            assert passed["d"] == d and passed["scale"] == fa._scale(d)
        cases = re.findall(r"case (\d+): return \w+<(\d+)>\(", body)
        assert all(a == b for a, b in cases), name
        assert tuple(sorted(int(a) for a, _ in cases)) == \
            fa.KERNEL_HEAD_DIMS, name
        assert body.rstrip().endswith(
            "return static_cast<int>(cudaErrorInvalidValue);"), name


@pytest.mark.parametrize("d", [16, 48, 96, 256])
def test_kernel_route_refuses_other_head_widths(d):
    """A CUDA operand of a width no instance takes raises before any
    launch, naming the widths there are."""
    class CudaLike:
        device = torch.device("cuda", 0)
        dtype = torch.bfloat16
        shape = (1, 1, 64, d)

    with pytest.raises(ValueError, match="head_dim 32 or 64 or 128; got "
                                         "{}".format(d)):
        fa._check_kernel("flash_forward", [CudaLike()], [], [], None, None)


def test_ctypes_signatures_match_the_cuda_source():
    """Each ``flash_*`` C declaration in ``csrc/flash_attention.cu`` against
    the wrapper's ctypes argument list: a slot typed ``int`` where the
    source takes a pointer, or one missing, would pass a truncated address
    or stream to the host entry point on the card."""
    src = os.path.join(os.path.dirname(fa.__file__), os.pardir, "csrc",
                       "flash_attention.cu")
    with open(src) as f:
        decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                f.read()))
    assert sorted(decls) == sorted(fa._POINTERS)
    types = {"int": ctypes.c_int, "float": ctypes.c_float}
    for name, params in decls.items():
        want = [ctypes.c_void_p if "*" in p else types[p.split()[0]]
                for p in params.split(",")]
        assert fa._argtypes(name) == want, name


def _length_segments(s):
    """Packed, packed with padding inside and at the end, and all-padding
    rows; with the lengths the kernels take for them."""
    seg = np.ones((3, s), np.int32)
    seg[:2, s // 2:] = 2
    seg[1, 3:6] = 0
    seg[1, s - 9:] = 0
    seg[2] = 0
    return seg, [s, s - 9, 0]


@pytest.mark.parametrize("causal", [True, False], ids=["square", "rect"])
def test_attention_call_carries_lengths_to_its_backward(monkeypatch,
                                                        causal):
    """One attention call computes ``q_len``/``k_len`` once, whatever the
    device, and its backward passes the same lengths to both backward
    kernels: the tokens through each row's last non-padding one, which
    bound the kernels' loops."""
    seen = []
    for name in ("_bwd_dq", "_bwd_dkv"):
        def spy(*args, _real=getattr(fa, name)):
            seen.append(args[8])  # lens, after the 8 tensors
            return _real(*args)
        monkeypatch.setattr(fa, name, spy)
    s_k = S if causal else S // 2
    seg, want_q = _length_segments(S)
    kv_seg, want_k = _length_segments(s_k)
    rng = np.random.RandomState(7)
    q, k, v = (torch.tensor(rng.randn(3, n, H, D).astype(np.float32),
                            requires_grad=True)
               for n in (S, s_k, s_k))
    out, lse = fa.flash_attention_with_lse(
        q, k, v, segment_ids=torch.tensor(seg),
        kv_segment_ids=None if causal else torch.tensor(kv_seg),
        causal=causal)
    (out.sum() + lse.sum()).backward()
    assert len(seen) == 2
    for q_len, k_len in seen:
        assert q_len.dtype == k_len.dtype == torch.int32
        assert q_len.tolist() == want_q and k_len.tolist() == want_k
        assert torch.equal(q_len, fa._valid_len(torch.tensor(seg)))
        assert torch.equal(k_len, fa._valid_len(torch.tensor(kv_seg)))
    assert seen[0][0] is seen[1][0] and seen[0][1] is seen[1][1]
