"""Sequence-parallel attention of the port held against the JAX package's.

One group of four gloo ranks (``torch_shard_programs.ring_attention_cases``,
run once per session) computes each case: every rank takes its chunk of
the same numpy-seeded ``q``/``k``/``v``, segment ids and cotangent, runs
``ops.attention.causal_attention`` over the mesh's seq group, and
back-propagates ``sum(out * cotangent)``. The JAX side runs the same
function (``ring_causal_attention``, ``ulysses_causal_attention``,
``ring_flash_attention`` contiguous and zigzag) under ``shard_map`` on four
CPU devices and differentiates it with ``jax.vjp``; ``ring_flash`` runs the
Pallas kernels in interpret mode there and the flash plain versions here.
The chunks put together must equal JAX's outputs and q/k/v gradients to
1e-5, the tolerance of ``tests/test_torch_flash_attention.py``.

Cases: ring with segments and GQA (4/2), Ulysses with segments and GQA
(8/4; each rank needs whole head groups), ring_flash with segments and GQA,
and ring_flash zigzag with segments (inputs laid out by ``zigzag_layout``
before they are cut; compared in that layout). Row 1's second document
crosses chunk boundaries; row 0 ends in padding. The dense and flash
routes with segments and GQA attend over the whole row from each rank's
chunk: their reference is the JAX function on the whole arrays, what XLA's
partitioner computes for them under a seq axis (the flash kernels in
interpret mode there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_shard_programs as progs
from tensorflowonspark_tpu.ops import attention as jax_attention
from tensorflowonspark_tpu.parallel import MeshConfig as JaxMeshConfig

pytestmark = pytest.mark.watchdog_timeout(120)

TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return progs.cached_group(tmp_path_factory, "ring_attention",
                              progs.ATTN_WORLD,
                              "ring_attention_cases")["ranks"]


def _zigzag(x, n):
    return np.asarray(jax_attention.zigzag_layout(jnp.asarray(x), n))


@pytest.fixture(scope="module", params=sorted(progs.ATTN_CASES))
def reference(request):
    """``(case, out, (dq, dk, dv))`` of the JAX function under
    ``shard_map``, made once a module for each case."""
    case = request.param
    c = progs.ATTN_CASES[case]
    q, k, v, seg, g = progs.attention_inputs(case, _zigzag)
    if c["impl"] in ("dense", "pallas"):
        @jax.jit
        def whole(q, k, v, seg, g):
            out, vjp = jax.vjp(lambda q, k, v: jax_attention.causal_attention(
                q, k, v, impl=c["impl"], segment_ids=seg), q, k, v)
            return out, vjp(g)

        out, grads = whole(q, k, v, seg, g)
        return case, np.asarray(out), [np.asarray(x) for x in grads]
    mesh = JaxMeshConfig(data=1, seq=progs.ATTN_WORLD).build(
        jax.devices()[:progs.ATTN_WORLD])
    kw = {}
    if c["impl"] == "ring":
        fn = jax_attention.ring_causal_attention
    elif c["impl"] == "ulysses":
        fn = jax_attention.ulysses_causal_attention
    else:
        layout = c.get("layout", "contiguous")

        def fn(q, k, v, axis_name, segment_ids):
            return jax_attention.ring_flash_attention(
                q, k, v, axis_name=axis_name, segment_ids=segment_ids,
                layout=layout)
        kw = {"check_vma": False}
    spec = P(None, "seq")
    mapped = shard_map(
        lambda q, k, v, s: fn(q, k, v, axis_name="seq", segment_ids=s),
        mesh=mesh, in_specs=(spec,) * 4, out_specs=spec, **kw)

    @jax.jit
    def run(q, k, v, seg, g):
        out, vjp = jax.vjp(lambda q, k, v: mapped(q, k, v, seg), q, k, v)
        return out, vjp(g)

    out, grads = run(q, k, v, seg, g)
    return case, np.asarray(out), [np.asarray(x) for x in grads]


def test_sequence_parallel_attention_matches_jax(ranks, reference):
    case, want_out, want_grads = reference
    got = progs.case_result(ranks, case)
    out = np.concatenate([r["out"] for r in got], axis=1)
    np.testing.assert_allclose(out, want_out, rtol=0, atol=TOL,
                               err_msg=case + " out")
    for name, want in zip(("dq", "dk", "dv"), want_grads):
        grad = np.concatenate([r[name] for r in got], axis=1)
        np.testing.assert_allclose(grad, want, rtol=0, atol=TOL,
                                   err_msg="{} {}".format(case, name))
    # Padding queries are exact zeros on every rank, as in JAX.
    seg = progs.attention_inputs(case, _zigzag)[3]
    assert not out[seg == 0].any()


def test_ulysses_divisibility_error_matches_jax(ranks):
    (msg,) = {r["message"] for r in progs.case_result(ranks,
                                                      "ulysses_error")}
    mesh = JaxMeshConfig(data=1, seq=progs.ATTN_WORLD).build(
        jax.devices()[:progs.ATTN_WORLD])
    mapped = shard_map(
        lambda q, k: jax_attention.ulysses_causal_attention(
            q, k, k, axis_name="seq"),
        mesh=mesh, in_specs=(P(),) * 2, out_specs=P())
    with pytest.raises(ValueError) as err:
        mapped(jnp.zeros((1, 4, 6, 8)), jnp.zeros((1, 4, 2, 8)))
    assert msg == str(err.value)


def test_ranks_load_no_jax(ranks):
    assert [r["_forbidden"] for r in ranks] == [[]] * progs.ATTN_WORLD
