"""The port's mesh (``parallel/mesh.py``) and parameter layout
(``parallel/sharding.py``) held against the JAX package's, in one process.

Sizes, the wildcard and its errors as the JAX ``MeshConfig``; rank ``r``
at the coordinate of JAX device ``r`` in ``MeshConfig(...).build(
jax.devices()[:4])``; spec resolution equal to ``_resolve_spec`` on
``DEFAULT_RULES``; each rank's parameter shard and batch rows equal to
what JAX places on device ``r``, the pipelined LM's stage parameters
under ``pipe`` beside ``tensor`` and ``fsdp`` included; the compositions
of ``pipe`` and ``expert`` not yet held against JAX raise, naming their
ROADMAP items.
Rank coordinates need no process group: a ``ProcessMesh`` built for rank
``r`` in one process has no groups but the same geometry.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from tensorflowonspark_tpu.models import factory as jax_factory
from tensorflowonspark_tpu.ops import attention as jax_attention
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.ops import attention
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.parallel import MeshConfig
from tensorflowonspark_tpu_torch.models import factory

pytestmark = pytest.mark.watchdog_timeout(120)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The tier-1 run shares the machine's cores among its workers.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

MESHES = {
    "data2_fsdp2": dict(data=2, fsdp=2),
    "data2_tensor2": dict(data=2, tensor=2),
    "seq4": dict(data=1, seq=4),
    "fsdp2_tensor2": dict(data=1, fsdp=2, tensor=2),
}
LM_KW = dict(vocab_size=64, num_layers=1, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=40, remat=False)


def _meshes(kw):
    """The JAX mesh over 4 devices and the port's mesh of each rank."""
    jm = jax_mesh.MeshConfig(**kw).build(jax.devices()[:4])
    sizes = MeshConfig(**kw).sizes(4)
    return jm, [mesh_lib.ProcessMesh(sizes, r) for r in range(4)]


def test_mesh_config_sizes_wildcard_and_errors():
    for kw, n in ((dict(data=-1, tensor=2), 8), (dict(data=2, fsdp=-1), 4),
                  (dict(data=1, seq=-1), 4)):
        assert MeshConfig(**kw).sizes(n) == jax_mesh.MeshConfig(**kw).sizes(n)
    with pytest.raises(ValueError):
        MeshConfig(data=3).sizes(8)
    with pytest.raises(ValueError, match="at most one"):
        MeshConfig(data=-1, fsdp=-1).sizes(4)
    with pytest.raises(ValueError, match="needs 2 devices"):
        MeshConfig(data=2).build()
    with pytest.raises(ValueError, match="pass no device list"):
        MeshConfig().build(devices=[0])


@pytest.mark.parametrize("axis,item", [("pipe", "A10"), ("expert", "A11")])
def test_pipe_and_expert_raise_naming_their_items(axis, item):
    """``expert`` composes with ``data`` and ``pipe`` only: beside fsdp,
    seq or tensor it raises naming A11c. ``pipe`` composes with ``data``
    and one of fsdp, seq, tensor and expert (those pairs only need their
    ranks, as any axis does); beside two of them it raises naming A10d,
    which the pair checks alone would let through."""
    for other in ("fsdp", "seq", "tensor"):
        kw = dict(data=1, **{axis: 2, other: 2})
        if axis == "expert":
            with pytest.raises(NotImplementedError, match="ROADMAP A11c"):
                MeshConfig(**kw).build()
        else:
            with pytest.raises(ValueError, match="needs 4 devices"):
                MeshConfig(**kw).build()
            for data in (2, -1):
                with pytest.raises(ValueError, match="devices"):
                    MeshConfig(**dict(kw, data=data)).build()
            with pytest.raises(NotImplementedError, match="ROADMAP A10d"):
                MeshConfig(**dict(kw, expert=2)).build()
    with pytest.raises(ValueError, match="needs 4 devices"):
        MeshConfig(data=1, pipe=2, expert=2).build()
    with pytest.raises(ValueError, match="needs 2 devices"):
        MeshConfig(data=1, **{axis: 2}).build()
    assert MeshConfig(data=1, **{axis: -1}).build().shape[axis] == 1


@pytest.mark.parametrize("axes", [("fsdp", "tensor"), ("seq", "tensor"),
                                  ("fsdp", "seq"), ("tensor", "expert"),
                                  ("fsdp", "seq", "tensor")])
def test_pipe_beside_two_model_axes_raises_naming_a10d(axes):
    kw = dict(data=1, pipe=2, **{a: 2 for a in axes})
    with pytest.raises(NotImplementedError, match="ROADMAP A10d") as err:
        MeshConfig(**kw).build()
    for a in axes:
        assert "{}=2".format(a) in str(err.value)
    # The sizes a wildcard resolves to are checked too.
    with pytest.raises(NotImplementedError, match="ROADMAP A10d"):
        mesh_lib._check_compositions(MeshConfig(**dict(
            kw, data=-1)).sizes(2 ** (len(axes) + 1)))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rank_coordinates_are_jax_device_coordinates(name):
    jm, ranks = _meshes(MESHES[name])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r, mesh in enumerate(ranks):
        assert mesh.shape == dict(jm.shape)
        where = tuple(int(i[0]) for i in np.nonzero(ids == r))
        assert tuple(mesh.coords[a] for a in mesh_lib.AXES) == where
        # Ranks of an axis group differ in that axis's coordinate only.
        for axis in ("data", "fsdp", "seq", "tensor"):
            members = mesh.ranks_with((axis,))
            assert r in members and len(members) == jm.shape[axis]


def test_rules_and_spec_resolution_match_jax():
    assert mesh_lib.DEFAULT_RULES == jax_mesh.DEFAULT_RULES
    logical = [("batch", "sequence", None), ("embed", None, "heads",
                                             "head_dim"),
               ("heads", "embed"), ("embed", "mlp"), ("vocab", None),
               (None, "embed"), ("kv", "qkv", "layers", "stage")]
    for kw in MESHES.values():
        jm, _ = _meshes(kw)
        for axes in logical:
            want = tuple(jax_mesh._resolve_spec(dict(jm.shape), axes,
                                                jax_mesh.DEFAULT_RULES))
            want += (None,) * (len(axes) - len(want))
            assert mesh_lib.resolve_spec(dict(jm.shape), axes) == want
    custom = {"batch": "data", "embed": None}
    with mesh_lib.use_rules(custom):
        assert mesh_lib.active_rules() is custom
    assert mesh_lib.active_rules() is mesh_lib.DEFAULT_RULES
    x = torch.zeros(2, 3, 4)
    assert mesh_lib.constrain(x, ("batch", "sequence", None)) is x
    with pytest.raises(ValueError):
        mesh_lib.constrain(x, ("batch",))


@pytest.mark.parametrize("name", ["fsdp2_tensor2", "data2_tensor2",
                                  "data2_fsdp2"])
def test_parameter_shards_are_the_jax_device_shards(name):
    """Every parameter of a toy LM laid out as JAX lays it on each device;
    an uneven vocabulary (67 rows over 4 shards) in XLA's chunks of
    ``ceil(67 / 4)`` rows, the last one zero-padded."""
    jm, ranks = _meshes(MESHES[name])
    model = factory.get_model("transformer", device="cpu",
                              dtype=torch.float32, **LM_KW)
    axes = model.param_axes()
    full = {k: v.detach() for k, v in model.state_dict().items()}
    layouts = [sharding.ModelSharding(model, mesh) for mesh in ranks]
    for pname, tensor in full.items():
        spec = jax_mesh.logical_sharding(
            jm, axes.get(pname, (None,) * tensor.dim())).spec
        arr = jax.device_put(jnp.asarray(tensor.numpy()),
                             NamedSharding(jm, spec))
        for r, lay in enumerate(layouts):
            (shard,) = [s for s in arr.addressable_shards
                        if s.device.id == r]
            want = np.asarray(shard.data)
            got = lay.local(pname, tensor).numpy()
            index = tuple(slice(0, n) for n in want.shape)
            np.testing.assert_array_equal(got[index], want)
            rest = got.copy()
            rest[index] = 0
            assert not rest.any()
    uneven = factory.get_model("transformer", device="cpu",
                               dtype=torch.float32,
                               **dict(LM_KW, vocab_size=67))
    table = uneven.embed.embedding.detach()
    for r, mesh in enumerate(ranks):
        lay = sharding.ModelSharding(uneven, mesh)
        i = mesh.index(lay.layouts["embed.embedding"].spec[0])
        k = mesh.axis_size(*lay.layouts["embed.embedding"].spec[0])
        chunk = -(-67 // k)
        got = lay.local("embed.embedding", table)
        rows = table[i * chunk:(i + 1) * chunk]
        assert got.shape[0] == chunk
        assert torch.equal(got[:len(rows)], rows)
        assert not got[len(rows):].any()


@pytest.mark.parametrize("name", sorted(MESHES))
def test_batch_rows_and_chunks_are_the_jax_placement(name):
    jm, ranks = _meshes(MESHES[name])
    b, s = 8, 16
    x = np.arange(b * s, dtype=np.int32).reshape(b, s)
    spec = jax_mesh.logical_sharding(jm, ("batch", "sequence")).spec
    arr = jax.device_put(x, NamedSharding(jm, spec))
    for r, mesh in enumerate(ranks):
        placer = mesh_lib.BatchPlacer(mesh, device="cpu")
        (shard,) = [sh for sh in arr.addressable_shards if sh.device.id == r]
        np.testing.assert_array_equal(placer.local({"x": x})["x"],
                                      np.asarray(shard.data))
        rows = x[placer.rows(b)]
        placed = placer({"x": rows})
        assert isinstance(placed, mesh_lib.PlacedBatch)
        assert placer(placed) is placed
        np.testing.assert_array_equal(placed["x"].numpy(),
                                      np.asarray(shard.data))


def test_zigzag_layout_round_trip_matches_jax():
    x = np.random.RandomState(0).randn(2, 32, 3).astype(np.float32)
    for n in (1, 2, 4):
        want = np.asarray(jax_attention.zigzag_layout(jnp.asarray(x), n))
        got = attention.zigzag_layout(torch.tensor(x), n)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(attention.zigzag_layout(x, n), want)
        np.testing.assert_array_equal(
            attention.zigzag_restore(got, n).numpy(), x)
    with pytest.raises(ValueError, match="divisible by 2 x num_devices"):
        attention.zigzag_layout(torch.tensor(x), 3)
    assert attention._zigzag_order(4) == jax_attention._zigzag_order(4)


def test_single_process_sequence_routes_fall_back_to_dense():
    """No seq group: ring, ulysses and ring_flash are dense attention (the
    JAX dispatcher's degenerate fallback), zigzag included."""
    rs = np.random.RandomState(1)
    q, k, v = (torch.tensor(rs.randn(2, 16, 4, 8).astype(np.float32))
               for _ in range(3))
    want = attention.dense_causal_attention(q, k, v)
    assert attention.seq_axis_size() == 1
    for impl, layout in (("ring", "contiguous"), ("ulysses", "contiguous"),
                         ("ring_flash", "contiguous"),
                         ("ring_flash", "zigzag")):
        got = attention.causal_attention(q, k, v, impl=impl,
                                         ring_layout=layout)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="ring_flash schedule"):
        attention.causal_attention(q, k, v, impl="ring", ring_layout="zigzag")
    model = factory.get_model("transformer", device="cpu",
                              dtype=torch.float32, attention_impl="ring",
                              ring_layout="zigzag", **LM_KW)
    with pytest.raises(ValueError, match="ring_flash schedule"):
        model(torch.ones((1, 8), dtype=torch.long))


def test_params_for_mesh_are_the_jax_shards_of_the_flax_params():
    """``convert.params_for_mesh``: a flax init converted full, then each
    rank's shard, equal to what the JAX trainer's state sharding places on
    device ``r`` (the converted layout: kernels keep flax's)."""
    jm, ranks = _meshes(MESHES["fsdp2_tensor2"])
    flax_model = jax_factory.get_model("transformer", dtype=jnp.float32,
                                       **LM_KW)
    variables = flax_model.init(jax.random.PRNGKey(3),
                                jnp.zeros((1, 8), jnp.int32))
    params = jax.device_get(nn.meta.unbox(variables["params"]))
    specs = nn.get_partition_spec(variables["params"])
    model = factory.get_model("transformer", device="cpu",
                              dtype=torch.float32, **LM_KW)
    flat_specs = convert._flat(specs)
    full = convert.params_from_flax(params, model.cfg)
    for r, mesh in enumerate(ranks):
        local = convert.params_for_mesh(params, model, mesh)
        for path, spec in flat_specs.items():
            name = path.replace("/", ".")
            sharding = jax_mesh.logical_sharding(jm, tuple(spec))
            arr = jax.device_put(full[name].numpy(), sharding)
            (shard,) = [s for s in arr.addressable_shards
                        if s.device.id == r]
            np.testing.assert_array_equal(local[name].numpy(),
                                          np.asarray(shard.data))


PIPE_MESHES = {"pipe2_tensor2": dict(data=1, pipe=2, tensor=2),
               "fsdp2_pipe2": dict(data=1, fsdp=2, pipe=2)}


@pytest.mark.parametrize("name", sorted(PIPE_MESHES))
def test_pipelined_stage_shards_are_the_jax_device_shards(name):
    """The pipelined LM's parameters under ``pipe`` beside ``tensor`` or
    ``fsdp``: each stage parameter sharded on two dimensions at once. The
    JAX layout ``(v, n, g, l, ...)`` (logical ``round, stage, chunk,
    layers``) merges to the port's ``(v, n*g, l, ...)``; every rank's
    shard is device ``r``'s, and the shards rebuild the full tensors."""
    jm, ranks = _meshes(PIPE_MESHES[name])
    model = factory.get_model("pipelined_transformer", device="cpu",
                              dtype=torch.float32, num_stages=2,
                              num_microbatches=2,
                              **dict(LM_KW, num_layers=4))
    axes = model.param_axes()
    layouts = [sharding.ModelSharding(model, mesh) for mesh in ranks]
    for pname, tensor in model.state_dict().items():
        logical = axes.get(pname, (None,) * tensor.dim())
        full = tensor.numpy()
        if logical[:3] == ("round", "stage", "layers"):
            n = jm.shape["pipe"]
            full = full.reshape((full.shape[0], n, full.shape[1] // n)
                                + full.shape[2:])
            logical = ("round", "stage", "chunk") + logical[2:]
        spec = jax_mesh.logical_sharding(jm, logical).spec
        arr = jax.device_put(jnp.asarray(full), NamedSharding(jm, spec))
        shards = []
        for r, lay in enumerate(layouts):
            (shard,) = [s for s in arr.addressable_shards
                        if s.device.id == r]
            got = lay.local(pname, tensor)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(shard.data).reshape(got.shape))
            shards.append(got)
        # ModelSharding.full's placement, rank by rank, without a group.
        lay = layouts[0].layouts[pname]
        out = torch.zeros(lay.shape)
        for r, got in enumerate(shards):
            index = tuple(
                slice(ranks[0].index(a, r) * c, (ranks[0].index(a, r) + 1)
                      * c) if a else slice(None)
                for a, c in zip(lay.spec, lay.chunk))
            out[index] = got
        assert torch.equal(out, tensor), pname
