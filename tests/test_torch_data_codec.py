"""The port's record codecs against the JAX package's.

The same seeded records and rows go through both packages: TFRecord files
are byte-identical on the native and the Python paths (each package's file
read back by the other's reader), CRC-32C agrees, ``tf.train.Example``
bytes are equal and decode alike, ``decode_batch`` columns are equal on
both paths with the error cases raising the same ``ValueError``, and
``dfutil``'s files, loaded tables, inferred schemas and parsed schema hints
are equal. The native libraries build from ``csrc/host/`` into
``build/torch_native/``, never into the JAX loader's ``cpp/build/``.
Remote schemes run through ``fsspec``'s ``memory://`` where it imports.
"""

import os

import numpy as np
import pytest

from tensorflowonspark_tpu import fs as jax_fs
from tensorflowonspark_tpu.data import batch_decode as jax_bd
from tensorflowonspark_tpu.data import dfutil as jax_dfutil
from tensorflowonspark_tpu.data import example as jax_example
from tensorflowonspark_tpu.data import tfrecord as jax_tfrecord
from tensorflowonspark_tpu_torch import fs as port_fs
from tensorflowonspark_tpu_torch.data import _native
from tensorflowonspark_tpu_torch.data import batch_decode as port_bd
from tensorflowonspark_tpu_torch.data import dfutil as port_dfutil
from tensorflowonspark_tpu_torch.data import example as port_example
from tensorflowonspark_tpu_torch.data import tfrecord as port_tfrecord
from tensorflowonspark_tpu_torch.train import tbevents

pytestmark = pytest.mark.watchdog_timeout(120)

PATHS = {"native": True, "python": False}


def _records(n=40, seed=0):
    rng = np.random.RandomState(seed)
    out = [b"", b"\x00", bytes(range(256))]
    out += [rng.bytes(int(k)) for k in rng.randint(0, 3000, size=n)]
    return out


def _features(seed):
    rng = np.random.RandomState(seed)
    return {
        "image/encoded": ("bytes", [rng.bytes(int(rng.randint(1, 64)))]),
        "label": ("int64", [int(rng.randint(-5, 1000))]),
        "neg": ("int64", [-1, -(1 << 63), (1 << 63) - 1, 0]),
        "v": ("float", [float(x) for x in rng.randn(5).astype(np.float32)]),
        "empty_f": ("float", []),
        "empty_i": ("int64", []),
        "names": ("bytes", [b"a", "ü".encode("utf-8"), b""]),
        "ünï": ("float", [1.5]),
    }


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_native_libraries_build_under_build_torch_native():
    assert _native.loaded() == {"libexample_batch.so": True,
                                "libtfrecord.so": True}
    out = _native.build_dir()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(_native.__file__))))
    assert out.startswith(os.path.join(root, "build", "torch_native") + os.sep)
    assert "cpp" not in os.path.relpath(out, root).split(os.sep)
    assert {"libexample_batch.so", "libtfrecord.so"} <= set(os.listdir(out))


@pytest.mark.parametrize("native", sorted(PATHS))
def test_tfrecord_files_byte_identical(tmp_path, native):
    recs = _records()
    use = PATHS[native]
    jax_path, port_path = str(tmp_path / "jax.tfr"), str(tmp_path / "port.tfr")
    assert jax_tfrecord.write_records(jax_path, recs, use_native=use) == \
        port_tfrecord.write_records(port_path, recs, use_native=use)
    assert _read(port_path) == _read(jax_path)
    for reader_native in (True, False):
        assert list(port_tfrecord.read_records(
            jax_path, use_native=reader_native)) == recs
        assert list(jax_tfrecord.read_records(
            port_path, use_native=reader_native)) == recs


@pytest.mark.parametrize("native", sorted(PATHS))
def test_crc32c_matches_jax(native):
    use = PATHS[native]
    for data in [b"", b"123456789"] + _records(8, seed=3):
        assert port_tfrecord.crc32c(data, use) == jax_tfrecord.crc32c(
            data, use)
        assert port_tfrecord.masked_crc32c(data, use) == \
            jax_tfrecord.masked_crc32c(data, use)
    assert port_tfrecord.crc32c(b"123456789", use) == 0xE3069283
    # tbevents frames its records with the data tier's CRC.
    assert tbevents.masked_crc32c is port_tfrecord.masked_crc32c


@pytest.mark.parametrize("native", sorted(PATHS))
@pytest.mark.parametrize("damage", ["data", "length", "truncate"])
def test_corrupt_files_raise_like_jax(tmp_path, native, damage):
    path = str(tmp_path / "r.tfr")
    port_tfrecord.write_records(path, _records(4, seed=1))
    raw = bytearray(_read(path))
    if damage == "data":
        raw[20] ^= 0xFF
    elif damage == "length":
        raw[0] ^= 0x01
    else:
        raw = raw[:-3]
    with open(path, "wb") as f:
        f.write(raw)
    use = PATHS[native]
    with pytest.raises(IOError) as jax_err:
        list(jax_tfrecord.read_records(path, use_native=use))
    with pytest.raises(IOError) as port_err:
        list(port_tfrecord.read_records(path, use_native=use))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("seed", range(4))
def test_example_bytes_equal(seed):
    feats = _features(seed)
    raw = port_example.encode_example(feats)
    assert raw == jax_example.encode_example(feats)
    assert port_example.decode_example(raw) == jax_example.decode_example(raw)


def test_example_unpacked_and_truncated_inputs_decode_alike():
    # Unpacked repeated scalars (int64 varints, fixed32 floats) are legal
    # protobuf; a truncated buffer raises the same ValueError.
    buf = bytearray()
    ints = bytearray()
    for v in (3, 300):
        port_example._write_varint(ints, (1 << 3) | 0)
        port_example._write_varint(ints, v)
    feature = bytearray()
    port_example._write_len_delimited(feature, 3, ints)
    entry = bytearray()
    port_example._write_len_delimited(entry, 1, b"k")
    port_example._write_len_delimited(entry, 2, feature)
    fmap = bytearray()
    port_example._write_len_delimited(fmap, 1, entry)
    port_example._write_len_delimited(buf, 1, fmap)
    raw = bytes(buf)
    assert port_example.decode_example(raw) == \
        jax_example.decode_example(raw) == {"k": ("int64", [3, 300])}
    bad = port_example.encode_example(_features(0))[:-7]
    with pytest.raises(ValueError) as jax_err:
        jax_example.decode_example(bad)
    with pytest.raises(ValueError) as port_err:
        port_example.decode_example(bad)
    assert str(port_err.value) == str(jax_err.value)


def _batch_records(n=13, seed=0):
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        feats = {"img": ("bytes", [rng.bytes(12)]),
                 "label": ("int64", [i - 3]),
                 "v": ("float", [float(x) for x in
                                 rng.randn(int(rng.randint(0, 4)))]),
                 "name": ("bytes", [("row%d" % i).encode()])}
        if i % 4 == 3:
            del feats["name"]  # absent: empty bytes / zero-filled
        recs.append(port_example.encode_example(feats))
    return recs


COLUMNS = {"img": ("uint8", 12), "label": ("int64", 1),
           "v": ("float", 3), "name": ("bytes", 1), "missing": ("int64", 2)}


@pytest.mark.parametrize("native", sorted(PATHS))
def test_decode_batch_columns_equal(native):
    recs = _batch_records()
    use = PATHS[native]
    got = port_bd.decode_batch(recs, COLUMNS, use_native=use)
    want = jax_bd.decode_batch(recs, COLUMNS, use_native=use)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        if want[name].dtype == object:
            assert list(got[name]) == list(want[name]), name
        else:
            np.testing.assert_array_equal(got[name], want[name], name)
    assert got["img"].flags["C_CONTIGUOUS"] and got["img"].shape == (13, 12)
    empty = port_bd.decode_batch([], COLUMNS, use_native=use)
    assert {k: v.shape for k, v in empty.items()} == {
        k: v.shape for k, v in jax_bd.decode_batch(
            [], COLUMNS, use_native=use).items()}


ERROR_CASES = {
    "too_many_values": {"v": ("float", 1)},
    "wrong_kind": {"label": ("float", 1)},
    "uint8_wrong_length": {"img": ("uint8", 11)},
    "uint8_absent": {"name": ("uint8", 4)},
}


@pytest.mark.parametrize("native", sorted(PATHS))
@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_decode_batch_errors_match_jax(native, case):
    recs = _batch_records()
    use = PATHS[native]
    with pytest.raises(ValueError) as jax_err:
        jax_bd.decode_batch(recs, ERROR_CASES[case], use_native=use)
    with pytest.raises(ValueError) as port_err:
        port_bd.decode_batch(recs, ERROR_CASES[case], use_native=use)
    assert str(port_err.value) == str(jax_err.value)


def test_read_columns_equal(tmp_path):
    recs = _batch_records(30)
    paths = []
    for i in range(3):
        p = str(tmp_path / "s{}".format(i))
        port_tfrecord.write_records(p, recs[i * 10:(i + 1) * 10])
        paths.append(p)
    for batch_size in (None, 7):
        got = list(port_bd.read_columns(paths, COLUMNS, batch_size))
        want = list(jax_bd.read_columns(paths, COLUMNS, batch_size))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for name in ("img", "label", "v", "missing"):
                np.testing.assert_array_equal(g[name], w[name])
            assert list(g["name"]) == list(w["name"])


def _rows(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return [{"f": float(np.float32(rng.randn())), "i": int(rng.randint(-9, 9)),
             "s": "row-{}-ü".format(k), "b": rng.bytes(5),
             "af": [float(x) for x in rng.randn(3).astype(np.float32)],
             "ai": [int(x) for x in rng.randint(0, 50, size=4)]}
            for k in range(n)]


def test_dfutil_files_tables_and_schemas_equal(tmp_path):
    rows = _rows()
    assert port_dfutil.infer_schema_from_row(rows[0]) == \
        jax_dfutil.infer_schema_from_row(rows[0])
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jfiles = jax_dfutil.save_as_tfrecords(rows, jdir, num_shards=4)
    pfiles = port_dfutil.save_as_tfrecords(rows, pdir, num_shards=4)
    assert [os.path.basename(p) for p in pfiles] == \
        [os.path.basename(p) for p in jfiles]
    for p, j in zip(pfiles, jfiles):
        assert _read(p) == _read(j)
    for kw in ({"binary_features": ("b",)},
               {"binary_features": ("b",),
                "schema_hint": {"i": port_dfutil.FLOAT}}):
        got = port_dfutil.load_tfrecords(pdir, **kw)
        want = jax_dfutil.load_tfrecords(jdir, **kw)
        assert got.schema == want.schema
        assert list(got) == list(want)
        assert port_dfutil.is_loaded_table(got, pdir)
        gc, wc = got.columns(), want.columns()
        for name in wc:
            if wc[name].dtype == object:
                assert list(gc[name]) == list(wc[name])
            else:
                np.testing.assert_array_equal(gc[name], wc[name])
    ex = port_example.decode_example(port_dfutil.row_to_example(
        rows[0], port_dfutil.infer_schema_from_row(rows[0])))
    assert port_dfutil.infer_schema(ex, ("b",)) == \
        jax_dfutil.infer_schema(ex, ("b",))
    table = port_dfutil.load_tfrecords(pdir, binary_features=("b",))
    table.append(dict(table[0]))
    assert not port_dfutil.is_loaded_table(table)


@pytest.mark.parametrize("hint", [
    "struct<a:float,b:double,c:array<long>,d:string,e:binary>",
    "struct< x : int ,y:array<double>, z:boolean, w:tinyint>",
    "struct<a:array<string>>", "struct<a:complex>", "a:int",
    "struct<a:>",
])
def test_parse_schema_hint_matches_jax(hint):
    try:
        want = jax_dfutil.parse_schema_hint(hint)
    except ValueError as e:
        with pytest.raises(ValueError) as port_err:
            port_dfutil.parse_schema_hint(hint)
        assert str(port_err.value) == str(e)
    else:
        assert port_dfutil.parse_schema_hint(hint) == want


def test_fs_local_staging_and_trees(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.bin").write_bytes(b"a")
    (src / "sub" / "b.bin").write_bytes(b"bb")
    dst = str(tmp_path / "dst")
    port_fs.put_tree(str(src), dst)
    assert port_fs.isfile(os.path.join(dst, "sub", "b.bin"))
    assert port_fs.isdir(os.path.join(dst, "sub"))
    assert not port_fs.isdir(os.path.join(dst, "a.bin"))
    port_fs.put_file(str(src / "a.bin"), str(tmp_path / "x" / "c.bin"))
    port_fs.get_file(str(tmp_path / "x" / "c.bin"), str(tmp_path / "d.bin"))
    assert (tmp_path / "d.bin").read_bytes() == b"a"
    with port_fs.stage_for_read("file://" + str(src / "a.bin")) as p:
        assert p == str(src / "a.bin")
    with port_fs.stage_for_write(str(tmp_path / "w" / "e.bin")) as p:
        with open(p, "wb") as f:
            f.write(b"e")
    assert (tmp_path / "w" / "e.bin").read_bytes() == b"e"
    staged = port_fs.make_staging_file("tfos-test-")
    try:
        assert os.path.getsize(staged) == 0
    finally:
        os.unlink(staged)


def test_remote_scheme_records_and_tables_match_jax():
    fsspec = pytest.importorskip("fsspec")
    mem = fsspec.filesystem("memory")
    base = "memory://torch-data-codec-{}".format(os.getpid())
    recs = _records(6, seed=2)
    try:
        for native in (True, False):
            port_tfrecord.write_records(base + "/p.tfr", recs, native)
            jax_tfrecord.write_records(base + "/j.tfr", recs, native)
            with port_fs.open(base + "/p.tfr") as f:
                pbytes = f.read()
            with jax_fs.open(base + "/j.tfr") as f:
                assert pbytes == f.read()
            assert list(port_tfrecord.read_records(base + "/j.tfr",
                                                   native)) == recs
        rows = _rows(9)
        port_dfutil.save_as_tfrecords(rows, base + "/t", num_shards=3)
        jax_dfutil.save_as_tfrecords(rows, base + "/u", num_shards=3)
        assert port_dfutil.tfrecord_files(base + "/t") == [
            p.replace("/u/", "/t/")
            for p in jax_dfutil.tfrecord_files(base + "/u")]
        assert list(port_dfutil.load_tfrecords(base + "/t", None, ("b",))) \
            == list(jax_dfutil.load_tfrecords(base + "/u", None, ("b",)))
        assert port_fs.isdir(base + "/t") and port_fs.isfile(base + "/p.tfr")
        with port_fs.stage_for_read(base + "/p.tfr") as p:
            assert _read(p) == pbytes
        with port_fs.stage_for_write(base + "/w.bin") as p:
            with open(p, "wb") as f:
                f.write(b"w")
        with port_fs.open(base + "/w.bin") as f:
            assert f.read() == b"w"
    finally:
        if mem.exists(base):
            mem.rm(base, recursive=True)
