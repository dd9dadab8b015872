"""Table <-> TFRecord conversion with schema inference (the port's copy of
the JAX package's ``data/dfutil.py``).

The analog of the reference's ``dfutil.py`` (PySpark) and ``DFUtil.scala``
(JVM): rows here are plain dicts (columnar numpy is accepted on save), and
record IO is the native codec in :mod:`.tfrecord`
instead of the tensorflow-hadoop JVM input/output formats.

Semantics mirrored from the reference:

* dtype mapping (reference ``dfutil.py:84-131``): float/double ->
  FloatList, bool/int/long -> Int64List, string -> utf-8 BytesList,
  binary -> BytesList, arrays elementwise.
* schema inference from the *first* record (``dfutil.py:67-71``,
  ``DFUtil.scala:67-110``): BYTES -> string unless named in
  ``binary_features``, INT64 -> int64, FLOAT -> float32; a list becomes an
  array type only when the first record holds >1 value — the documented
  lossy inference the reference tests assert (``DFUtilTest.scala:110-131``).
* loaded-table origin tracking (``dfutil.py:15``, ``loadedDF``): a table
  loaded from TFRecords remembers its source dir so the Estimator can skip
  a re-export (``pipeline.py:384-397``).
"""

import logging
import os

import numpy as np

from tensorflowonspark_tpu_torch import fs as fs_lib
from tensorflowonspark_tpu_torch.data import example as example_lib
from tensorflowonspark_tpu_torch.data import tfrecord

logger = logging.getLogger(__name__)

FLOAT = "float"
INT64 = "int64"
STRING = "string"
BINARY = "binary"
ARRAY_FLOAT = "array<float>"
ARRAY_INT64 = "array<int64>"

_SCALARS = (FLOAT, INT64, STRING, BINARY)


class Table(list):
    """Rows (list of dicts) + schema + origin dir (the ``loadedDF`` analog)."""

    def __init__(self, rows=(), schema=None, origin=None):
        super().__init__(rows)
        self.schema = dict(schema or {})
        self.origin = origin
        # Row count at load time: origin reuse must not survive mutation
        # (the reference invalidates its loadedDF tracking when the
        # DataFrame is transformed/reassigned, test_dfutil.py:59-72) —
        # otherwise the Estimator would reuse stale TFRecords.
        self._origin_len = len(self) if origin else None

    def columns(self):
        """Columnar view: ``{name: np.ndarray}`` (object dtype for strings)."""
        out = {}
        for name, dtype in self.schema.items():
            vals = [row[name] for row in self]
            if dtype == FLOAT:
                out[name] = np.asarray(vals, np.float32)
            elif dtype == INT64:
                out[name] = np.asarray(vals, np.int64)
            elif dtype in (ARRAY_FLOAT, ARRAY_INT64):
                want = np.float32 if dtype == ARRAY_FLOAT else np.int64
                try:
                    out[name] = np.asarray(vals, want)
                except ValueError:
                    # Ragged rows (variable-length repeated features) cannot
                    # stack densely; keep per-row arrays under object dtype.
                    out[name] = np.asarray(
                        [np.asarray(v, want) for v in vals], object
                    )
            else:
                out[name] = np.asarray(vals, object)
        return out


def infer_schema_from_row(row):
    """Schema from a Python row dict (write-side; reference ``DataFrame.dtypes``)."""
    schema = {}
    for name, v in row.items():
        if isinstance(v, (list, tuple, np.ndarray)):
            first = v[0] if len(v) else 0.0
            if isinstance(first, (bool, int, np.integer)):
                schema[name] = ARRAY_INT64
            elif isinstance(first, (float, np.floating)):
                schema[name] = ARRAY_FLOAT
            else:
                raise TypeError(
                    "unsupported array element for column {!r}: {!r} "
                    "(only numeric arrays map to TFRecord lists)"
                    .format(name, type(first))
                )
        elif isinstance(v, (bool, int, np.integer)):
            schema[name] = INT64
        elif isinstance(v, (float, np.floating)):
            schema[name] = FLOAT
        elif isinstance(v, str):
            schema[name] = STRING
        elif isinstance(v, (bytes, bytearray)):
            schema[name] = BINARY
        else:
            raise TypeError(
                "unsupported value for column {!r}: {!r}".format(name, type(v))
            )
    return schema


def infer_schema(ex, binary_features=()):
    """Schema from a decoded Example (read-side; reference ``dfutil.py:134-168``).

    Lossy by design, like the reference: kind + value-count of the first
    record decide the column type.
    """
    schema = {}
    for name, (kind, values) in ex.items():
        if kind == example_lib.BYTES:
            base = BINARY if name in binary_features else STRING
        elif kind == example_lib.FLOAT:
            base = FLOAT
        else:
            base = INT64
        if len(values) > 1:
            if base in (STRING, BINARY):
                raise ValueError(
                    "multi-value bytes feature {!r} is unsupported "
                    "(matches reference schema inference)".format(name)
                )
            schema[name] = ARRAY_FLOAT if base == FLOAT else ARRAY_INT64
        else:
            schema[name] = base
    return schema


def row_to_example(row, schema):
    """Encode one row dict to Example wire bytes per ``schema``."""
    features = {}
    for name, dtype in schema.items():
        v = row[name]
        if dtype == FLOAT:
            features[name] = (example_lib.FLOAT, [float(v)])
        elif dtype == INT64:
            features[name] = (example_lib.INT64, [int(v)])
        elif dtype == STRING:
            features[name] = (example_lib.BYTES, [str(v).encode("utf-8")])
        elif dtype == BINARY:
            features[name] = (example_lib.BYTES, [bytes(v)])
        elif dtype == ARRAY_FLOAT:
            features[name] = (example_lib.FLOAT, [float(x) for x in v])
        elif dtype == ARRAY_INT64:
            features[name] = (example_lib.INT64, [int(x) for x in v])
        else:
            raise TypeError("unsupported dtype {!r}".format(dtype))
    return example_lib.encode_example(features)


def example_to_row(ex, schema):
    """Decode an Example into a row dict per ``schema`` (missing -> None)."""
    row = {}
    for name, dtype in schema.items():
        if name not in ex:
            row[name] = None
            continue
        _, values = ex[name]
        if not values and dtype in _SCALARS:
            # A zero-value repeated feature under a scalar-inferred schema
            # (the first record had one value, this one has none).
            row[name] = None
            continue
        if dtype == FLOAT:
            row[name] = float(values[0])
        elif dtype == INT64:
            row[name] = int(values[0])
        elif dtype == STRING:
            row[name] = values[0].decode("utf-8")
        elif dtype == BINARY:
            row[name] = bytes(values[0])
        elif dtype == ARRAY_FLOAT:
            row[name] = [float(x) for x in values]
        elif dtype == ARRAY_INT64:
            row[name] = [int(x) for x in values]
        else:
            raise TypeError("unsupported dtype {!r}".format(dtype))
    return row


def save_as_tfrecords(rows, output_dir, schema=None, num_shards=1,
                      prefix="part"):
    """Write rows as sharded TFRecord files (reference ``saveAsTFRecords``,
    ``dfutil.py:29-41``). Returns the written file paths."""
    rows = list(rows)
    if schema is None:
        if not rows:
            raise ValueError("cannot infer schema from zero rows")
        schema = infer_schema_from_row(rows[0])
    fs_lib.makedirs(output_dir)
    # Overwrite semantics: stale shards from a previous save (possibly with
    # more shards or a different prefix) must not survive to be read back
    # alongside the new data — load_tfrecords reads the whole dir.
    for old in fs_lib.glob(fs_lib.join(output_dir, "*-r-*")):
        fs_lib.remove(old)
    num_shards = max(1, min(num_shards, len(rows) or 1))
    writers = [
        tfrecord.RecordWriter(
            fs_lib.join(output_dir, "{}-r-{:05d}".format(prefix, i))
        )
        for i in range(num_shards)
    ]
    try:
        for i, row in enumerate(rows):
            writers[i % num_shards].write(row_to_example(row, schema))
    finally:
        for w in writers:
            w.close()
    logger.info("wrote %d row(s) to %d shard(s) in %s",
                len(rows), num_shards, output_dir)
    return fs_lib.glob(fs_lib.join(output_dir, prefix + "-r-*"))


def tfrecord_files(input_dir):
    """The record files of a dataset dir (any non-hidden regular file)."""
    if fs_lib.isfile(input_dir):
        return [input_dir]
    if fs_lib.is_local(input_dir):
        return [
            p for p in fs_lib.glob(fs_lib.join(input_dir, "*"))
            if fs_lib.isfile(p)
            and not os.path.basename(p).startswith((".", "_"))
        ]
    # One listing call with types, not a per-entry isfile round-trip — a
    # sharded dataset on an object store would otherwise pay hundreds of
    # sequential metadata requests before reading any data.
    fs, path = fs_lib.get_fs(input_dir)
    names = [
        e["name"] for e in fs.ls(path, detail=True)
        if e.get("type") == "file"
        and not e["name"].rsplit("/", 1)[-1].startswith((".", "_"))
    ]
    return sorted(fs_lib._requalify(input_dir, names))


def load_tfrecords(input_dir, schema_hint=None, binary_features=()):
    """Load a TFRecord dir into a :class:`Table` (reference
    ``loadTFRecords``, ``dfutil.py:44-81``): schema inferred from the first
    record, ``schema_hint`` entries override inference, ``binary_features``
    disambiguates string vs binary columns."""
    files = tfrecord_files(input_dir)
    if not files:
        raise FileNotFoundError("no TFRecord files under {}".format(input_dir))

    schema = None
    rows = []
    for path in files:
        for record in tfrecord.read_records(path):
            ex = example_lib.decode_example(record)
            if schema is None:
                schema = infer_schema(ex, binary_features)
                if schema_hint:
                    schema.update(schema_hint)
            rows.append(example_to_row(ex, schema))
    origin = (
        os.path.abspath(input_dir) if fs_lib.is_local(input_dir) else input_dir
    )
    table = Table(rows, schema=schema, origin=origin)
    logger.info("loaded %d row(s) from %s (schema: %s)",
                len(rows), input_dir, schema)
    return table


def parse_schema_hint(text):
    """Parse a ``struct<name:type,...>`` schema-hint string into a schema
    dict — the analog of the reference's parser-combinator
    ``SimpleTypeParser`` (``SimpleTypeParser.scala:34-64``): base types plus
    1-D arrays. Accepted type names follow the reference's SQL vocabulary
    (float/double, int/long/bigint, string, binary, array<T>)."""
    text = text.strip()
    if not (text.startswith("struct<") and text.endswith(">")):
        raise ValueError(
            "schema hint must look like struct<name:type,...>: {!r}".format(text)
        )
    body = text[len("struct<"):-1]
    # Accepts both the reference's SQL vocabulary and this package's own
    # canonical names, so a logged schema pastes back in as a hint.
    base = {"float": FLOAT, "double": FLOAT, "int": INT64, "long": INT64,
            "bigint": INT64, "int64": INT64, "string": STRING,
            "binary": BINARY,
            # The reference's full scalar vocabulary (SimpleTypeParser
            # handles boolean/byte/short too, TFModelTest's 14-type matrix);
            # all integer-like SQL types ride the int64 wire kind.
            "boolean": INT64, "bool": INT64, "byte": INT64,
            "tinyint": INT64, "short": INT64, "smallint": INT64}
    schema = {}
    # Split on commas not inside array<...> brackets.
    depth, start, parts = 0, 0, []
    for i, ch in enumerate(body):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(body[start:i])
            start = i + 1
    if body[start:].strip():
        parts.append(body[start:])
    for part in parts:
        name, _, typ = part.partition(":")
        name, typ = name.strip(), typ.strip().lower()
        if not name or not typ:
            raise ValueError("bad schema-hint field: {!r}".format(part))
        if typ.startswith("array<") and typ.endswith(">"):
            elem = typ[len("array<"):-1].strip()
            if base.get(elem) == FLOAT:
                schema[name] = ARRAY_FLOAT
            elif base.get(elem) == INT64:
                schema[name] = ARRAY_INT64
            else:
                raise ValueError(
                    "unsupported array element type {!r} (only numeric "
                    "arrays, matching the reference parser)".format(elem)
                )
        elif typ in base:
            schema[name] = base[typ]
        else:
            raise ValueError("unknown type {!r} in schema hint".format(typ))
    return schema


def is_loaded_table(table, input_dir=None):
    """Whether ``table`` came from :func:`load_tfrecords` unmodified
    (optionally from a specific dir) — the reference's ``loadedDF``
    identity check (``dfutil.py:15``, ``pipeline.py:385-388``). A table
    whose row count changed since load no longer matches its origin (the
    mutation-invalidates semantics of ``test_dfutil.py:59-72``; in-place
    edits of individual rows are not detectable, as with the reference's
    identity check on a mutated-in-place object)."""
    origin = getattr(table, "origin", None)
    if origin is None:
        return False
    origin_len = getattr(table, "_origin_len", None)
    if origin_len is not None and origin_len != len(table):
        return False
    return input_dir is None or origin == os.path.abspath(input_dir)
