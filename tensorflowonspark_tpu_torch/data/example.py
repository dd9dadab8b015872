"""``tf.train.Example`` protobuf wire codec — no TensorFlow dependency (the
port's copy of the JAX package's ``data/example.py``; the bytes are equal).

The reference serialized/parsed Examples with the protobuf-generated
classes (``dfutil.py:110-115``, Example construction; ``DFUtil.scala:119``)
— TensorFlow itself is not part of this framework, so the three-message
schema is codified by hand against the protobuf wire format:

    Example  { Features features = 1; }
    Features { map<string, Feature> feature = 1; }
    Feature  { oneof { BytesList bytes_list = 1;
                       FloatList float_list = 2;
                       Int64List int64_list = 3; } }
    BytesList { repeated bytes value = 1; }
    FloatList { repeated float value = 1 [packed]; }
    Int64List { repeated int64 value = 1 [packed]; }

Output is byte-compatible with TensorFlow's serialization (map entries
emitted in insertion order; both packed and unpacked repeated scalars are
accepted on parse).
"""

import struct

# Feature kinds.
BYTES = "bytes"
FLOAT = "float"
INT64 = "int64"


class Example(dict):
    """A parsed Example: ``{name: (kind, [values])}`` with kind one of
    ``bytes``/``float``/``int64``; bytes values are ``bytes``, float values
    Python floats (fp32 precision), int64 values Python ints."""


# -- varint / wire helpers ----------------------------------------------------

def _write_varint(buf, value):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data, pos):
    result = shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated protobuf: varint past end of buffer")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _zigzagless_int64(value):
    # int64 fields use two's-complement varints (10 bytes when negative).
    return value & 0xFFFFFFFFFFFFFFFF


def _tag(field, wire_type):
    return (field << 3) | wire_type


def _write_len_delimited(buf, field, payload):
    _write_varint(buf, _tag(field, 2))
    _write_varint(buf, len(payload))
    buf.extend(payload)


# -- encode -------------------------------------------------------------------

def _encode_feature(kind, values):
    inner = bytearray()
    if kind == BYTES:
        for v in values:
            _write_len_delimited(inner, 1, bytes(v))
    elif kind == FLOAT:
        payload = struct.pack("<{}f".format(len(values)), *values)
        _write_len_delimited(inner, 1, payload)
    elif kind == INT64:
        payload = bytearray()
        for v in values:
            _write_varint(payload, _zigzagless_int64(int(v)))
        _write_len_delimited(inner, 1, payload)
    else:
        raise ValueError("unknown feature kind: {!r}".format(kind))

    feature = bytearray()
    field = {BYTES: 1, FLOAT: 2, INT64: 3}[kind]
    _write_len_delimited(feature, field, inner)
    return feature


def encode_example(features):
    """Serialize ``{name: (kind, [values])}`` to Example wire bytes."""
    fmap = bytearray()
    for name, (kind, values) in features.items():
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))
        _write_len_delimited(entry, 2, _encode_feature(kind, values))
        _write_len_delimited(fmap, 1, entry)
    out = bytearray()
    _write_len_delimited(out, 1, fmap)
    return bytes(out)


# -- decode -------------------------------------------------------------------

def _skip_field(data, pos, wire_type):
    if wire_type == 0:
        _, pos = _read_varint(data, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError("unsupported wire type {}".format(wire_type))
    return pos


def _fields(data):
    """Yield (field_number, wire_type, value_or_span) over a message."""
    pos = 0
    end = len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        field, wire_type = key >> 3, key & 7
        if wire_type == 0:
            value, pos = _read_varint(data, pos)
            yield field, wire_type, value
        elif wire_type == 2:
            n, pos = _read_varint(data, pos)
            if pos + n > end:
                raise ValueError(
                    "truncated protobuf: length-delimited field of {} bytes "
                    "exceeds buffer".format(n)
                )
            yield field, wire_type, data[pos:pos + n]
            pos += n
        elif wire_type == 5:
            if pos + 4 > end:
                raise ValueError("truncated protobuf: fixed32 past end")
            yield field, wire_type, data[pos:pos + 4]
            pos += 4
        elif wire_type == 1:
            if pos + 8 > end:
                raise ValueError("truncated protobuf: fixed64 past end")
            yield field, wire_type, data[pos:pos + 8]
            pos += 8
        else:
            pos = _skip_field(data, pos, wire_type)


def _to_signed64(value):
    return value - (1 << 64) if value >= (1 << 63) else value


def _decode_feature(data):
    for field, wt, value in _fields(data):
        if field == 1 and wt == 2:  # BytesList
            vals = [bytes(v) for f, w, v in _fields(value) if f == 1 and w == 2]
            return BYTES, vals
        if field == 2 and wt == 2:  # FloatList
            vals = []
            for f, w, v in _fields(value):
                if f != 1:
                    continue
                if w == 2:  # packed
                    vals.extend(struct.unpack("<{}f".format(len(v) // 4), v))
                elif w == 5:  # unpacked fixed32
                    vals.append(struct.unpack("<f", v)[0])
            return FLOAT, vals
        if field == 3 and wt == 2:  # Int64List
            vals = []
            for f, w, v in _fields(value):
                if f != 1:
                    continue
                if w == 2:  # packed
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        vals.append(_to_signed64(x))
                elif w == 0:  # unpacked varint
                    vals.append(_to_signed64(v))
            return INT64, vals
    return None, []


def decode_example(data):
    """Parse Example wire bytes into ``Example({name: (kind, [values])})``."""
    out = Example()
    for field, wt, features_bytes in _fields(data):
        if field != 1 or wt != 2:
            continue
        for f, w, entry in _fields(features_bytes):
            if f != 1 or w != 2:
                continue
            name, feature = None, None
            for ef, ew, ev in _fields(entry):
                if ef == 1 and ew == 2:
                    name = ev.decode("utf-8")
                elif ef == 2 and ew == 2:
                    feature = ev
            if name is not None and feature is not None:
                kind, values = _decode_feature(feature)
                if kind is not None:
                    out[name] = (kind, values)
    return out
