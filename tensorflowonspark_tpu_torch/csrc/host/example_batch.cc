// Columnar batch decoder for tf.train.Example records (host code of the
// port's data tier, built with the host compiler by data/_native.py).
//
// The native data plane of the inference/input tier: the role the
// reference filled with JVM row<->tensor conversion (batch2tensors /
// tensors2batch, TFModel.scala:51-239) and the tensorflow-hadoop record
// formats. Here the hot path is Example wire bytes -> dense columnar
// buffers ready for device transfer: no per-row host objects at all.
//
// Wire schema handled (see tensorflowonspark_tpu_torch/data/example.py):
//   Example  { Features features = 1; }
//   Features { map<string, Feature> feature = 1; }
//   Feature  { oneof { BytesList=1; FloatList=2; Int64List=3; } }
//   *List    { repeated value = 1; } (packed and unpacked accepted)
//
// C ABI (ctypes-consumed):
//   exb_extract_numeric  — fill a dense [nrecs, len] float32/int64 buffer
//   exb_extract_bytes_sizes / exb_extract_bytes — two-pass string/binary
//     extraction (sizes first, then concatenated payload + offsets)
//
// Return codes: >=0 rows filled; -1 malformed record; -2 value-count
// mismatch (record has more values than `len`); missing features
// zero-fill (numeric) or empty (bytes) and do not error, matching the
// Python-side None semantics for absent features.

#include <cstdint>
#include <cstring>

namespace {

struct Span {
  const uint8_t* p;
  uint64_t n;
};

// Parses a varint at *pos; returns false on truncation.
bool read_varint(const uint8_t* d, uint64_t end, uint64_t* pos, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < end) {
    uint8_t b = d[(*pos)++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// Advances past a field of the given wire type; false on malformed input.
bool skip_field(const uint8_t* d, uint64_t end, uint64_t* pos, int wt) {
  uint64_t v;
  switch (wt) {
    case 0:
      return read_varint(d, end, pos, &v);
    case 1:
      if (*pos + 8 > end) return false;
      *pos += 8;
      return true;
    case 2:
      if (!read_varint(d, end, pos, &v) || v > end - *pos) return false;
      *pos += v;
      return true;
    case 5:
      if (*pos + 4 > end) return false;
      *pos += 4;
      return true;
    default:
      return false;
  }
}

// Finds a length-delimited subfield by number inside [p, p+n).
// Returns 1 found, 0 absent, -1 malformed.
int find_len_field(const uint8_t* p, uint64_t n, uint64_t field, Span* out) {
  uint64_t pos = 0;
  while (pos < n) {
    uint64_t key;
    if (!read_varint(p, n, &pos, &key)) return -1;
    uint64_t f = key >> 3;
    int wt = static_cast<int>(key & 7);
    if (wt == 2) {
      uint64_t len;
      if (!read_varint(p, n, &pos, &len) || len > n - pos) return -1;
      if (f == field) {
        out->p = p + pos;
        out->n = len;
        return 1;
      }
      pos += len;
    } else {
      if (!skip_field(p, n, &pos, wt)) return -1;
    }
  }
  return 0;
}

// Locates the Feature message for `name` inside one Example record.
// Returns: 1 found, 0 not present, -1 malformed.
int find_feature(const uint8_t* rec, uint64_t n, const char* name,
                 uint64_t name_len, Span* feature) {
  Span features;
  int st = find_len_field(rec, n, 1, &features);
  if (st < 0) return -1;
  if (st == 0) return 0;  // record has no Features message
  // Iterate map entries (field 1 of Features).
  uint64_t pos = 0;
  const uint8_t* p = features.p;
  uint64_t end = features.n;
  while (pos < end) {
    uint64_t key;
    if (!read_varint(p, end, &pos, &key)) return -1;
    uint64_t f = key >> 3;
    int wt = static_cast<int>(key & 7);
    if (wt != 2) {
      if (!skip_field(p, end, &pos, wt)) return -1;
      continue;
    }
    uint64_t len;
    if (!read_varint(p, end, &pos, &len) || len > end - pos) return -1;
    if (f == 1) {
      const uint8_t* entry = p + pos;
      Span key_span, val_span;
      int kst = find_len_field(entry, len, 1, &key_span);
      if (kst < 0) return -1;
      if (kst == 1 && key_span.n == name_len &&
          std::memcmp(key_span.p, name, name_len) == 0) {
        if (find_len_field(entry, len, 2, &val_span) != 1) return -1;
        *feature = val_span;
        return 1;
      }
    }
    pos += len;
  }
  return 0;
}

// Kind constants shared with the Python wrapper.
constexpr int KIND_FLOAT = 0;
constexpr int KIND_INT64 = 1;
constexpr int KIND_BYTES = 2;

// Decodes the value list of a Feature for numeric kinds into out[0..len),
// zero-padding short lists. Returns count (>=0) or -1 malformed / -2 too
// many values.
int64_t decode_numeric(const Span& feature, int kind, int64_t len,
                       void* out_row) {
  uint64_t list_field = (kind == KIND_FLOAT) ? 2 : 3;
  Span list;
  if (find_len_field(feature.p, feature.n, list_field, &list) != 1) {
    return -1;  // feature present but of a different kind (or malformed)
  }
  int64_t count = 0;
  uint64_t pos = 0;
  const uint8_t* p = list.p;
  uint64_t end = list.n;
  float* fout = static_cast<float*>(out_row);
  int64_t* iout = static_cast<int64_t*>(out_row);
  while (pos < end) {
    uint64_t key;
    if (!read_varint(p, end, &pos, &key)) return -1;
    uint64_t f = key >> 3;
    int wt = static_cast<int>(key & 7);
    if (f != 1) {
      if (!skip_field(p, end, &pos, wt)) return -1;
      continue;
    }
    if (kind == KIND_FLOAT) {
      if (wt == 2) {  // packed
        uint64_t blen;
        if (!read_varint(p, end, &pos, &blen) || blen > end - pos ||
            blen % 4 != 0)
          return -1;
        uint64_t nvals = blen / 4;
        if (count + static_cast<int64_t>(nvals) > len) return -2;
        std::memcpy(fout + count, p + pos, blen);
        count += static_cast<int64_t>(nvals);
        pos += blen;
      } else if (wt == 5) {
        if (pos + 4 > end) return -1;
        if (count + 1 > len) return -2;
        std::memcpy(fout + count, p + pos, 4);
        count += 1;
        pos += 4;
      } else {
        if (!skip_field(p, end, &pos, wt)) return -1;
      }
    } else {  // INT64
      if (wt == 2) {  // packed varints
        uint64_t blen;
        if (!read_varint(p, end, &pos, &blen) || blen > end - pos) return -1;
        uint64_t vend = pos + blen;
        while (pos < vend) {
          uint64_t v;
          if (!read_varint(p, vend, &pos, &v)) return -1;
          if (count + 1 > len) return -2;
          iout[count++] = static_cast<int64_t>(v);
        }
      } else if (wt == 0) {
        uint64_t v;
        if (!read_varint(p, end, &pos, &v)) return -1;
        if (count + 1 > len) return -2;
        iout[count++] = static_cast<int64_t>(v);
      } else {
        if (!skip_field(p, end, &pos, wt)) return -1;
      }
    }
  }
  return count;
}

// Returns the first bytes value of a BytesList feature, or {nullptr,0} if
// none; malformed -> sets *err.
Span first_bytes(const Span& feature, bool* err) {
  Span list;
  *err = false;
  if (find_len_field(feature.p, feature.n, 1, &list) != 1) {
    *err = true;  // present but not a BytesList (or malformed)
    return {nullptr, 0};
  }
  Span value;
  int st = find_len_field(list.p, list.n, 1, &value);
  if (st < 0) {
    *err = true;
    return {nullptr, 0};
  }
  if (st == 0) return {nullptr, 0};  // empty BytesList
  return value;
}

}  // namespace

extern "C" {

// data: concatenated records; offsets[i]..offsets[i+1]: record i
// (offsets has nrecs+1 entries). out: nrecs*len elements of float32
// (kind 0) or int64 (kind 1), pre-zeroed by the caller or not (we zero
// pad explicitly). Missing features leave the row zeroed.
int64_t exb_extract_numeric(const uint8_t* data, const uint64_t* offsets,
                            uint64_t nrecs, const char* name, int kind,
                            int64_t len, void* out) {
  uint64_t name_len = std::strlen(name);
  uint64_t elem = (kind == KIND_FLOAT) ? 4 : 8;
  for (uint64_t i = 0; i < nrecs; ++i) {
    const uint8_t* rec = data + offsets[i];
    uint64_t n = offsets[i + 1] - offsets[i];
    void* row = static_cast<uint8_t*>(out) + i * len * elem;
    std::memset(row, 0, len * elem);
    Span feature;
    int found = find_feature(rec, n, name, name_len, &feature);
    if (found < 0) return -1;
    if (found == 0) continue;
    int64_t c = decode_numeric(feature, kind, len, row);
    if (c < 0) return c;
  }
  return static_cast<int64_t>(nrecs);
}

// Pass 1: per-record byte sizes of the first value of a BytesList feature
// (0 when absent). Returns total size or -1 on malformed input.
int64_t exb_extract_bytes_sizes(const uint8_t* data, const uint64_t* offsets,
                                uint64_t nrecs, const char* name,
                                uint64_t* sizes) {
  uint64_t name_len = std::strlen(name);
  int64_t total = 0;
  for (uint64_t i = 0; i < nrecs; ++i) {
    const uint8_t* rec = data + offsets[i];
    uint64_t n = offsets[i + 1] - offsets[i];
    sizes[i] = 0;
    Span feature;
    int found = find_feature(rec, n, name, name_len, &feature);
    if (found < 0) return -1;
    if (found == 0) continue;
    bool err;
    Span v = first_bytes(feature, &err);
    if (err) return -1;
    sizes[i] = v.n;
    total += static_cast<int64_t>(v.n);
  }
  return total;
}

// Pass 2: concatenate the values into out (caller sized it from pass 1);
// out_offsets gets nrecs+1 entries. Returns nrecs or -1.
int64_t exb_extract_bytes(const uint8_t* data, const uint64_t* offsets,
                          uint64_t nrecs, const char* name, uint8_t* out,
                          uint64_t* out_offsets) {
  uint64_t name_len = std::strlen(name);
  uint64_t w = 0;
  out_offsets[0] = 0;
  for (uint64_t i = 0; i < nrecs; ++i) {
    const uint8_t* rec = data + offsets[i];
    uint64_t n = offsets[i + 1] - offsets[i];
    Span feature;
    int found = find_feature(rec, n, name, name_len, &feature);
    if (found < 0) return -1;
    if (found == 1) {
      bool err;
      Span v = first_bytes(feature, &err);
      if (err) return -1;
      if (v.n) {
        std::memcpy(out + w, v.p, v.n);
        w += v.n;
      }
    }
    out_offsets[i + 1] = w;
  }
  return static_cast<int64_t>(nrecs);
}

}  // extern "C"
