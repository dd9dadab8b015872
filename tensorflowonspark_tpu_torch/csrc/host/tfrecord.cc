// TFRecord framing codec (C++ tier of the framework).
//
// The reference's record IO ran on the JVM via the tensorflow-hadoop
// connector (reference dfutil.py:39,63; DFUtil.scala:38,192 — Java
// TFRecordFileInput/OutputFormat). This is the native equivalent: the
// TFRecord wire format is
//
//   uint64 length (little-endian)
//   uint32 masked_crc32c(length)
//   byte   data[length]
//   uint32 masked_crc32c(data)
//
// with CRC-32C (Castagnoli) and the mask ((crc >> 15 | crc << 17) +
// 0xa282ead8). Exposed as a C ABI consumed from Python via ctypes
// (tensorflowonspark_tpu_torch/data/tfrecord.py).
//
// Build: tensorflowonspark_tpu_torch/data/_native.py, with the host
// compiler, into build/torch_native/<hash>/libtfrecord.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// CRC-32C, slicing-by-8. Tables are built eagerly at load time (static
// initializer) — ctypes calls run without the GIL, so lazy init would be a
// data race across Python threads.
uint32_t kTable[8][256];

bool init_tables() {
  const uint32_t poly = 0x82f63b78u;  // reflected Castagnoli
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    kTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int k = 1; k < 8; ++k)
      kTable[k][i] = (kTable[k - 1][i] >> 8) ^ kTable[0][kTable[k - 1][i] & 0xff];
  return true;
}

const bool kInit = init_tables();

uint32_t crc32c(const uint8_t* data, uint64_t len) {
  uint32_t crc = 0xffffffffu;
  while (len >= 8) {
    uint64_t word;
    memcpy(&word, data, 8);
    word ^= crc;  // little-endian host assumed (x86/arm64)
    crc = kTable[7][word & 0xff] ^ kTable[6][(word >> 8) & 0xff] ^
          kTable[5][(word >> 16) & 0xff] ^ kTable[4][(word >> 24) & 0xff] ^
          kTable[3][(word >> 32) & 0xff] ^ kTable[2][(word >> 40) & 0xff] ^
          kTable[1][(word >> 48) & 0xff] ^ kTable[0][(word >> 56) & 0xff];
    data += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ kTable[0][(crc ^ *data++) & 0xff];
  return crc ^ 0xffffffffu;
}

uint32_t masked_crc(const uint8_t* data, uint64_t len) {
  uint32_t crc = crc32c(data, len);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

struct Writer {
  FILE* f;
};

struct Reader {
  FILE* f;
};

}  // namespace

extern "C" {

uint32_t tfr_crc32c(const uint8_t* data, uint64_t len) {
  return crc32c(data, len);
}

uint32_t tfr_masked_crc32c(const uint8_t* data, uint64_t len) {
  return masked_crc(data, len);
}

void* tfr_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer{f};
  return w;
}

// Returns 0 on success, -1 on IO error.
int tfr_writer_write(void* handle, const uint8_t* data, uint64_t len) {
  Writer* w = static_cast<Writer*>(handle);
  uint8_t header[12];
  memcpy(header, &len, 8);  // little-endian host
  uint32_t len_crc = masked_crc(header, 8);
  memcpy(header + 8, &len_crc, 4);
  if (fwrite(header, 1, 12, w->f) != 12) return -1;
  if (len && fwrite(data, 1, len, w->f) != len) return -1;
  uint32_t data_crc = masked_crc(data, len);
  if (fwrite(&data_crc, 1, 4, w->f) != 4) return -1;
  return 0;
}

int tfr_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  int rc = fclose(w->f);
  delete w;
  return rc;
}

void* tfr_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  return new Reader{f};
}

// Reads the next record into a malloc'd buffer (*out, caller frees with
// tfr_free). Returns record length >= 0, -1 on clean EOF, -2 on
// corruption/truncation.
int64_t tfr_reader_next(void* handle, uint8_t** out) {
  Reader* r = static_cast<Reader*>(handle);
  uint8_t header[12];
  size_t n = fread(header, 1, 12, r->f);
  if (n == 0) return -1;  // clean EOF
  if (n != 12) return -2;
  uint64_t len;
  memcpy(&len, header, 8);
  uint32_t len_crc;
  memcpy(&len_crc, header + 8, 4);
  if (masked_crc(header, 8) != len_crc) return -2;
  if (len > (1ull << 40)) return -2;  // sanity cap: 1 TiB record
  uint8_t* buf = static_cast<uint8_t*>(malloc(len ? len : 1));
  if (!buf) return -2;
  if (len && fread(buf, 1, len, r->f) != len) {
    free(buf);
    return -2;
  }
  uint32_t data_crc;
  if (fread(&data_crc, 1, 4, r->f) != 4 || masked_crc(buf, len) != data_crc) {
    free(buf);
    return -2;
  }
  *out = buf;
  return static_cast<int64_t>(len);
}

void tfr_free(uint8_t* p) { free(p); }

int tfr_reader_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  int rc = fclose(r->f);
  delete r;
  return rc;
}

}  // extern "C"
