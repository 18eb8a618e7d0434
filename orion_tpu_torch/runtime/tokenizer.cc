// Native byte-level tokenizer hot path.
//
// The byte-level scheme (ids 0..255 = raw bytes) makes encode a typed copy;
// the native win is doing it without the GIL for large corpora, plus a
// bulk file->token-bin converter that streams without Python overhead.

#include <cstdint>
#include <cstdio>
#include <vector>

extern "C" {

// text[len] -> out[len] int32 ids. Returns count written.
int64_t orion_byte_encode(const uint8_t* text, int64_t len, int32_t* out) {
  for (int64_t i = 0; i < len; ++i) out[i] = static_cast<int32_t>(text[i]);
  return len;
}

// ids[len] -> out[len] bytes; ids outside [0, 255] are skipped.
// Returns count written.
int64_t orion_byte_decode(const int32_t* ids, int64_t len, uint8_t* out) {
  int64_t w = 0;
  for (int64_t i = 0; i < len; ++i) {
    if (ids[i] >= 0 && ids[i] < 256) out[w++] = static_cast<uint8_t>(ids[i]);
  }
  return w;
}

// Stream a raw text/bytes file into a uint16 token-bin file.
// Returns token count, or -1 on IO failure.
int64_t orion_byte_encode_file(const char* in_path, const char* out_path) {
  FILE* in = fopen(in_path, "rb");
  if (!in) return -1;
  FILE* out = fopen(out_path, "wb");
  if (!out) {
    fclose(in);
    return -1;
  }
  std::vector<uint8_t> buf(1 << 20);
  std::vector<uint16_t> tok(1 << 20);
  int64_t total = 0;
  size_t n;
  while ((n = fread(buf.data(), 1, buf.size(), in)) > 0) {
    for (size_t i = 0; i < n; ++i) tok[i] = buf[i];
    if (fwrite(tok.data(), sizeof(uint16_t), n, out) != n) {
      total = -1;
      break;
    }
    total += static_cast<int64_t>(n);
  }
  fclose(in);
  fclose(out);
  return total;
}

}  // extern "C"
