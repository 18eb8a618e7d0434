// Native byte-level BPE encoder. The encode hot path of
// utils/bpe.py::BPETokenizer, bit-identical by contract
// (tests/test_torch_runtime.py compares outputs token-for-token): same pretokenizer semantics as the
// Python regex  \s?[A-Za-z]+ | \s?[0-9]+ | \s?[^\sA-Za-z0-9]+ | \s+
// (ASCII classes; multibyte UTF-8 lands in the "other" class), same greedy
// lowest-rank merge loop, same word cache. Python trains and serializes the
// merges (training is offline, once); this file only encodes — the part
// that runs over every corpus byte.
//
// Plain C ABI, loaded via ctypes (runtime/__init__.py). No dependencies.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

inline bool is_ws(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}
inline bool is_letter(uint8_t c) {
  return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z');
}
inline bool is_digit(uint8_t c) { return c >= '0' && c <= '9'; }
// "other": not whitespace, not ASCII alphanumeric (multibyte UTF-8 included)
inline bool is_other(uint8_t c) {
  return !is_ws(c) && !is_letter(c) && !is_digit(c);
}

struct BPE {
  // (a << 32 | b) -> merged id (rank order == id order, ids from 256)
  std::unordered_map<uint64_t, int32_t> ranks;  // immutable after create
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::mutex cache_mu;  // ctypes drops the GIL during encode — concurrent
                        // encode() on one tokenizer must not race the cache

  void merge_word(const uint8_t* w, size_t n, std::vector<int32_t>& out) {
    std::string key(reinterpret_cast<const char*>(w), n);
    {
      std::lock_guard<std::mutex> lk(cache_mu);
      auto it = cache.find(key);
      if (it != cache.end()) {
        out.insert(out.end(), it->second.begin(), it->second.end());
        return;
      }
    }
    std::vector<int32_t> parts(n);
    for (size_t i = 0; i < n; i++) parts[i] = w[i];
    while (parts.size() > 1) {
      int32_t best_rank = INT32_MAX;
      size_t best_i = SIZE_MAX;
      for (size_t i = 0; i + 1 < parts.size(); i++) {
        uint64_t k = (uint64_t(uint32_t(parts[i])) << 32) |
                     uint32_t(parts[i + 1]);
        auto r = ranks.find(k);
        if (r != ranks.end() && r->second < best_rank) {
          best_rank = r->second;
          best_i = i;
        }
      }
      if (best_i == SIZE_MAX) break;
      parts[best_i] = best_rank;  // rank IS the merged token id
      parts.erase(parts.begin() + best_i + 1);
    }
    {
      std::lock_guard<std::mutex> lk(cache_mu);
      if (cache.size() < (1u << 20)) cache.emplace(std::move(key), parts);
    }
    out.insert(out.end(), parts.begin(), parts.end());
  }
};

}  // namespace

extern "C" {

void* orion_bpe_create(const int32_t* merges, int64_t n_merges) {
  BPE* h = new BPE();
  h->ranks.reserve(size_t(n_merges) * 2);
  for (int64_t i = 0; i < n_merges; i++) {
    uint64_t k = (uint64_t(uint32_t(merges[2 * i])) << 32) |
                 uint32_t(merges[2 * i + 1]);
    h->ranks.emplace(k, int32_t(256 + i));
  }
  return h;
}

void orion_bpe_destroy(void* handle) { delete static_cast<BPE*>(handle); }

// Encode UTF-8 bytes -> token ids. out must hold >= len entries (merges
// only ever shrink the byte-level tokenization). Returns the token count.
int64_t orion_bpe_encode(void* handle, const uint8_t* s, int64_t len,
                         int32_t* out) {
  BPE* h = static_cast<BPE*>(handle);
  std::vector<int32_t> toks;
  toks.reserve(size_t(len) / 3 + 8);
  int64_t i = 0;
  while (i < len) {
    int64_t start = i;
    uint8_t c = s[i];
    if (is_ws(c)) {
      // \s?X+ alternatives fire only when the ws is followed by that class;
      // otherwise the whole whitespace run is one \s+ token
      if (i + 1 < len && is_letter(s[i + 1])) {
        i += 2;
        while (i < len && is_letter(s[i])) i++;
      } else if (i + 1 < len && is_digit(s[i + 1])) {
        i += 2;
        while (i < len && is_digit(s[i])) i++;
      } else if (i + 1 < len && is_other(s[i + 1])) {
        i += 2;
        while (i < len && is_other(s[i])) i++;
      } else {
        while (i < len && is_ws(s[i])) i++;
      }
    } else if (is_letter(c)) {
      while (i < len && is_letter(s[i])) i++;
    } else if (is_digit(c)) {
      while (i < len && is_digit(s[i])) i++;
    } else {
      while (i < len && is_other(s[i])) i++;
    }
    h->merge_word(s + start, size_t(i - start), toks);
  }
  std::memcpy(out, toks.data(), toks.size() * sizeof(int32_t));
  return int64_t(toks.size());
}

}  // extern "C"
