// Native synthetic-corpus generator.
//
// The environment has no network egress, so a pretraining-scale corpus
// (100M+ tokens — ~30x the worked example) must be synthesized locally.
// This samples an interpolated trigram/bigram/unigram Markov source fitted
// on an existing token-bin corpus: locally realistic token statistics, an
// entropy floor set by the interpolation weights (so held-out perplexity
// falls smoothly for an entire endurance run instead of bottoming out on a
// memorized 3.7M-token loop), and no possibility of verbatim memorization
// at the corpus level because the sampled stream never repeats.
//
// Determinism contract (mirrored bit-for-bit by the Python twin,
// training/corpusgen.py): draw k of a run is
// splitmix64(seed + k) — the same finalizer the data loader uses — and
// each output token consumes exactly two draws (branch pick, successor
// pick). Successor lists are ordered by corpus position (stable counting
// sort here, stable argsort in Python), so `list[r % len]` agrees.
//
// Built with g++ by runtime/__init__.py (plain C ABI, ctypes).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr uint64_t kGamma = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kM2 = 0x94D049BB133111EBull;

inline uint64_t splitmix64(uint64_t x) {
  uint64_t z = x + kGamma;
  z = (z ^ (z >> 30)) * kM1;
  z = (z ^ (z >> 27)) * kM2;
  return z ^ (z >> 31);
}

// draw in [0, 1): top 53 bits, exactly what numpy's (r >> 11) * 2**-53 does
inline double unit(uint64_t r) {
  return static_cast<double>(r >> 11) * (1.0 / 9007199254740992.0);
}

struct Model {
  const uint16_t* corpus = nullptr;
  int64_t n = 0;
  // bigram CSR: dense offsets over the 2^16 token space
  std::vector<int64_t> bi_off;      // [65537]
  std::vector<uint16_t> bi_succ;    // [n-1], corpus-position order
  // trigram CSR: sorted unique (a<<16|b) codes + offsets + successors
  std::vector<uint32_t> tri_code;   // [n_ctx]
  std::vector<int64_t> tri_off;     // [n_ctx+1]
  std::vector<uint16_t> tri_succ;   // [n-2], corpus-position order
};

}  // namespace

extern "C" {

// Fit the interpolated Markov model on corpus[0..n). Returns a handle.
void* orion_corpusgen_fit(const uint16_t* corpus, int64_t n) {
  if (n < 3) return nullptr;
  auto* m = new Model;
  m->corpus = corpus;
  m->n = n;

  // bigram: counting sort by context token (stable: ascending i)
  std::vector<int64_t> cnt(65536 + 1, 0);
  for (int64_t i = 0; i + 1 < n; ++i) cnt[corpus[i]]++;
  m->bi_off.assign(65537, 0);
  for (int t = 0; t < 65536; ++t) m->bi_off[t + 1] = m->bi_off[t] + cnt[t];
  m->bi_succ.resize(n - 1);
  {
    std::vector<int64_t> cur(m->bi_off.begin(), m->bi_off.end() - 1);
    for (int64_t i = 0; i + 1 < n; ++i)
      m->bi_succ[cur[corpus[i]]++] = corpus[i + 1];
  }

  // trigram: stable sort of (code, i), then unique codes + CSR
  std::vector<std::pair<uint32_t, int64_t>> entries;
  entries.reserve(n - 2);
  for (int64_t i = 0; i + 2 < n; ++i) {
    uint32_t code = (static_cast<uint32_t>(corpus[i]) << 16) | corpus[i + 1];
    entries.emplace_back(code, i);
  }
  std::stable_sort(entries.begin(), entries.end(),
                   [](const auto& x, const auto& y) {
                     return x.first < y.first;
                   });
  m->tri_succ.resize(entries.size());
  for (size_t j = 0; j < entries.size(); ++j) {
    m->tri_succ[j] = corpus[entries[j].second + 2];
    if (j == 0 || entries[j].first != entries[j - 1].first) {
      m->tri_code.push_back(entries[j].first);
      m->tri_off.push_back(static_cast<int64_t>(j));
    }
  }
  m->tri_off.push_back(static_cast<int64_t>(entries.size()));
  return m;
}

// Sample n_out tokens into out. Each token: draw r0 picks the branch
// (unigram if u < p_uni, else bigram if u < p_uni + p_bi, else trigram,
// falling back tri->bi->uni when a context is unseen), draw r1 picks the
// successor by index. State seeds from draw pair k=0 (start bigram).
void orion_corpusgen_sample(void* handle, uint64_t seed, double p_uni,
                            double p_bi, int64_t n_out, uint16_t* out) {
  auto* m = static_cast<Model*>(handle);
  // Decorrelate the draw stream's ORIGIN from the user seed: with a raw
  // counter stream splitmix64(seed + k), seeds i and i+2 yield the same
  // draws shifted by one token pair — adjacent-seeded "shards" coalesce
  // into verbatim copies within ~100 tokens. One
  // finalizer pass scatters origins uniformly over 2^64, making stream
  // overlap a ~2n/2^64 probability event instead of a certainty.
  seed = splitmix64(seed);
  uint64_t k = 0;
  uint64_t r = splitmix64(seed + k++);
  int64_t s = static_cast<int64_t>(r % static_cast<uint64_t>(m->n - 1));
  uint16_t a = m->corpus[s], b = m->corpus[s + 1];
  (void)splitmix64(seed + k++);  // keep pairs aligned (draw 1 unused)

  for (int64_t j = 0; j < n_out; ++j) {
    double u = unit(splitmix64(seed + k++));
    uint64_t r1 = splitmix64(seed + k++);
    int order = u < p_uni ? 1 : (u < p_uni + p_bi ? 2 : 3);
    uint16_t nxt;
    if (order == 3) {
      uint32_t code = (static_cast<uint32_t>(a) << 16) | b;
      auto it = std::lower_bound(m->tri_code.begin(), m->tri_code.end(), code);
      if (it != m->tri_code.end() && *it == code) {
        size_t idx = it - m->tri_code.begin();
        int64_t lo = m->tri_off[idx], hi = m->tri_off[idx + 1];
        nxt = m->tri_succ[lo + static_cast<int64_t>(
                                   r1 % static_cast<uint64_t>(hi - lo))];
      } else {
        order = 2;  // unseen trigram context (possible after a jump)
      }
    }
    if (order == 2) {
      int64_t lo = m->bi_off[b], hi = m->bi_off[b + 1];
      if (hi > lo) {
        nxt = m->bi_succ[lo + static_cast<int64_t>(
                                  r1 % static_cast<uint64_t>(hi - lo))];
      } else {
        order = 1;  // token only ever appeared corpus-final
      }
    }
    if (order == 1) {
      nxt = m->corpus[r1 % static_cast<uint64_t>(m->n)];
    }
    out[j] = nxt;
    a = b;
    b = nxt;
  }
}

void orion_corpusgen_destroy(void* handle) {
  delete static_cast<Model*>(handle);
}

}  // extern "C"
