"""The port's copy of ``orion_tpu/training/corpusgen.py`` (it imports no
jax): the same draws, so its shards are bitwise the JAX package's.

Synthetic pretraining corpus: interpolated trigram Markov source fitted
on a token-bin corpus, sampled at 100M+ token scale (the
3.7M-token worked example cycles ~34x in an endurance run, so the eval
curve measures memorization; a sampled stream never repeats, and its
entropy floor is set by the interpolation weights so held-out perplexity
falls for the whole run).

``python -m orion_tpu_torch.training.corpusgen`` writes sharded token bins:

    python -m orion_tpu_torch.training.corpusgen data/train.bin \\
        --out-dir data/big --shards 8 --tokens-per-shard 16000000

plus one held-out eval shard (seed offset by 10^6) — consumed as a
sharded dataset (training/data.py::ShardedTokenBinDataset, or just a
directory path to --data).

Determinism contract (bit-identical between the C++ fast path,
runtime/corpusgen.cc, and the pure-Python twin here — contract-tested):
draw k is splitmix64(splitmix64(seed) + k) (the outer mix decorrelates
nearby seeds — see _draws); each token consumes exactly two draws
(branch, successor); successor lists are in corpus-position order; the
branch pick compares (r >> 11) * 2**-53 against p_uni / p_uni + p_bi.

Why Markov, not templates: the ask is a corpus whose learning
trajectory is honest pretraining — locally realistic statistics with a
known entropy floor. An order-2 source with bigram/unigram interpolation
gives the 1.3B model millions of conditional distributions to estimate
(slow, smooth convergence) while staying cheap to sample at GB scale.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from orion_tpu_torch.training.data import _splitmix64  # canonical finalizer

_INV53 = 1.0 / 9007199254740992.0  # 2**-53


def _draws(seed: int, lo: int, n: int) -> np.ndarray:
    """splitmix64(splitmix64(seed) + k) for k in [lo, lo+n) — the shared
    draw stream. The outer finalizer decorrelates stream ORIGINS: raw
    counter streams from adjacent seeds are shifted copies of each other,
    which made adjacent-seeded shards coalesce into verbatim duplicates;
    after the mix, overlap is a ~2n/2^64 event."""
    with np.errstate(over="ignore"):
        base = _splitmix64(np.asarray(seed, dtype=np.uint64))
        return _splitmix64(base + np.arange(lo, lo + n, dtype=np.uint64))


class MarkovModel:
    """Pure-Python twin of runtime/corpusgen.cc (slow: ~µs/token — tests
    and fallback only; the native path samples ~10M tokens/s)."""

    def __init__(self, corpus: np.ndarray):
        corpus = np.ascontiguousarray(corpus, dtype=np.uint16)
        assert corpus.size >= 3, corpus.size
        self.corpus = corpus
        n = corpus.size
        # bigram CSR over the dense 2^16 context space, stable order
        ctx = corpus[: n - 1].astype(np.int64)
        order = np.argsort(ctx, kind="stable")
        self.bi_succ = corpus[1:][order]
        counts = np.bincount(ctx, minlength=65536)
        self.bi_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        # trigram CSR: sorted unique (a<<16)|b codes
        code = (
            corpus[: n - 2].astype(np.uint32) << np.uint32(16)
        ) | corpus[1 : n - 1].astype(np.uint32)
        t_order = np.argsort(code, kind="stable")
        self.tri_succ = corpus[2:][t_order]
        sorted_codes = code[t_order]
        uniq, first = np.unique(sorted_codes, return_index=True)
        self.tri_code = uniq
        self.tri_off = np.concatenate([first, [n - 2]]).astype(np.int64)

    def sample(self, seed: int, n_out: int, p_uni: float = 0.02,
               p_bi: float = 0.15) -> np.ndarray:
        corpus, n = self.corpus, self.corpus.size
        rs = _draws(seed, 0, 2 * n_out + 2)
        s = int(rs[0] % np.uint64(n - 1))
        a, b = int(corpus[s]), int(corpus[s + 1])  # rs[1] unused (pairing)
        out = np.empty(n_out, dtype=np.uint16)
        tri_code, tri_off, tri_succ = self.tri_code, self.tri_off, self.tri_succ
        bi_off, bi_succ = self.bi_off, self.bi_succ
        for j in range(n_out):
            u = float(rs[2 + 2 * j] >> np.uint64(11)) * _INV53
            r1 = int(rs[3 + 2 * j])
            order = 1 if u < p_uni else (2 if u < p_uni + p_bi else 3)
            nxt = -1
            if order == 3:
                code = (a << 16) | b
                idx = int(np.searchsorted(tri_code, code))
                if idx < tri_code.size and int(tri_code[idx]) == code:
                    lo, hi = int(tri_off[idx]), int(tri_off[idx + 1])
                    nxt = int(tri_succ[lo + r1 % (hi - lo)])
                else:
                    order = 2
            if order == 2:
                lo, hi = int(bi_off[b]), int(bi_off[b + 1])
                if hi > lo:
                    nxt = int(bi_succ[lo + r1 % (hi - lo)])
                else:
                    order = 1
            if order == 1:
                nxt = int(corpus[r1 % n])
            out[j] = nxt
            a, b = b, nxt
        return out


def sample_tokens(corpus: np.ndarray, seed: int, n_out: int,
                  p_uni: float = 0.02, p_bi: float = 0.15) -> np.ndarray:
    """Sample via the native generator when built, Python twin otherwise."""
    from orion_tpu_torch import runtime

    gen = runtime.NativeCorpusGen
    try:
        g = gen(corpus)
    except ImportError:
        return MarkovModel(corpus).sample(seed, n_out, p_uni, p_bi)
    try:
        return g.sample(seed, n_out, p_uni, p_bi)
    finally:
        g.close()


def _load_tokens(path: str) -> tuple[np.ndarray, int]:
    meta = path + ".meta.json"
    with open(meta) as f:
        md = json.load(f)
    dtype = np.dtype(md["dtype"])
    assert dtype == np.uint16, (
        f"{path}: corpusgen fits uint16 token bins (vocab <= 65536), got {dtype}"
    )
    return np.fromfile(path, dtype=dtype), int(md["vocab_size"])


def generate_shards(src: str, out_dir: str, shards: int,
                    tokens_per_shard: int, seed: int = 1,
                    p_uni: float = 0.02, p_bi: float = 0.15,
                    eval_tokens: Optional[int] = None) -> list:
    """Fit on ``src`` and write ``shards`` train shards + one eval shard
    (seed + 10^6 — held out by construction: a different chain seed gives
    a disjoint sample path from the same source). Returns written paths."""
    from orion_tpu_torch.training.data import write_token_bin

    tokens, vocab = _load_tokens(src)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(shards):
        out = os.path.join(out_dir, f"shard_{i:03d}.bin")
        arr = sample_tokens(tokens, seed + i, tokens_per_shard, p_uni, p_bi)
        write_token_bin(out, arr, vocab)
        paths.append(out)
    ev = eval_tokens if eval_tokens is not None else max(
        tokens_per_shard // 16, 65536
    )
    out = os.path.join(out_dir, "eval.bin")
    arr = sample_tokens(tokens, seed + 10**6, ev, p_uni, p_bi)
    write_token_bin(out, arr, vocab)
    paths.append(out)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("corpusgen")
    ap.add_argument("src", help="token-bin corpus to fit on (uint16)")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--tokens-per-shard", type=int, default=16_000_000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--p-unigram", type=float, default=0.02)
    ap.add_argument("--p-bigram", type=float, default=0.15)
    ap.add_argument("--eval-tokens", type=int, default=None)
    args = ap.parse_args(argv)
    paths = generate_shards(
        args.src, args.out_dir, args.shards, args.tokens_per_shard,
        args.seed, args.p_unigram, args.p_bigram, args.eval_tokens,
    )
    total = args.shards * args.tokens_per_shard
    print(json.dumps({"written": paths, "train_tokens": total}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
