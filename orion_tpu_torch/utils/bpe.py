"""Byte-level BPE: pure-Python trainer + encoder.

The port's copy of ``orion_tpu/utils/bpe.py`` (jax-free), with the same
merges, ids and JSON, so a tokenizer trained by either package serves both
(``tests/test_torch_bpe.py``). Its encode takes the native BPE encoder
(``orion_tpu_torch/runtime``'s ``NativeBPE`` over ``runtime/bpe.cc``) when the
native runtime is live, token for token the pure-Python ``encode_py``
(``tests/test_torch_runtime.py``).

The reference pairs its LM configs with a subword tokenizer in its native
layer (BASELINE.json "1.3B linear-attn LM pretrain on C4"; reference
checkout never mounted — SURVEY.md §0). This is the TPU-repo equivalent:
byte-level BPE (every byte is a base token, merges learned on top, so any
input round-trips losslessly), GPT-2-style greedy rank encoding, JSON
serialization. Training is the classic incremental-pair-count algorithm —
pure Python, no deps; fine for tens of MB of corpus offline.

Specials: <bos>, <eos> take the two highest ids. prepare_data writes <eos>
between documents.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

# leading whitespace rides with the following word (GPT-2 convention,
# simplified): " the" and "the" get distinct merge paths
_PRETOK = re.compile(rb"\s?[A-Za-z]+|\s?[0-9]+|\s?[^\sA-Za-z0-9]+|\s+")

Pair = Tuple[int, int]


class BPETokenizer:
    def __init__(self, merges: List[Pair], n_specials: int = 2):
        self.merges = list(merges)
        self.n_specials = n_specials
        self.ranks: Dict[Pair, int] = {
            tuple(p): 256 + i for i, p in enumerate(self.merges)
        }
        # id -> bytes expansion table
        table: List[bytes] = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            table.append(table[a] + table[b])
        self._bytes = table
        self._cache: Dict[bytes, List[int]] = {}
        self._native = None  # the runtime's NativeBPE, bound at the first encode (or False)

    # -- vocab layout -------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges) + self.n_specials

    @property
    def bos(self) -> int:
        return self.vocab_size - 2

    @property
    def eos(self) -> int:
        return self.vocab_size - 1

    # -- encode / decode ----------------------------------------------------

    def _bpe_word(self, word: bytes) -> List[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        parts: List[int] = list(word)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [best_rank]
        if len(self._cache) < 1 << 20:
            self._cache[word] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        """Through the native encoder when the runtime is live (identical
        output), else :meth:`encode_py`."""
        if self._native is None:
            from orion_tpu_torch import runtime

            self._native = runtime.NativeBPE(self.merges) if runtime.native_available() else False
        if self._native:
            return self._native.encode(text)
        return self.encode_py(text)

    def encode_py(self, text: str) -> List[int]:
        """Pure-Python encode (the contract reference for runtime/bpe.cc)."""
        out: List[int] = []
        for m in _PRETOK.finditer(text.encode("utf-8")):
            out.extend(self._bpe_word(m.group(0)))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        table = self._bytes
        chunks = [table[i] for i in ids if i < len(table)]
        return b"".join(chunks).decode("utf-8", errors="replace")

    # -- serialization ------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "type": "byte_bpe",
                    "merges": [list(p) for p in self.merges],
                    "n_specials": self.n_specials,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        if d.get("type") != "byte_bpe":
            raise ValueError(f"{path}: not a byte_bpe tokenizer (type {d.get('type')!r})")
        return cls([tuple(p) for p in d["merges"]], d.get("n_specials", 2))


def train_bpe(
    texts: Iterable[str], vocab_size: int, n_specials: int = 2,
    min_pair_count: int = 2, verbose: bool = False,
) -> BPETokenizer:
    """Classic BPE training with incremental pair-count maintenance.

    Complexity per merge is O(words containing the merged pair), not
    O(corpus) — the pair→word index keeps 32k merges tractable in Python.
    """
    n_merges = vocab_size - 256 - n_specials
    if n_merges <= 0:
        raise ValueError(f"vocab_size {vocab_size} leaves no room for merges")

    word_counts: Counter = Counter()
    for text in texts:
        for m in _PRETOK.finditer(text.encode("utf-8")):
            word_counts[m.group(0)] += 1

    # words as mutable id lists + global pair counts + pair -> word index
    words: List[List[int]] = []
    counts: List[int] = []
    for w, c in word_counts.items():
        words.append(list(w))
        counts.append(c)
    pair_counts: Counter = Counter()
    pair_words: Dict[Pair, set] = {}
    for wi, parts in enumerate(words):
        c = counts[wi]
        for p in zip(parts, parts[1:]):
            pair_counts[p] += c
            pair_words.setdefault(p, set()).add(wi)

    merges: List[Pair] = []
    for step in range(n_merges):
        if not pair_counts:
            break
        best, best_c = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))
        if best_c < min_pair_count:
            break
        new_id = 256 + len(merges)
        merges.append(best)
        affected = pair_words.pop(best, set())
        pair_counts.pop(best, None)
        a, b = best
        for wi in affected:
            parts = words[wi]
            c = counts[wi]
            i = 0
            while i < len(parts) - 1:
                if parts[i] == a and parts[i + 1] == b:
                    # remove neighbor pair counts around the merge site
                    if i > 0:
                        old = (parts[i - 1], a)
                        pair_counts[old] -= c
                        if pair_counts[old] <= 0:
                            del pair_counts[old]
                            pair_words.pop(old, None)
                    if i + 2 < len(parts):
                        old = (b, parts[i + 2])
                        pair_counts[old] -= c
                        if pair_counts[old] <= 0:
                            del pair_counts[old]
                            pair_words.pop(old, None)
                    parts[i : i + 2] = [new_id]
                    if i > 0:
                        new = (parts[i - 1], new_id)
                        pair_counts[new] += c
                        pair_words.setdefault(new, set()).add(wi)
                    if i + 1 < len(parts):
                        new = (new_id, parts[i + 1])
                        pair_counts[new] += c
                        pair_words.setdefault(new, set()).add(wi)
                else:
                    i += 1
        if verbose and (step + 1) % 1000 == 0:
            print(f"bpe: {step + 1}/{n_merges} merges", flush=True)

    return BPETokenizer(merges, n_specials)


__all__ = ["BPETokenizer", "train_bpe"]
