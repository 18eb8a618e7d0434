"""Byte-level tokenizer: ids 0..255 are raw bytes, optional specials after.

The port's copy of ``orion_tpu/utils/tokenizer.py`` (the BPE tokenizer and
the native encode runtime come with a later slice; ROADMAP.md queue A)."""

from __future__ import annotations

from typing import List, Sequence


class ByteTokenizer:
    BOS = 256
    EOS = 257

    def __init__(self, add_specials: bool = False):
        self.add_specials = add_specials

    @property
    def vocab_size(self) -> int:
        return 258 if self.add_specials else 256

    def encode(self, text: str) -> List[int]:
        ids = list(text.encode("utf-8"))
        if self.add_specials:
            return [self.BOS] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


__all__ = ["ByteTokenizer"]
