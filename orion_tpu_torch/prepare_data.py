"""`python -m orion_tpu_torch.prepare_data` — corpus → token-bin converter.

The port's copy of ``orion_tpu/prepare_data.py``: the same files, bitwise
(``tests/test_torch_bpe.py``), which ``orion_tpu_torch/training/data.py``
reads. Two tokenizer paths:

- **byte-level** (default): raw bytes → uint16 token-bin, vocab 256; one
  plain file streams through the native byte encoder
  (``orion_tpu_torch.runtime.byte_encode_file`` over runtime/tokenizer.cc,
  numpy without g++).
- **subword BPE** (``--tokenizer tok.json``): byte-level BPE encoding for
  the 32k-vocab flagship configs. Train one first with
  ``--train-tokenizer --vocab-size 32000 --tokenizer-out tok.json``
  (pure-Python trainer, utils/bpe.py). Documents are separated by <eos>.

Inputs: HuggingFace-style JSONL (one {"text": ...} per line — the C4
layout) with ``--jsonl``; plain text/WikiText files concatenate as-is.

End-to-end real-data recipe:
    python -m orion_tpu_torch.prepare_data corpus.jsonl --jsonl \\
        --train-tokenizer --vocab-size 32000 --tokenizer-out tok.json
    python -m orion_tpu_torch.prepare_data corpus.jsonl --jsonl \\
        --tokenizer tok.json --out train.bin
    python -m orion_tpu_torch.train --config lm_1b3 --data train.bin --ckpt-dir ck ...
    python -m orion_tpu_torch.evaluate --config lm_1b3 --data val.bin --ckpt-dir ck
    python -m orion_tpu_torch.generate --config lm_1b3 --ckpt-dir ck --tokenizer tok.json --eos
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterator, List

import numpy as np


def iter_texts(inputs: List[str], jsonl: bool, field: str = "text") -> Iterator[str]:
    """Yield one document per element (JSONL) or one per file (plain)."""
    for path in inputs:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            if jsonl:
                for line in f:
                    if not line.strip():
                        continue
                    yield json.loads(line)[field]
            else:
                yield f.read()


def prepare_bytes(
    inputs: list[str],
    out_path: str,
    jsonl: bool = False,
    field: str = "text",
    sep: bytes = b"\n\n",
) -> int:
    """Byte-level path (vocab 256). One plain file is written as its bytes,
    with no separator, by the runtime's streaming encoder."""
    if not jsonl and len(inputs) == 1:
        from orion_tpu_torch import runtime

        return runtime.byte_encode_file(inputs[0], out_path)

    total = 0
    with open(out_path, "wb") as out:
        for path in inputs:
            with open(path, "rb") as f:
                if jsonl:
                    for line in f:
                        if not line.strip():
                            continue
                        text = json.loads(line)[field].encode("utf-8") + sep
                        np.frombuffer(text, dtype=np.uint8).astype(np.uint16).tofile(out)
                        total += len(text)
                else:
                    data = f.read() + sep
                    np.frombuffer(data, dtype=np.uint8).astype(np.uint16).tofile(out)
                    total += len(data)
    with open(out_path + ".meta.json", "w") as f:
        json.dump({"dtype": "uint16", "count": total, "vocab_size": 256}, f)
    return total


def prepare_bpe(
    inputs: list[str],
    out_path: str,
    tokenizer_path: str,
    jsonl: bool = False,
    field: str = "text",
) -> int:
    """Subword path: BPE-encode documents, <eos> between them."""
    from orion_tpu_torch.utils.bpe import BPETokenizer

    tok = BPETokenizer.load(tokenizer_path)
    if tok.vocab_size > 65536:
        raise ValueError(f"tokenizer vocab {tok.vocab_size}: the token-bin format is uint16")
    total = 0
    with open(out_path, "wb") as out:
        for text in iter_texts(inputs, jsonl, field):
            ids = tok.encode(text) + [tok.eos]
            np.asarray(ids, dtype=np.uint16).tofile(out)
            total += len(ids)
    with open(out_path + ".meta.json", "w") as f:
        json.dump(
            {
                "dtype": "uint16",
                "count": total,
                "vocab_size": tok.vocab_size,
                "tokenizer": tokenizer_path,
            },
            f,
        )
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser("orion_tpu_torch.prepare_data")
    p.add_argument("inputs", nargs="+", help="text or JSONL files")
    p.add_argument("--out", default=None, help="output token-bin path")
    p.add_argument("--jsonl", action="store_true", help="inputs are JSONL (C4-style)")
    p.add_argument("--field", default="text", help="JSONL text field")
    p.add_argument("--tokenizer", default=None,
                   help="BPE tokenizer JSON → subword token-bin (else bytes)")
    p.add_argument("--train-tokenizer", action="store_true",
                   help="train a BPE tokenizer on the inputs and exit")
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--tokenizer-out", default="tokenizer.json")
    args = p.parse_args(argv)

    if args.train_tokenizer:
        from orion_tpu_torch.utils.bpe import train_bpe

        tok = train_bpe(
            iter_texts(args.inputs, args.jsonl, args.field),
            args.vocab_size, verbose=True,
        )
        tok.save(args.tokenizer_out)
        print(f"trained BPE vocab={tok.vocab_size} -> {args.tokenizer_out}")
        return 0

    if not args.out:
        p.error("--out is required unless --train-tokenizer")
    if args.tokenizer:
        n = prepare_bpe(args.inputs, args.out, args.tokenizer, args.jsonl, args.field)
    else:
        n = prepare_bytes(args.inputs, args.out, args.jsonl, args.field)
    print(f"wrote {n} tokens to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
