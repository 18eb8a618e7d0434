"""The port's tokenizer and data tools held against the JAX package's.

``orion_tpu_torch.utils.bpe`` and ``orion_tpu_torch.prepare_data`` are
copies of the JAX package's jax-free modules: on a corpus the test writes
(nothing is downloaded) the BPE trainers must give the same JSON, the
encoders the same ids, and ``prepare_data`` bitwise the same token-bins and
sidecars on the byte, JSONL and BPE paths. ``generate --tokenizer --eos``
sets ``SampleConfig.eos_token`` and prints the ids up to the EOS.
"""

import json

import numpy as np
import pytest
import torch

from orion_tpu import prepare_data as jax_prepare
from orion_tpu.utils import bpe as jax_bpe
from orion_tpu_torch import generate as generate_mod
from orion_tpu_torch import prepare_data
from orion_tpu_torch.utils import bpe

torch.set_num_threads(2)
_WORDS = ["the", "linear", "attention", "state", "token", "chunk", "kernel", "card", "héllo",
          "42", "7", "!", ",", "decode", "prefill"]


def _docs(seed, n_docs=12, n_words=60):
    rng = np.random.default_rng(seed)
    return [" ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), n_words)) + "."
            for _ in range(n_docs)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    docs = _docs(0)
    (d / "a.txt").write_text("\n".join(docs[:6]), encoding="utf-8")
    (d / "b.txt").write_text("\n".join(docs[6:]), encoding="utf-8")
    with open(d / "c.jsonl", "w", encoding="utf-8") as f:
        for doc in docs:
            f.write(json.dumps({"text": doc}) + "\n\n")
    tok = str(d / "tok.json")
    assert prepare_data.main([str(d / "c.jsonl"), "--jsonl", "--train-tokenizer",
                              "--vocab-size", "300", "--tokenizer-out", tok]) == 0
    return d, docs, tok


def test_train_bpe_gives_the_jax_packages_json(corpus, tmp_path):
    d, docs, tok = corpus
    jax_tok = str(tmp_path / "jax_tok.json")
    assert jax_prepare.main([str(d / "c.jsonl"), "--jsonl", "--train-tokenizer",
                             "--vocab-size", "300", "--tokenizer-out", jax_tok]) == 0
    with open(tok) as f, open(jax_tok) as g:
        assert json.load(f) == json.load(g)
    ours = bpe.train_bpe(docs, 280)
    theirs = jax_bpe.train_bpe(docs, 280)
    assert ours.merges == theirs.merges and ours.vocab_size == theirs.vocab_size == 280
    with pytest.raises(ValueError, match="no room"):
        bpe.train_bpe(docs, 257)


def test_encode_and_decode_match_the_jax_package(corpus):
    _, docs, tok = corpus
    ours, theirs = bpe.BPETokenizer.load(tok), jax_bpe.BPETokenizer.load(tok)
    assert (ours.vocab_size, ours.bos, ours.eos) == (theirs.vocab_size, theirs.bos, theirs.eos)
    for text in docs[:3] + ["unseen wörds ☃ 123", ""]:
        ids = ours.encode(text)
        assert ids == theirs.encode(text) == theirs.encode_py(text)
        assert ours.decode(ids) == theirs.decode(ids) == text
    assert ours.decode([ours.eos, 65]) == theirs.decode([theirs.eos, 65]) == "A"


@pytest.mark.parametrize("path", ["bytes_one_file", "bytes_two_files", "bytes_jsonl",
                                  "bpe_jsonl", "bpe_text"])
def test_prepare_data_writes_the_jax_packages_files(corpus, tmp_path, path):
    d, _, tok = corpus
    inputs = {"bytes_one_file": [str(d / "a.txt")],
              "bytes_two_files": [str(d / "a.txt"), str(d / "b.txt")],
              "bytes_jsonl": [str(d / "c.jsonl"), "--jsonl"],
              "bpe_jsonl": [str(d / "c.jsonl"), "--jsonl", "--tokenizer", tok],
              "bpe_text": [str(d / "a.txt"), str(d / "b.txt"), "--tokenizer", tok]}[path]
    ours, theirs = str(tmp_path / "ours.bin"), str(tmp_path / "theirs.bin")
    assert prepare_data.main(inputs + ["--out", ours]) == 0
    assert jax_prepare.main(inputs + ["--out", theirs]) == 0
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        data = f.read()
        assert data == g.read() and len(data) > 0
    with open(ours + ".meta.json") as f, open(theirs + ".meta.json") as g:
        assert json.load(f) == json.load(g)


def test_the_port_reads_what_prepare_data_writes(corpus, tmp_path):
    from orion_tpu_torch.training.data import make_dataset

    d, _, tok = corpus
    out = str(tmp_path / "t.bin")
    prepare_data.main([str(d / "c.jsonl"), "--jsonl", "--tokenizer", tok, "--out", out])
    ds = make_dataset(out, 16)
    assert ds.vocab_size == bpe.BPETokenizer.load(tok).vocab_size
    batch = ds.batch(0, 0, 2)
    assert batch.shape == (2, 17) and int(batch.max()) < ds.vocab_size


def test_generate_with_tokenizer_and_eos_trims_at_eos(corpus, monkeypatch, capsys):
    _, _, tok_path = corpus
    tok = bpe.BPETokenizer.load(tok_path)
    body = tok.encode(" the kernel")
    seen = {}

    def fake_generate(model, prompt, max_new_tokens, sample, generator):
        seen["prompt"], seen["sample"] = prompt, sample
        return torch.tensor([body + [tok.eos] + tok.encode(" after")])

    monkeypatch.setattr(generate_mod, "generate", fake_generate)
    args = ["--config", "tiny", "--set", f"vocab_size={tok.vocab_size}", "--device", "cpu",
            "--tokenizer", tok_path, "--prompt", "the state", "--max-new-tokens", "8",
            "--temperature", "0"]
    assert generate_mod.main(args + ["--eos"]) == 0
    assert capsys.readouterr().out == "the state the kernel\n"
    assert seen["sample"].eos_token == tok.eos
    assert seen["prompt"].tolist() == [tok.encode("the state")]
    assert generate_mod.main(args) == 0  # without --eos nothing is trimmed
    assert capsys.readouterr().out == "the state the kernel after\n"
    assert seen["sample"].eos_token == -1
    with pytest.raises(ValueError, match="tokenizer vocab"):
        generate_mod.main(args[:2] + args[4:])  # tiny's 256 ids are too few


def test_generate_stops_a_row_at_eos():
    """The decode loop itself: a row that emits EOS pads after it."""
    from orion_tpu_torch.generate import SampleConfig, generate
    from orion_tpu_torch.models.configs import TINY
    from orion_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(TINY, device="cpu")
    prompt = torch.tensor([[1, 2, 3], [4, 5, 6]])
    free = generate(model, prompt, 6, SampleConfig(temperature=0.0))
    eos = int(free[0, 1])
    got = generate(model, prompt, 6, SampleConfig(temperature=0.0, eos_token=eos, pad_token=0))
    first = int((free[0] == eos).nonzero()[0])
    assert got[0, : first + 1].tolist() == free[0, : first + 1].tolist()
    assert got[0, first + 1:].tolist() == [0] * (5 - first)
