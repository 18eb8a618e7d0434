"""The port's native runtime (``orion_tpu_torch/runtime/``: the C++ loader,
byte encoder, BPE encoder and corpus sampler, built with g++ into
``orion_tpu_torch/_build/``) on the CPU, held against its Python twins and
the JAX package's (``tests/test_runtime.py``), all bitwise:

- the native loader against the port's and the JAX package's Python
  ``TokenBinDataset``, uint16 and uint32 files, whole batches and a data
  rank's ``rows``;
- ``byte_encode_file`` against ``orion_tpu.prepare_data``'s output;
- ``NativeBPE`` against ``orion_tpu.utils.bpe``'s encode;
- the corpus sampler native against Python against
  ``orion_tpu.training.corpusgen``, and its shards against the JAX
  package's, read back through the sharded dataset;
- the vocabulary-mismatch refusal, the fallback without g++ (one stderr
  line), a failed compile (raises with the compiler's output), and a build
  that writes nothing under ``orion_tpu/``.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from orion_tpu import prepare_data as jax_prepare
from orion_tpu.training import corpusgen as jax_corpusgen
from orion_tpu.training.data import TokenBinDataset as JaxTokenBinDataset
from orion_tpu.utils import bpe as jax_bpe
from orion_tpu_torch import prepare_data, runtime
from orion_tpu_torch.training import corpusgen
from orion_tpu_torch.training.data import (
    ShardedTokenBinDataset, TokenBinDataset, make_dataset, window_starts, write_token_bin)
from orion_tpu_torch.utils import bpe

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def native():
    if not runtime.native_available():
        pytest.fail("the native runtime did not build (g++ is on this machine)")
    return runtime


@pytest.fixture
def small_corpus():
    # a structured stream (not uniform noise), so trigram contexts repeat
    rng = np.random.default_rng(3)
    a = rng.integers(0, 50, 4000)
    b = (a * 7 + np.roll(a, 1) * 3) % 211
    return (a * 211 + b % 37).astype(np.uint16)


@pytest.mark.parametrize("vocab", [250, 50000, 70000])  # uint16, uint16, uint32 files
def test_native_loader_bitwise_the_python_loaders(native, tmp_path, vocab):
    path = str(tmp_path / "t.bin")
    write_token_bin(path, (np.arange(5000, dtype=np.int64) * 7919) % vocab, vocab_size=vocab)
    seq = 33
    cc = native.NativeTokenBinDataset(path, seq)
    py, jx = TokenBinDataset(path, seq), JaxTokenBinDataset(path, seq)
    assert cc.n_windows == py.n_windows == jx.n_windows and cc.vocab_size == vocab
    for seed, step, b in [(0, 0, 4), (1, 0, 8), (0, 123, 3), (42, 7, 16)]:
        got = cc.batch(seed, step, b)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, py.batch(seed, step, b))
        np.testing.assert_array_equal(got, jx.batch(seed, step, b))
    rows = np.array([5, 1, 6])
    np.testing.assert_array_equal(cc.batch(9, 2, 8, rows=rows), py.batch(9, 2, 8, rows=rows))
    np.testing.assert_array_equal(cc.gather(window_starts(9, 2, 8, cc.n_windows)),
                                  py.batch(9, 2, 8))
    assert isinstance(runtime.make_fastest_dataset(path, seq), native.NativeTokenBinDataset)
    assert isinstance(make_dataset(path, seq), native.NativeTokenBinDataset)
    cc.close()


def test_byte_encode_file_bitwise_the_jax_prepare_data(native, tmp_path):
    src = tmp_path / "text.txt"
    src.write_bytes("hello orion tpu, héllo ☃\n".encode() * 100)
    ours, theirs, tool = (str(tmp_path / f"{n}.bin") for n in ("ours", "theirs", "tool"))
    n = native.byte_encode_file(str(src), ours)
    assert n == src.stat().st_size
    assert jax_prepare.prepare_bytes([str(src)], theirs) == n
    assert prepare_data.prepare_bytes([str(src)], tool) == n
    for path in (theirs, tool):
        assert Path(ours).read_bytes() == Path(path).read_bytes()
        assert Path(ours + ".meta.json").read_bytes() == Path(path + ".meta.json").read_bytes()
    assert TokenBinDataset(ours, 8).vocab_size == 256


def test_native_bpe_equals_the_python_encoders(native):
    rng = np.random.default_rng(0)
    words = ["the", "linear", "attention", "héllo", "42", "7", "!!", ",", " ", "\n", "naïve"]
    docs = [" ".join(words[i] for i in rng.integers(0, len(words), 80)) for _ in range(8)]
    tok = bpe.train_bpe(docs, 300)
    ref = jax_bpe.BPETokenizer(tok.merges)
    cc = native.NativeBPE(tok.merges)
    for text in docs + ["", "unseen wörds 123 ☃", "  \t x"]:
        want = ref.encode_py(text)
        assert cc.encode(text) == want == tok.encode_py(text)
        assert tok.encode(text) == want  # through the native encoder
    assert tok._native


def test_corpusgen_native_bitwise_python_and_the_jax_package(native, small_corpus):
    g = native.NativeCorpusGen(small_corpus)
    fast = g.sample(42, 3000)
    x1, x2, y = g.sample(7, 2000), g.sample(7, 2000), g.sample(8, 2000)
    g.close()
    slow = corpusgen.MarkovModel(small_corpus).sample(42, 3000)
    theirs = jax_corpusgen.MarkovModel(small_corpus).sample(42, 3000)
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(fast, theirs)
    np.testing.assert_array_equal(x1, x2)
    assert (x1 != y).any()
    assert set(np.unique(x1)) <= set(np.unique(small_corpus))


def test_corpusgen_shards_equal_the_jax_packages_and_read_back(native, tmp_path, small_corpus):
    src = str(tmp_path / "src.bin")
    write_token_bin(src, small_corpus, vocab_size=32000)
    paths = corpusgen.generate_shards(src, str(tmp_path / "big"), shards=3, tokens_per_shard=2500,
                                      seed=1, eval_tokens=800)
    theirs = jax_corpusgen.generate_shards(src, str(tmp_path / "jax"), shards=3,
                                           tokens_per_shard=2500, seed=1, eval_tokens=800)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in theirs]
    assert paths[-1].endswith("eval.bin")
    for a, b in zip(paths, theirs):
        assert Path(a).read_bytes() == Path(b).read_bytes()
        assert Path(a + ".meta.json").read_bytes() == Path(b + ".meta.json").read_bytes()
    seq = 32
    ds = make_dataset(str(tmp_path / "big"), seq)
    assert isinstance(ds, ShardedTokenBinDataset) and len(ds.shards) == 3  # eval.bin is held out
    assert all(isinstance(s, native.NativeTokenBinDataset) for s in ds.shards)
    assert ds.n_windows == 3 * (2500 - seq - 1)
    b1 = ds.batch(7, 3, 8)
    assert (b1 != ds.batch(7, 4, 8)).any()
    shard_toks = [np.fromfile(p, dtype=np.uint16) for p in paths[:3]]
    starts = window_starts(7, 3, 8, ds.n_windows)
    cum = np.cumsum([t.size - seq - 1 for t in shard_toks])
    which = np.searchsorted(cum, starts, side="right")
    local = starts - np.concatenate([[0], cum[:-1]])[which]
    for r in range(8):
        np.testing.assert_array_equal(
            b1[r], shard_toks[which[r]][local[r]:local[r] + seq + 1].astype(np.int32))
    # the numpy shards give the same batches
    py = ShardedTokenBinDataset.__new__(ShardedTokenBinDataset)
    py.__dict__.update(ds.__dict__, shards=[TokenBinDataset(p, seq) for p in paths[:3]])
    np.testing.assert_array_equal(py.batch(7, 3, 8), b1)
    np.testing.assert_array_equal(py.batch(7, 3, 8, rows=np.array([2, 3])), b1[2:4])
    assert corpusgen.main([src, "--out-dir", str(tmp_path / "cli"), "--shards", "1",
                           "--tokens-per-shard", "600", "--eval-tokens", "100"]) == 0
    assert (Path(tmp_path / "cli" / "shard_000.bin").read_bytes()
            == Path(paths[0]).read_bytes()[:1200])


def test_sharded_dataset_rejects_vocab_mismatch(tmp_path):
    p1, p2 = str(tmp_path / "shard_000.bin"), str(tmp_path / "shard_001.bin")
    write_token_bin(p1, np.arange(500) % 100, vocab_size=32000)
    write_token_bin(p2, np.arange(500) % 100, vocab_size=256)
    with pytest.raises(ValueError, match="vocab"):
        ShardedTokenBinDataset([p1, p2], 16)
    os.makedirs(tmp_path / "nothing")
    with pytest.raises(ValueError, match="no shard_"):
        make_dataset(str(tmp_path / "nothing"), 16)


def test_the_build_writes_nothing_under_the_jax_package(tmp_path, monkeypatch):
    """Every file the build creates or renames lies in its build directory,
    and no file of its names appears under ``orion_tpu/`` (the JAX
    package's own tests may build ``orion_tpu/runtime/liborion_runtime.so``
    meanwhile: that name is not the port's)."""
    def ours():
        return sorted(p for p in (ROOT / "orion_tpu").rglob("*")
                      if p.name.startswith("liborion_runtime-") or p.name.startswith("tmp"))

    before = ours()
    written = []
    mkstemp, replace = runtime.tempfile.mkstemp, runtime.os.replace
    monkeypatch.setattr(runtime.tempfile, "mkstemp",
                        lambda **kw: written.append(kw["dir"]) or mkstemp(**kw))
    monkeypatch.setattr(runtime.os, "replace",
                        lambda a, b: written.append(Path(b).parent) or replace(a, b))
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    path = runtime.build()
    assert path.parent == tmp_path / "build" and path.exists()
    assert written and all(Path(d) == tmp_path / "build" for d in written)
    assert [p.name for p in (tmp_path / "build").iterdir()] == [path.name]  # no temp left
    assert ours() == before


def test_without_a_compiler_the_twins_run_and_say_so(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(runtime, "_compiler", lambda: None)
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_tried", False)
    path = str(tmp_path / "t.bin")
    write_token_bin(path, np.arange(300) % 250, vocab_size=250)
    assert not runtime.native_available()
    assert isinstance(runtime.make_fastest_dataset(path, 16), TokenBinDataset)
    assert not runtime.native_available()
    err = capsys.readouterr().err
    assert err.count("no g++") == 1 and "Python twins" in err
    with pytest.raises(ImportError):
        runtime.NativeBPE([(104, 105)])
    assert runtime.byte_encode_file(path, str(tmp_path / "b.bin")) == 600  # numpy
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        runtime.build()


def test_a_failed_compile_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(runtime, "FLAGS", runtime.FLAGS + ("-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match="failed .* building the native runtime:\n.*error"):
        runtime.build()
    assert list((tmp_path / "build").iterdir()) == []  # the temporary file removed
