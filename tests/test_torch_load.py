"""The port's main path closed: train -> checkpoint -> generate / evaluate.

``tiny`` is trained with the port's train CLI on the CPU into a checkpoint
directory; ``generate`` and ``evaluate`` load it (``training/checkpoint.py::
load_params``: memory-mapped, manifest-verified, retried) and must give
exactly what the in-memory trained model gives: the same greedy tokens, the
same eval loss (the same weights and the same CPU arithmetic, so equality
is exact). Then the load's guards: a torn latest step falls back with a
warning, a pinned step never falls back, a manifest mismatch raises, a step
without a manifest loads with a warning, and a ``--seq-len`` that raised
``max_seq_len`` in training is read back off the stored table. The retry
helper is the JAX package's, copied: both back off alike.
"""

import ast
import os
import random
import shutil

import pytest
import torch

from orion_tpu.resilience import retry as jax_retry
from orion_tpu_torch import evaluate as evaluate_mod
from orion_tpu_torch import generate as generate_mod
from orion_tpu_torch import train as train_mod
from orion_tpu_torch.generate import (
    SampleConfig,
    adapt_config_to_params,
    cast_params_for_inference,
    generate,
    generate_unconditional,
    load_model,
    load_params,
    quantize_for_decode,
)
from orion_tpu_torch.models.configs import TINY, get_config
from orion_tpu_torch.models.transformer import TransformerLM
from orion_tpu_torch.resilience import retry
from orion_tpu_torch.training.checkpoint import CheckpointIntegrityError, step_path
from orion_tpu_torch.training.data import SyntheticDataset

torch.set_num_threads(2)
GREEDY = SampleConfig(temperature=0.0)
PROMPT = "ab"


def _train(tmp_path_factory, monkeypatch_scope, name, extra):
    """Run the train CLI on the CPU; return (ckpt dir, the trained Trainer)."""
    ck = str(tmp_path_factory.mktemp(name))
    seen = {}
    real = train_mod.train

    def spy(*a, **kw):
        trainer, last = real(*a, **kw)
        seen["trainer"] = trainer
        return trainer, last

    monkeypatch_scope.setattr(train_mod, "train", spy)
    rc = train_mod.main(["--config", "tiny", "--steps", "3", "--batch-size", "2",
                         "--device", "cpu", "--ckpt-dir", ck, "--set", "ckpt_every=2",
                         "--set", "warmup_steps=1", "--lr", "1e-3", *extra])
    monkeypatch_scope.undo()
    assert rc == 0
    return ck, seen["trainer"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    return _train(tmp_path_factory, mp, "ck", ["--seq-len", "32"])


def _copy(ck, tmp_path):
    dst = str(tmp_path / "ck")
    shutil.copytree(ck, dst)
    return dst


def _in_memory(trainer, quant=""):
    """The trained model as generate serves it: fresh weights from the
    trainer's, cast (or quantized) the same way as a loaded model."""
    model = TransformerLM(trainer.model.cfg, device="cpu")
    model.load_state_dict({n: p.detach() for n, p in trainer.params.items()})
    return quantize_for_decode(model, quant) if quant else cast_params_for_inference(model)


def _prompt():
    return torch.tensor([list(PROMPT.encode())])


def test_loaded_checkpoint_generates_the_in_memory_models_greedy_tokens(trained, capsys):
    ck, trainer = trained
    params, step = load_params(ck)
    assert step == 3 and set(params) == set(trainer.params)
    for n, p in trainer.params.items():
        assert torch.equal(params[n], p.detach()), n
    model, step = load_model(TINY, ck, "cpu")
    ref = generate(_in_memory(trainer), _prompt(), 12, GREEDY)
    got = generate(cast_params_for_inference(model), _prompt(), 12, GREEDY)
    assert torch.equal(got, ref)
    assert generate_mod.main(["--config", "tiny", "--ckpt-dir", ck, "--device", "cpu",
                              "--prompt", PROMPT, "--max-new-tokens", "12",
                              "--temperature", "0"]) == 0
    out = capsys.readouterr()
    assert out.out == PROMPT + bytes(int(t) for t in ref[0]).decode("utf-8", "replace") + "\n"
    assert "loaded step 3" in out.err
    unc = generate_unconditional(model, 2, 4, bos_token=7, sample=GREEDY)
    assert torch.equal(unc, generate(model, torch.full((2, 1), 7), 4, GREEDY))


def test_loaded_checkpoint_evaluates_as_the_in_memory_model(trained, capsys):
    from orion_tpu_torch.evaluate import evaluate_lm

    ck, trainer = trained
    assert evaluate_mod.main(["--config", "tiny", "--ckpt-dir", ck, "--device", "cpu",
                              "--batch-size", "2", "--seq-len", "32", "--n-batches", "2"]) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip())
    ref = evaluate_lm(trainer.model, SyntheticDataset(TINY.vocab_size, 32), 2, 2)
    assert got == {**ref, "step": 3}


def test_int4_generate_of_a_loaded_model(trained, capsys):
    ck, trainer = trained
    model, _ = load_model(TINY, ck, "cpu")
    got = generate(quantize_for_decode(model, "int4"), _prompt(), 8, GREEDY)
    assert torch.equal(got, generate(_in_memory(trainer, "int4"), _prompt(), 8, GREEDY))
    assert generate_mod.main(["--config", "tiny", "--ckpt-dir", ck, "--device", "cpu",
                              "--quant", "int4", "--prompt", PROMPT, "--max-new-tokens", "8",
                              "--temperature", "0"]) == 0
    assert capsys.readouterr().out == (
        PROMPT + bytes(int(t) for t in got[0]).decode("utf-8", "replace") + "\n")
    assert evaluate_mod.main(["--config", "tiny", "--ckpt-dir", ck, "--device", "cpu",
                              "--quant", "int4", "--batch-size", "2", "--seq-len", "32",
                              "--n-batches", "1"]) == 0
    res = ast.literal_eval(capsys.readouterr().out.strip())
    assert res["quant"] == "int4" and res["step"] == 3 and res["eval_loss"] > 0


def test_a_torn_latest_step_falls_back_with_a_warning(trained, tmp_path):
    ck = _copy(trained[0], tmp_path)
    path = step_path(ck, 3)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.warns(UserWarning, match="corrupt or incomplete"):
        params, step = load_params(ck)
    assert step == 2
    ref = torch.load(step_path(trained[0], 2), weights_only=True)["params"]
    assert all(torch.equal(params[n], ref[n]) for n in ref)
    with pytest.raises(Exception):  # a pinned step never falls back
        load_params(ck, step=3)


def _flip_a_param_byte(path):
    """Flip one byte inside the data of the largest params leaf."""
    state = torch.load(path, weights_only=True)
    name = max(state["params"], key=lambda n: state["params"][n].numel())
    state["params"][name].view(-1)[7] += 1.0
    torch.save(state, path)


def test_a_pinned_step_on_a_corrupt_file_raises(trained, tmp_path):
    ck = _copy(trained[0], tmp_path)
    _flip_a_param_byte(step_path(ck, 3))
    with pytest.raises(CheckpointIntegrityError, match="checksum"):
        evaluate_mod.main(["--config", "tiny", "--ckpt-dir", ck, "--device", "cpu",
                           "--step", "3", "--seq-len", "32", "--n-batches", "1"])
    with pytest.warns(UserWarning, match="corrupt or incomplete"):
        _, step = load_params(ck)  # not pinned: the newest intact step
    assert step == 2


def test_a_manifest_mismatch_raises_and_no_manifest_warns(trained, tmp_path):
    import json

    ck = _copy(trained[0], tmp_path)
    mpath = os.path.join(ck, "manifests", "manifest-3.json")
    with open(mpath) as f:
        manifest = json.load(f)
    leaf = next(e for e in manifest["leaves"] if e["path"].startswith("params/"))
    leaf["crc32"] ^= 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointIntegrityError, match="checksum"):
        load_params(ck, step=3)
    # a changed optimizer leaf does not concern the params
    params, _ = load_params(trained[0], step=3)
    os.remove(os.path.join(ck, "manifests", "manifest-2.json"))
    with pytest.warns(UserWarning, match="no params integrity manifest"):
        params2, step = load_params(ck, step=2)
    assert step == 2 and set(params2) == set(params)
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "nowhere"))


def test_seq_len_at_max_seq_len_is_adapted_back_on_load(tmp_path_factory, capsys):
    ck, trainer = _train(tmp_path_factory, pytest.MonkeyPatch(), "ck_long",
                         ["--seq-len", "32", "--set", "model.max_seq_len=32"])
    assert trainer.model.cfg.max_seq_len == 33
    params, _ = load_params(ck)
    cfg = adapt_config_to_params(TINY, params)
    assert cfg.max_seq_len == 33 and cfg.vocab_size == TINY.vocab_size
    assert adapt_config_to_params(TINY, {"other": torch.zeros(1)}) == TINY
    model, _ = load_model(TINY, ck, "cpu")
    assert model.cfg.max_seq_len == 33
    assert evaluate_mod.main(["--config", "tiny", "--ckpt-dir", ck, "--device", "cpu",
                              "--seq-len", "32", "--batch-size", "2", "--n-batches", "1"]) == 0
    capsys.readouterr()
    with pytest.raises(ValueError, match="max_seq_len=33"):
        evaluate_mod.main(["--config", "tiny", "--ckpt-dir", ck, "--device", "cpu",
                           "--seq-len", "40", "--n-batches", "1"])
    wide = adapt_config_to_params(get_config("tiny", vocab_size=300), params)
    assert wide.vocab_size == TINY.vocab_size


def test_retry_is_the_jax_packages_copy():
    assert [f.name for f in retry.RetryPolicy.__dataclass_fields__.values()] == [
        f.name for f in jax_retry.RetryPolicy.__dataclass_fields__.values()]
    assert retry.RetryPolicy() == retry.RetryPolicy(**vars(jax_retry.RetryPolicy()))
    for mod in (retry, jax_retry):
        delays, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("blip")
            return "ok"

        with pytest.warns(UserWarning, match="retrying"):
            assert mod.call_with_retries(flaky, mod.RetryPolicy(attempts=3), sleep=delays.append,
                                         rng=random.Random(0)) == "ok"
        if mod is retry:
            ours = delays
    assert ours == delays
    with pytest.raises(ValueError):
        retry.call_with_retries(lambda: (_ for _ in ()).throw(ValueError("corrupt")),
                                sleep=lambda s: None)
