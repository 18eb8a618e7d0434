"""The port's generate path: greedy tokens equal the JAX package's, sampling
is deterministic per seed within the port and never emits a filtered
token, and the CLI runs on the CPU."""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.generate import SampleConfig as JaxSampleConfig
from orion_tpu.generate import generate as jax_generate
from orion_tpu.models.configs import TINY as JAX_TINY
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu_torch import generate as gen
from orion_tpu_torch.convert import expected_params, load_jax_params
from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.models.transformer import TransformerLM

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _tree(seed):
    """A flax param tree for TINY drawn with numpy at the flax init scales."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, (_, shape, transpose) in expected_params(TINY).items():
        shape = shape[::-1] if transpose else shape
        if path.endswith("scale"):
            arr = np.ones(shape)
        else:
            arr = rng.standard_normal(shape) / np.sqrt(shape[0] if transpose else shape[1])
        node = tree
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": tree}


def test_greedy_tokens_equal_jax_generate():
    params = _tree(0)
    prompt = np.random.default_rng(0).integers(0, 256, (2, 24), dtype=np.int32)
    ref = jax_generate(
        JaxLM(JAX_TINY), params, jnp.asarray(prompt), 16,
        JaxSampleConfig(temperature=0.0), jax.random.PRNGKey(0),
    )
    model = load_jax_params(TransformerLM(TINY, device="cpu"), params)
    out = gen.generate(model, torch.from_numpy(prompt), 16, gen.SampleConfig(temperature=0.0))
    assert out.shape == (2, 16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_eos_pads_after_the_first_eos():
    model = TransformerLM(TINY, device="cpu")
    prompt = torch.arange(10)[None].repeat(2, 1)
    free = gen.generate(model, prompt, 12, gen.SampleConfig(temperature=0.0))
    eos = int(free[0, 3])
    out = gen.generate(
        model, prompt, 12, gen.SampleConfig(temperature=0.0, eos_token=eos, pad_token=0)
    )
    for row_free, row in zip(free.tolist(), out.tolist()):
        if eos in row_free:
            cut = row_free.index(eos) + 1
            assert row[:cut] == row_free[:cut] and all(t == 0 for t in row[cut:])
        else:
            assert row == row_free


def test_sampled_decode_is_deterministic_per_seed():
    model = TransformerLM(TINY, device="cpu")
    prompt = torch.arange(12)[None].repeat(3, 1)
    cfg = gen.SampleConfig(temperature=1.0, top_k=50, top_p=0.95)

    def run(seed):
        return gen.generate(model, prompt, 10, cfg, torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.6), (0, 0.0), (300, 1.0)])
def test_filtered_tokens_are_never_sampled(top_k, top_p):
    rng = np.random.default_rng(top_k)
    logits = torch.from_numpy(rng.standard_normal((4, 256), dtype=np.float32) * 3.0)
    cfg = gen.SampleConfig(temperature=0.7, top_k=top_k, top_p=top_p)
    scaled = logits / cfg.temperature
    order = torch.argsort(scaled, dim=-1, descending=True)
    if top_k:
        allowed = order[:, : min(top_k, 256)]
    else:
        probs = torch.softmax(scaled, -1).gather(-1, order)
        n_keep = ((probs.cumsum(-1) - probs) < top_p).sum(-1).clamp(min=1)
        allowed = [order[i, : int(n_keep[i])] for i in range(4)]
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        tok = gen.sample_logits(logits, g, cfg)
        for i in range(4):
            assert int(tok[i]) in set(allowed[i].tolist())


def test_cli_runs_on_cpu(capsys):
    assert gen.main(
        ["--config", "tiny", "--device", "cpu", "--prompt", "Hi", "--max-new-tokens", "4",
         "--temperature", "0", "--set", "n_layers=1"]
    ) == 0
    assert capsys.readouterr().out.startswith("Hi")


def test_cli_module_entry_point():
    proc = subprocess.run(
        [sys.executable, "-m", "orion_tpu_torch.generate", "--device", "cpu",
         "--max-new-tokens", "3", "--prompt", "ab"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ab")
