"""A JAX package checkpoint served by the port through
``export_jax_checkpoint.py``.

A ``tiny`` JAX Trainer checkpoint (orbax, with its integrity manifest) goes
through the export script into a port checkpoint directory; the port's
``load_model`` serves it and its greedy tokens must equal the JAX package's
``generate`` from ``load_params`` of the same step (``tiny`` runs in fp32 on
both sides, so the argmax agrees token for token). A pipeline-layout tree is
refused, not converted.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu import generate as jax_generate
from orion_tpu.models.configs import get_config as jax_config
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu_torch.generate import SampleConfig, cast_params_for_inference, generate, load_model
from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.training.checkpoint import load_params

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _export_module():
    spec = importlib.util.spec_from_file_location("export_jax_checkpoint",
                                                  ROOT / "export_jax_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """Two steps of the JAX Trainer on ``tiny``, saved at step 2."""
    from orion_tpu.parallel.mesh import MeshConfig
    from orion_tpu.training.checkpoint import Checkpointer
    from orion_tpu.training.data import SyntheticDataset
    from orion_tpu.training.trainer import TrainConfig, Trainer

    ck = str(tmp_path_factory.mktemp("jax_ck"))
    cfg = TrainConfig(model=jax_config("tiny"), steps=2, batch_size=2, seq_len=32, lr=1e-3,
                      warmup_steps=1, log_every=100, ckpt_dir=ck, ckpt_every=2,
                      mesh=MeshConfig(dp=1))
    trainer = Trainer(cfg)
    ds = SyntheticDataset(cfg.model.vocab_size, cfg.seq_len)
    ckpt = Checkpointer(ck, save_every=2, async_save=False)
    for step in (1, 2):
        trainer.step(jnp.asarray(ds.batch(0, step, 2)))
        ckpt.maybe_save(step, trainer.state)
    ckpt.close()
    return ck


def test_exported_checkpoint_gives_the_jax_packages_greedy_tokens(jax_ckpt, tmp_path):
    out = str(tmp_path / "port_ck")
    assert _export_module().main(["--config", "tiny", "--ckpt-dir", jax_ckpt, "--out", out]) == 0
    params, step = load_params(out)  # manifest-verified
    assert step == 2 and "embed.weight" in params

    jparams, jstep = jax_generate.load_params(jax_ckpt)
    assert jstep == 2
    prompt = np.array([[97, 98, 99], [1, 2, 3]], dtype=np.int32)
    ref = jax_generate.generate(JaxLM(jax_config("tiny")), jparams, jnp.asarray(prompt), 10,
                                jax_generate.SampleConfig(temperature=0.0),
                                jax.random.PRNGKey(0))
    model, step = load_model(TINY, out, "cpu")
    got = generate(cast_params_for_inference(model), torch.from_numpy(prompt).long(), 10,
                   SampleConfig(temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(FileExistsError):
        _export_module().export(jax_ckpt, out)


def test_a_pipeline_layout_tree_is_refused(monkeypatch, tmp_path):
    stacked = {"params": {"blocks_stacked": {"w": np.zeros((2, 4), np.float32)}}}
    monkeypatch.setattr(jax_generate, "load_params", lambda ckpt_dir, step=None: (stacked, 5))
    with pytest.raises(ValueError, match="item 12"):
        _export_module().export("unused", str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
