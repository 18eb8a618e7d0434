"""A JAX package checkpoint served by the port through
``export_jax_checkpoint.py``.

A ``tiny`` JAX Trainer checkpoint (orbax, with its integrity manifest) goes
through the export script into a port checkpoint directory; the port's
``load_model`` serves it and its greedy tokens must equal the JAX package's
``generate`` from ``load_params`` of the same step (``tiny`` runs in fp32 on
both sides, so the argmax agrees token for token). The same for a ``tiny``
with the ``favor`` feature map and an untied head. An ``lra_listops_linear``
classifier narrowed to d 32 (``train_lra`` for 2 steps in the JAX package,
its params saved as a training state) goes through the same script, and
through ``load_jax_params`` directly, into ``LRAClassifier``: its logits
agree with the JAX package's within 1e-4 (fp32). A JAX pp=2 Trainer's
``tiny`` checkpoint (the pipeline layout) goes through the same script and
serves logits within 1e-4 of the JAX model's on the unstacked params; the
older pipeline layout without ``sub_0`` exports to the same params.
"""

import dataclasses

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
from orion_tpu_torch.convert import load_jax_params
from orion_tpu_torch.generate import SampleConfig, cast_params_for_inference, generate, load_model
from orion_tpu_torch.models.classifier import LRAClassifier
from orion_tpu_torch.models.configs import TINY, get_config
from orion_tpu_torch.training.checkpoint import load_params

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _export_module():
    spec = importlib.util.spec_from_file_location("export_jax_checkpoint",
                                                  ROOT / "export_jax_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_OPTIONS = {"tiny": {}, "favor_untied": {"feature_map": "favor", "tie_embeddings": False}}
_SETS = {"tiny": [], "favor_untied": ["--set", "feature_map=favor", "--set", "tie_embeddings=false"]}


def _jax_ckpt(tmp_path_factory, over):
    """Two steps of the JAX Trainer on ``tiny`` (with ``over``), saved at
    step 2."""
    from orion_tpu.parallel.mesh import MeshConfig
    from orion_tpu.training.checkpoint import Checkpointer
    from orion_tpu.training.data import SyntheticDataset
    from orion_tpu.training.trainer import TrainConfig, Trainer

    ck = str(tmp_path_factory.mktemp("jax_ck"))
    cfg = TrainConfig(model=dataclasses.replace(jax_config("tiny"), **over), steps=2,
                      batch_size=2, seq_len=32, lr=1e-3,
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


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    return _jax_ckpt(tmp_path_factory, {})


@pytest.mark.parametrize("option", list(_OPTIONS))
def test_exported_checkpoint_gives_the_jax_packages_greedy_tokens(option, jax_ckpt, tmp_path,
                                                                   tmp_path_factory):
    over = _OPTIONS[option]
    ck = jax_ckpt if not over else _jax_ckpt(tmp_path_factory, over)
    out = str(tmp_path / "port_ck")
    assert _export_module().main(["--config", "tiny", "--ckpt-dir", ck, "--out", out]
                                 + _SETS[option]) == 0
    params, step = load_params(out)  # manifest-verified
    assert step == 2 and "embed.weight" in params
    assert ("lm_head_kernel" in params) == bool(over)

    jparams, jstep = jax_generate.load_params(ck)
    assert jstep == 2
    prompt = np.array([[97, 98, 99], [1, 2, 3]], dtype=np.int32)
    ref = jax_generate.generate(JaxLM(dataclasses.replace(jax_config("tiny"), **over)), jparams,
                                jnp.asarray(prompt), 10,
                                jax_generate.SampleConfig(temperature=0.0),
                                jax.random.PRNGKey(0))
    model, step = load_model(dataclasses.replace(TINY, **over), out, "cpu")
    got = generate(cast_params_for_inference(model), torch.from_numpy(prompt).long(), 10,
                   SampleConfig(temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(FileExistsError):
        _export_module().export(ck, out, overrides=_SETS[option][1::2])


def test_an_lra_classifier_crosses_through_the_script_and_load_jax_params(tmp_path):
    from orion_tpu import train_lra as jax_lra
    from orion_tpu.models.classifier import LRAClassifier as JaxClassifier
    from orion_tpu.training.checkpoint import Checkpointer
    from orion_tpu.training.trainer import TrainState

    small = dict(d_model=32, n_heads=2, max_seq_len=40)
    jcfg = dataclasses.replace(jax_config("lra_listops_linear"), **small)
    jparams, _ = jax_lra.train_lra(jax_lra.LRATrainConfig(
        model=jcfg, steps=2, batch_size=2, seq_len=32, warmup_steps=1, eval_every=0,
        mesh=jax_lra.MeshConfig(dp=1)))
    ck = str(tmp_path / "jax_ck")
    ckpt = Checkpointer(ck, save_every=1, async_save=False)
    zero = jnp.zeros((), jnp.int32)
    ckpt.maybe_save(2, TrainState(step=zero + 2, params=jparams, opt_state={}, rng=zero,
                                  nonfinite=zero))
    ckpt.close()
    out = str(tmp_path / "port_ck")
    assert _export_module().main(["--config", "lra_listops_linear", "--ckpt-dir", ck,
                                  "--out", out, "--set", "d_model=32", "--set", "n_heads=2",
                                  "--set", "max_seq_len=40"]) == 0
    params, step = load_params(out)
    assert step == 2 and "cls" in params and "head.weight" in params
    cfg = dataclasses.replace(get_config("lra_listops_linear"), **small)
    via_script = LRAClassifier(cfg, device="cpu")
    via_script.load_state_dict(params, strict=True)
    direct = load_jax_params(LRAClassifier(cfg, device="cpu"), jax.device_get(jparams))
    toks, _, mask = jax_lra.SyntheticListOps(32).batch(5, 0, 3)
    mask[1, 20:] = False
    ref = np.asarray(JaxClassifier(jcfg).apply(jparams, jnp.asarray(toks), jnp.asarray(mask)))
    with torch.no_grad():
        for model in (via_script, direct):
            got = model(torch.from_numpy(toks).long(), torch.from_numpy(mask)).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_a_pipeline_layout_checkpoint_is_exported_and_served(monkeypatch, tmp_path,
                                                              tmp_path_factory):
    """A JAX pp=2 Trainer's ``tiny`` checkpoint (its state in the pipeline
    layout, ``blocks_stacked``) goes through the script: the port's logits
    of the exported file within 1e-4 of the JAX model's on the unstacked
    params; the older layout without ``sub_0`` exports to the same params."""
    from orion_tpu.parallel.mesh import MeshConfig
    from orion_tpu.parallel.pipeline_lm import unstack_lm_params
    from orion_tpu.training.checkpoint import Checkpointer
    from orion_tpu.training.data import SyntheticDataset
    from orion_tpu.training.trainer import TrainConfig, Trainer

    ck = str(tmp_path_factory.mktemp("jax_pp_ck"))
    cfg = TrainConfig(model=jax_config("tiny"), steps=2, batch_size=4, seq_len=32, lr=1e-3,
                      warmup_steps=1, log_every=100, mesh=MeshConfig(dp=1, pp=2))
    trainer = Trainer(cfg)
    ds = SyntheticDataset(cfg.model.vocab_size, cfg.seq_len)
    ckpt = Checkpointer(ck, save_every=2, async_save=False)
    for step in (1, 2):
        trainer.step(jnp.asarray(ds.batch(0, step, 4)))
        ckpt.maybe_save(step, trainer.state)
    ckpt.close()
    jparams, jstep = jax_generate.load_params(ck)
    assert jstep == 2 and "blocks_stacked" in jparams["params"]
    out = str(tmp_path / "port_ck")
    assert _export_module().main(["--config", "tiny", "--ckpt-dir", ck, "--out", out]) == 0
    params, step = load_params(out)
    assert step == 2 and "blocks.1.attn.wq.weight" in params
    jmodel = JaxLM(jax_config("tiny"))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(7), (2, 24), 0, 256))
    ref = np.asarray(jmodel.apply(unstack_lm_params(jmodel, jparams), jnp.asarray(tokens)))
    model, _ = load_model(TINY, out, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # the older layout: each stacked element one block, no "sub_0"
    legacy = {"params": dict(jparams["params"],
                             blocks_stacked=jparams["params"]["blocks_stacked"]["sub_0"])}
    monkeypatch.setattr(jax_generate, "load_params", lambda ckpt_dir, step=None: (legacy, 5))
    out2 = str(tmp_path / "legacy_ck")
    assert _export_module().export("unused", out2) == 5
    params2, _ = load_params(out2)
    assert params2.keys() == params.keys()
    for n, t in params.items():
        torch.testing.assert_close(params2[n], t, rtol=0, atol=0)
