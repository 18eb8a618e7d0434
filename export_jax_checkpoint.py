"""Export one step of a JAX package checkpoint as a checkpoint of the port.

    python export_jax_checkpoint.py --config tiny --ckpt-dir JAX_CKPT --out PORT_CKPT \
        [--step N] [--set KEY=VALUE ...]

Restores the params of one step of an ``orion_tpu`` training checkpoint
(orbax) with ``orion_tpu.generate.load_params``, which verifies them against
the step's integrity manifest (the newest intact step unless ``--step`` pins
one), fits the config to the stored tables with
``orion_tpu.generate.adapt_config_to_params``, maps the flax tree onto the
port's parameter names with ``orion_tpu_torch.convert.params_from_jax``, and
writes ``step-<N>.pt`` holding ``{"params": ..., "step": N}`` with its
manifest through the port's ``Checkpointer``. The port's one loader
(``orion_tpu_torch.generate.load_params``) then serves it, on a machine
without JAX:

    python -m orion_tpu_torch.generate --config tiny --ckpt-dir PORT_CKPT
    python -m orion_tpu_torch.evaluate --config tiny --ckpt-dir PORT_CKPT

``--set`` overrides the config as the JAX CLIs' ``--set`` does; it must
describe the model that was trained. A pipeline-layout checkpoint (stacked
per-stage blocks) is refused: unstacking it waits for the port's pipeline
(ROADMAP.md queue A, item 12). This script is the one file of the repo that
imports both packages; it runs JAX on the CPU.
"""

import argparse
import dataclasses
import sys


def export(ckpt_dir: str, out_dir: str, config: str = "tiny", step=None, overrides=()) -> int:
    """Export step ``step`` (default the newest intact one) of the JAX
    checkpoint in ``ckpt_dir`` into ``out_dir``; returns the step."""
    import jax
    import torch

    from orion_tpu.generate import adapt_config_to_params, load_params
    from orion_tpu.models.configs import get_config
    from orion_tpu.utils.config import apply_overrides, parse_set_overrides
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.models.configs import ModelConfig
    from orion_tpu_torch.training.checkpoint import Checkpointer

    params, step = load_params(ckpt_dir, step)
    if "blocks_stacked" in params.get("params", {}):
        raise ValueError(
            f"{ckpt_dir} step {step} holds a pipeline-layout tree (blocks_stacked); the port "
            "has no pipeline to unstack it yet (ROADMAP.md queue A, item 12)")
    cfg = get_config(config)
    if overrides:
        cfg = apply_overrides(cfg, parse_set_overrides(list(overrides)))
    cfg = adapt_config_to_params(cfg, params)
    # the port's copy of the same config (field for field, but the backend
    # names differ): params_from_jax checks every shape against it
    port_cfg = ModelConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                              if k != "backend"})
    state = params_from_jax(jax.device_get(params), port_cfg)
    ckpt = Checkpointer(out_dir, max_to_keep=1 << 30)
    if step in ckpt.all_steps():
        raise FileExistsError(f"{out_dir} already holds step {step}")
    ckpt.maybe_save(step, {"params": state, "step": torch.tensor(step, dtype=torch.int64)},
                    force=True)
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser("export_jax_checkpoint")
    p.add_argument("--config", default="tiny", help="named model config the checkpoint trained")
    p.add_argument("--ckpt-dir", required=True, help="the JAX package's checkpoint directory")
    p.add_argument("--out", required=True, help="the port's checkpoint directory to write")
    p.add_argument("--step", type=int, default=None, help="default: the newest intact step")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="ModelConfig override, as the model was trained")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    step = export(args.ckpt_dir, args.out, args.config, args.step, args.set)
    print(f"exported step {step} of {args.ckpt_dir} to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
