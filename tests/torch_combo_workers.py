"""Rank workers of the tests of the mesh combinations (``tests/test_torch_sp_moe.py``,
``tests/test_torch_mesh_dropout.py``, ``tests/test_torch_lra_mesh.py``):
bodies that ``torch_sp_workers.run_ranks`` runs on gloo CPU ranks.

Like ``torch_sp_workers``, this module imports torch and the port only,
never JAX, so the spawned ranks do not start JAX. Every result crosses the
process boundary as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch_sp_workers import mesh_runs, remesh


class MaskTap:
    """Within ``with tap:`` every dropout mask ``models/transformer.py``
    draws, recorded by its block key and site: ``masks[(seed, site)]`` is a
    list of (first global row, first global token, the mask as numpy bool)
    of each distinct draw; ``redraws`` counts the draws equal to an earlier
    one of the same key, position and shape (a recomputation's), ``differs``
    those that were not."""

    def __init__(self):
        from orion_tpu_torch.models import transformer

        self.mod, self.real = transformer, transformer.dropout_keep
        self.masks, self.redraws, self.differs = {}, 0, 0

    def keep(self, key, site, shape, rate, device=None):
        keep = self.real(key, site, shape, rate, device)
        got = keep.cpu().numpy()
        seen = self.masks.setdefault((key.seed, site), [])
        for row, token, mask in seen:
            if (row, token, mask.shape) == (key.row, key.token, got.shape):
                if np.array_equal(mask, got):
                    self.redraws += 1
                else:
                    self.differs += 1
                return keep
        seen.append((key.row, key.token, got))
        return keep

    def __enter__(self):
        self.mod.dropout_keep = self.keep
        return self

    def __exit__(self, *exc):
        self.mod.dropout_keep = self.real


def trainer_run(m, run, kw):
    """The port's Trainer of ``run["model"]`` on mesh ``m`` (one rank: no
    mesh), from ``run["tree"]`` (a JAX params tree) or the seed, one step a
    batch of ``run["batches"]`` under a ``MaskTap`` -> (losses, the whole
    params as fp32 numpy, the tap's masks, redraws and differing redraws)."""
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.training.trainer import MeshConfig, TrainConfig, Trainer

    cfg = TrainConfig(model=run["model"], mesh=m.cfg if m is not None else MeshConfig(dp=1),
                      **{**kw, **run.get("kw", {})})
    tr = Trainer(cfg, device="cpu", mesh=m)
    if run.get("tree") is not None:
        tr.load_params(params_from_jax(run["tree"], cfg.model))
    with MaskTap() as tap:
        losses = [tr.step(torch.from_numpy(b).long())["loss"] for b in run["batches"]]
    whole = tr.whole_params()
    return (losses, {n: t.float().numpy() for n, t in whole.items()}, tap.masks, tap.redraws,
            tap.differs)


def dropout_runs(mesh, payload):
    """Each run of ``payload["runs"]`` on its own mesh of the spawn's group
    (``trainer_run``) -> per run its result and this rank's coords."""
    out = []
    for run in payload["runs"]:
        m = remesh(mesh, run["mesh"])
        out.append((*trainer_run(m, run, payload["kw"]), m.coords, m.pp_rank))
    return out


def straddle(mesh, payload):
    """A capacity MoE whose groups straddle the sp shards: the Trainer's
    step -> the error's type and message (None if it ran)."""
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    tr = Trainer(TrainConfig(model=payload["model"], mesh=mesh.cfg, **payload["kw"]),
                 device="cpu", mesh=mesh)
    try:
        tr.step(torch.from_numpy(payload["batch"]).long())
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


def sp_moe(mesh, payload):
    """``mesh_runs`` of ``payload["runs"]``, then (when given) the capacity
    straddle on ``payload["straddle"]``'s mesh and the MoE generate cases of
    ``payload["generate"]`` (``moe_generate``)."""
    out = {"runs": mesh_runs(mesh, payload)}
    if payload.get("straddle"):
        st = payload["straddle"]
        out["straddle"] = straddle(remesh(mesh, st["mesh"]), st)
    if payload.get("generate"):
        out["generate"] = [moe_generate(mesh, case) for case in payload["generate"]]
    return out


def moe_generate(mesh, case):
    """``generate``'s greedy tokens of ``case["model"]`` (a MoE) from the
    JAX params ``case["tree"]`` on the mesh ``case["mesh"]`` (the model
    sequence-parallel under sp) -> numpy tokens."""
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.generate import SampleConfig, generate
    from orion_tpu_torch.models.transformer import TransformerLM

    m = remesh(mesh, case["mesh"])
    cfg = dataclasses.replace(case["model"], sequence_parallel=m.sp > 1)
    model = TransformerLM(cfg, device="cpu", mesh=m)
    model.load_state_dict(model.shard_state(params_from_jax(case["tree"], cfg)), strict=True)
    prompt = torch.from_numpy(case["prompt"]).long()
    return generate(model, prompt, case["new"], SampleConfig(temperature=0.0)).numpy()


class _Steps:
    """A logger that keeps each logged step's metrics."""

    def __init__(self):
        self.steps = {}

    def log(self, step, metrics, tokens_per_step=0):
        self.steps.setdefault(int(step), {}).update({k: float(v) for k, v in metrics.items()})


def _from_tree(tree):
    """``LRAClassifier`` whose params are the JAX tree ``tree``'s (each
    rank's cut of them) instead of the seed's draw: what ``train_lra`` builds
    while it stands in for the class."""
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.models.classifier import LRAClassifier
    from orion_tpu_torch.parallel.sharding import shard_whole

    class FromTree(LRAClassifier):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            whole = params_from_jax(tree, cfg, classifier=True)
            self.load_state_dict(shard_whole(whole, self.shard_axes), strict=True)

    return FromTree


def lra_runs(mesh, payload):
    """``train_lra`` of each run of ``payload["runs"]`` on its own mesh of
    the spawn's group, from the JAX params ``payload["tree"]`` -> per run
    (the logged metrics by step on rank 0, None on the others; the last
    metrics; the whole params as numpy)."""
    from orion_tpu_torch import train_lra as lra

    lra.LRAClassifier = _from_tree(payload["tree"])
    out = []
    for run in payload["runs"]:
        m = remesh(mesh, run["mesh"])
        cfg = dataclasses.replace(payload["cfg"], mesh=m.cfg)
        steps = _Steps()
        params, last = lra.train_lra(cfg, steps, device="cpu", mesh=m)
        out.append((steps.steps if m.is_main else None, last,
                    {n: t.numpy() for n, t in params.items()}))
    return out


__all__ = ["MaskTap", "trainer_run", "dropout_runs", "straddle", "sp_moe", "moe_generate",
           "lra_runs"]
