"""Rank workers of the tensor-parallel tests (``tests/test_torch_tp*.py``):
bodies that ``torch_sp_workers.run_ranks`` runs on gloo CPU ranks.

Like ``torch_sp_workers``, this module imports torch and the port only,
never JAX, so the spawned ranks do not start JAX. Every result crosses the
process boundary as numpy (a tensor would travel as a handle to the
sender's memory).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from torch_sp_workers import remesh

GROUPS = ("dp_group", "fsdp_group", "tp_group", "sp_group", "data_group", "shard_group",
          "replica_group")


def groups(mesh, payload):
    """For each ``MeshConfig`` of ``payload["meshes"]``: this rank's (d, f,
    t, s) and the global ranks of each of its groups (None: a group of one
    rank)."""
    out = []
    for cfg in payload["meshes"]:
        m = remesh(mesh, cfg)
        out.append((m.coords, {name: (None if getattr(m, name) is None
                                      else dist.get_process_group_ranks(getattr(m, name)))
                               for name in GROUPS}))
    return out


def collectives(mesh, payload):
    """``copy_to_tp`` and ``reduce_from_tp`` over the tp group, forward and
    the gradient of sum(out * ct), for each dtype of ``payload["dtypes"]``:
    rank r's input is ``payload["x"][t]`` (t its tp index), on the mesh's
    device -> {dtype: (copy out, copy grad, reduce out, reduce grad)} as
    fp32 numpy, and "devices": where the outputs and gradients lay."""
    from orion_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp

    t, dev = mesh.tp_rank, mesh.device
    out, where = {}, set()
    for name in payload["dtypes"]:
        dt = getattr(torch, name)
        res = []
        for fn in (copy_to_tp, reduce_from_tp):
            x = torch.from_numpy(payload["x"][t]).to(dev, dt).requires_grad_()
            y = fn(x, mesh.tp_group)
            (y.float() * torch.from_numpy(payload["ct"][t]).to(dev)).sum().backward()
            where |= {y.device.type, x.grad.device.type}
            res += [y.detach().float().cpu().numpy(), x.grad.float().cpu().numpy()]
        out[name] = tuple(res)
    out["devices"] = sorted(where)
    return out


def shard_round_trip(mesh, payload):
    """For each ``MeshConfig`` of ``payload["meshes"]``: a model of
    ``payload["model"]`` from the default seed on that mesh -> (whether
    cutting a one-rank model's state dict with ``shard_state`` gives this
    rank's params bitwise, the whole params gathered back over fsdp then tp
    as numpy, the local shapes)."""
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.parallel.sharding import gather_whole

    whole = TransformerLM(payload["model"], device="cpu").state_dict()
    out = []
    for cfg in payload["meshes"]:
        m = remesh(mesh, cfg)
        model = TransformerLM(payload["model"], device="cpu", mesh=m)
        mine = model.state_dict()
        cut = model.shard_state(whole)
        same = all(torch.equal(cut[n], mine[n]) for n in mine)
        back = gather_whole(mine, list(reversed(model.shard_axes)), keep=True)
        out.append((same, {n: t.numpy() for n, t in back.items()},
                    {n: tuple(t.shape) for n, t in mine.items()}))
    return out


def rules_and_groups(mesh, payload):
    """``groups``, ``collectives`` (on the spawn's mesh) and
    ``shard_round_trip`` (on ``payload["round_trip"]``) in one spawn."""
    return {"groups": groups(mesh, payload), "collectives": collectives(mesh, payload),
            "round_trip": shard_round_trip(mesh, dict(payload, meshes=payload["round_trip"]))}


def tp_generate_cases(mesh, payload):
    """``tp_generate`` for each case of ``payload["cases"]``."""
    return [tp_generate(mesh, case) for case in payload["cases"]]


def tp_generate(mesh, payload):
    """A model of ``payload["model"]`` on this tp mesh with the JAX params
    ``payload["tree"]`` -> (this rank's tp index, the prefill's logits and
    states of ``payload["prompt"]`` (this rank's heads), the greedy tokens
    of ``generate``, sampled tokens at ``payload["sample"]`` and seed
    ``payload["seed"]``) as numpy."""
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.generate import SampleConfig, generate
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = payload["model"]
    model = TransformerLM(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(model.shard_state(params_from_jax(payload["tree"], cfg)), strict=True)
    prompt = torch.from_numpy(payload["prompt"]).long()
    with torch.no_grad():
        logits, states = model.prefill(prompt)
    greedy = generate(model, prompt, payload["new"], SampleConfig(temperature=0.0))
    sampled = generate(model, prompt, payload["new"], SampleConfig(**payload["sample"]),
                       payload["seed"])
    return (mesh.tp_rank, logits.numpy(),
            [{k: v.float().numpy() for k, v in st.items()} for st in states],
            greedy.numpy(), sampled.numpy())


__all__ = ["groups", "collectives", "shard_round_trip", "rules_and_groups", "tp_generate",
           "tp_generate_cases", "GROUPS"]
