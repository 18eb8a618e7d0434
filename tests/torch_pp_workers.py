"""Rank workers of the pipeline tests (``tests/test_torch_pp*.py``): bodies
that ``torch_sp_workers.run_ranks`` runs on gloo CPU ranks.

Like ``torch_sp_workers``, this module imports torch and the port only,
never JAX, so the spawned ranks do not start JAX. Every result crosses the
process boundary as numpy (a tensor would travel as a handle to the
sender's memory).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from torch_sp_workers import mesh_runs, remesh

GROUPS = ("dp_group", "fsdp_group", "tp_group", "sp_group", "pp_group", "data_group",
          "shard_group", "replica_group", "trunk_group", "trunk_shard_group")


def groups(mesh, payload):
    """For each ``MeshConfig`` of ``payload["meshes"]``: this rank's (d, f,
    t, s, p) and the global ranks of each of its groups (None: a group of one
    rank)."""
    out = []
    for cfg in payload["meshes"]:
        m = remesh(mesh, cfg)
        out.append(((*m.coords, m.pp_rank),
                    {name: (None if getattr(m, name) is None
                            else dist.get_process_group_ranks(getattr(m, name)))
                     for name in GROUPS}))
    return out


def _layer(params, h):
    """The JAX test's residual mini-block."""
    return h + torch.tanh(h @ params["w1"] + params["b1"]) @ params["w2"]


def schedule(mesh, payload):
    """For each case of ``payload["cases"]`` (its mesh, n_micro): this rank's
    stage (L / pp consecutive layers) through ``gpipe`` -> the last stage's
    output of ``payload["forward"]``'s layers and input, forward only; of
    ``payload["grad"]``'s, the loss sum(out^2) on the last stage, its
    gradient for each of this stage's layers by global index and for the
    input on stage 0; as numpy."""
    from orion_tpu_torch.parallel.pipeline import gpipe

    out = []
    for case in payload["cases"]:
        m = remesh(mesh, case["mesh"])
        pp, p, n, dev = m.pp, m.pp_rank, case["n_micro"], m.device
        res = {}
        for what, backward in (("forward", False), ("grad", True)):
            layers, x = payload[what]["layers"], payload[what]["x"]
            per = len(layers) // pp
            mine = {i: {k: torch.from_numpy(v).to(dev).requires_grad_()
                        for k, v in layers[i].items()}
                    for i in range(p * per, (p + 1) * per)}

            def stage(_, h, mine=mine):
                for lp in mine.values():
                    h = _layer(lp, h)
                return h, None

            x = torch.from_numpy(x).to(dev).requires_grad_()
            xs = x.reshape(n, x.shape[0] // n, *x.shape[1:])
            kw = dict(group=m.pp_group, pp_rank=p, pp=pp, shape=xs.shape[1:],
                      dtype=torch.float32, device=dev, first=lambda i, xs=xs: xs[i])
            if not backward:
                with torch.no_grad():
                    fwd, _ = gpipe(stage, n, last=lambda i, h: h, backward=False, **kw)
                res["out"] = torch.cat(fwd).cpu().numpy() if fwd else None
                res["devices"] = sorted({t.device.type for t in fwd})
                continue
            losses, _ = gpipe(stage, n, last=lambda i, h: (h ** 2).sum(), **kw)
            res.update(loss=float(sum(losses)) if losses else None,
                       grads={i: {k: t.grad.cpu().numpy() for k, t in lp.items()}
                              for i, lp in mine.items()},
                       x_grad=x.grad.cpu().numpy() if p == 0 else None)
        out.append(res)
    return out


def hop(mesh, payload):
    """Each rank of a pp 2 group sends its ``payload["x"][p]`` to the other
    stage and receives the other's at once, for each dtype of
    ``payload["dtypes"]``, on the mesh's device -> {dtype: (where the
    received tensor lies, its values as fp32 numpy)}."""
    from orion_tpu_torch.parallel.collectives import recv_from, send_to

    dev, p, out = mesh.device, mesh.pp_rank, {}
    for name in payload["dtypes"]:
        dt = getattr(torch, name)
        x = torch.from_numpy(payload["x"][p]).to(dev, dt)
        sent = send_to(x, mesh.pp_group, 1 - p)
        got = recv_from(x.shape, dt, dev, mesh.pp_group, 1 - p)
        sent.wait()
        out[name] = (got.device.type, got.float().cpu().numpy())
    return out


def hop_and_schedule(mesh, payload):
    return {"hop": hop(mesh, payload), "schedule": schedule(mesh, payload)}


def groups_and_schedule(mesh, payload):
    return {"groups": groups(mesh, payload), "schedule": schedule(mesh, payload)}


def lm_cases(mesh, payload):
    """For each case of ``payload["cases"]`` (model config, JAX params tree,
    tokens, n_micro, mesh; optional dropout seeds): a stage's
    ``TransformerLM`` on that mesh -> (the last stage's logits and the aux
    summed over the stages, forward only; the loss of ``pp_lm_loss`` summed
    over the pp group and the gradient of each param this stage holds (the
    leaves every stage holds summed over the stages); the losses at each
    dropout seed), as numpy."""
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.parallel.collectives import all_reduce_sum_
    from orion_tpu_torch.parallel.pipeline_lm import pp_lm_logits, pp_lm_loss

    out = []
    for case in payload["cases"]:
        m = remesh(mesh, case["mesh"])
        cfg = case["model"]
        model = TransformerLM(cfg, device="cpu", mesh=m)
        model.load_state_dict(model.shard_state(params_from_jax(case["tree"], cfg)), strict=True)
        tokens = torch.from_numpy(case["tokens"]).long()
        batch = torch.cat([tokens, tokens[:, :1]], 1)
        n = case["n_micro"]
        logits, aux = pp_lm_logits(model, tokens, n, return_aux=True)
        loss = pp_lm_loss(model, batch, n).reshape(1)
        all_reduce_sum_([loss], m.pp_group)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in model.named_parameters()}
        for k, g in grads.items():  # the leaves every stage holds: summed over the stages
            if not k.startswith("blocks."):
                all_reduce_sum_([g], m.pp_group)
        drops = []
        for seed in case.get("dropout_seeds", ()):
            for prm in model.parameters():
                prm.grad = None
            d = pp_lm_loss(model, batch, n, dropout_seed=seed).reshape(1)
            all_reduce_sum_([d], m.pp_group)
            drops.append(float(d))
        out.append({"logits": logits.numpy() if logits is not None else None,
                    "aux": float(aux), "loss": float(loss),
                    "grads": {k: g.numpy() for k, g in grads.items()}, "drops": drops})
    return out


def trainer_runs(mesh, payload):
    """``torch_sp_workers.mesh_runs`` (the Trainer from the JAX params, one
    step a batch, the whole params after), and for each run the Trainer's
    ``pp_n_micro`` and ``pp_full_manual`` and its ``evaluate`` on
    ``run["eval"]`` batches when given."""
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    res = mesh_runs(mesh, payload)
    extra = []
    for run in payload["runs"]:
        m = remesh(mesh, run.get("mesh", mesh.cfg))
        cfg = TrainConfig(model=run["model"], mesh=m.cfg, **{**payload["kw"], **run.get("kw", {})})
        tr = Trainer(cfg, device="cpu", mesh=m)
        if run.get("tree") is not None:
            tr.load_params(params_from_jax(run["tree"], cfg.model))
        ev = None
        if run.get("eval") is not None:
            ev = tr.evaluate(iter([torch.from_numpy(b).long() for b in run["eval"]]),
                             len(run["eval"]))
        extra.append({"n_micro": tr.pp_n_micro, "full_manual": tr.pp_full_manual, "eval": ev,
                      "blocks": sorted({int(k.split(".")[1]) for k in tr.params
                                        if k.startswith("blocks.")})})
    return [(*r, e) for r, e in zip(res, extra)]


def restore_and_evaluate(mesh, payload):
    """A Trainer of ``payload["cfg"]`` on this mesh restored from the
    checkpoint in ``payload["ckpt"]`` -> (its step, its ``evaluate`` of
    ``payload["batches"]``, its whole params as numpy)."""
    from orion_tpu_torch.training.checkpoint import Checkpointer
    from orion_tpu_torch.training.trainer import Trainer

    tr = Trainer(payload["cfg"], device="cpu", mesh=mesh)
    step = tr.restore(Checkpointer(payload["ckpt"]))
    ev = tr.evaluate(iter([torch.from_numpy(b).long() for b in payload["batches"]]),
                     len(payload["batches"]))
    return step, ev, {n: t.numpy() for n, t in tr.whole_params().items()}


__all__ = ["groups", "schedule", "hop", "hop_and_schedule", "groups_and_schedule", "lm_cases",
           "trainer_runs",
           "restore_and_evaluate", "GROUPS"]
