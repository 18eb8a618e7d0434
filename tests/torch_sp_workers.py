"""Rank workers of the sequence-parallel tests: gloo process groups of CPU
ranks, started with ``torch.multiprocessing`` (spawn).

This module imports torch and the port only, never JAX, so the spawned
ranks do not start JAX (``tests/conftest.py`` sets it up for the test
process). ``run_ranks(world, fn, payload)`` starts ``world`` ranks, each
joining a gloo group on a free localhost port with the mesh of
``payload["mesh"]`` (a ``MeshConfig``; default sp over every rank) on
``payload["device"]`` (default the CPU; "cuda": the ranks share the card,
so the group is gloo too), calls
``fn(mesh, payload)`` in each and returns the ranks' results in rank order.
Every start has a deadline: a rank that raises fails the call at once with
its traceback, and ranks that do not finish in time (a collective some rank
never joined) are killed and the call fails, never hangs. A rank that
raises writes its report into the pipe before it tears down its process
group, so a peer that then fails on the closed group reports after it: the
first failure ``run_ranks`` reads is the rank that raised.
"""

from __future__ import annotations

import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, payload, out):
    try:
        from orion_tpu_torch.parallel.mesh import MeshConfig, init_distributed

        torch.set_num_threads(1)
        opts = payload if isinstance(payload, dict) else {}
        mesh = init_distributed(opts.get("mesh") or MeshConfig(dp=1, sp=world),
                                device=opts.get("device", "cpu"),
                                init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, local_rank=rank, local_world_size=world)
        out.put((rank, True, fn(mesh, payload)))
    except BaseException:  # noqa: BLE001 -- the traceback goes to the test
        out.put((rank, False, traceback.format_exc()))
        # flushed before the group goes down: a peer waiting in a collective
        # fails only then, so its report comes after this one
        out.close()
        out.join_thread()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, fn, payload, timeout: float = TIMEOUT_S):
    """``fn(mesh, payload)`` on ``world`` gloo CPU ranks -> their results in
    rank order. Raises on a rank's error or when ``timeout`` seconds pass."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn, payload, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                missing = sorted(set(range(world)) - set(results))
                dead = [r for r in missing if procs[r].exitcode is not None]
                if dead:
                    raise RuntimeError(f"ranks {dead} of {world} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {missing} of {world} did not finish in "
                                       f"{timeout:.0f} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def raise_on_rank_1(mesh, payload):
    """Rank 1 raises in its body; every other rank waits in a barrier that
    rank 1 never joins."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 raises before the barrier")
    dist.barrier()
    return mesh.rank


# ---------------------------------------------------------------------------
# The bodies and collectives
# ---------------------------------------------------------------------------


def _grads(mesh, case, inputs, cotangent):
    """One case on this rank's shard: (out shard, grad shards)."""
    from orion_tpu_torch.parallel import collectives, ring, sequence

    group = mesh.sp_group
    kind, opts = case["kind"], dict(case.get("opts", {}))
    if kind in ("ppermute", "prefix"):
        # x [n, ...]: rank r's row is its tensor
        x = torch.from_numpy(inputs[0][mesh.sp_rank]).requires_grad_()
        y = (collectives.ppermute_shift(x, group, **opts) if kind == "ppermute"
             else collectives.exclusive_prefix_sum(x, group))
        (y * torch.from_numpy(cotangent[mesh.sp_rank])).sum().backward()
        return y.detach().numpy(), [x.grad.numpy()]
    xs = [mesh.shard(torch.from_numpy(a), dim=2).contiguous().requires_grad_() for a in inputs]
    if kind == "linear":
        out = sequence.sp_linear_attention_local(*xs, group, **opts)
    elif kind == "ring":
        out = ring.ring_attention_local(*xs, group, **opts)
    elif kind == "halo":
        out = ring.swa_halo_attention_local(*xs, group, **opts)
    else:
        raise ValueError(kind)
    (out * mesh.shard(torch.from_numpy(cotangent), dim=2)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


def bodies(mesh, payload):
    """Every case of ``payload["cases"]`` on this rank -> {name: (out, grads)}."""
    return {case["name"]: _grads(mesh, case, payload["inputs"][case["inputs"]],
                                 payload["cotangents"][case["inputs"]])
            for case in payload["cases"]}


# ---------------------------------------------------------------------------
# The data-parallel collectives, and the trainer on any mesh
# ---------------------------------------------------------------------------


def remesh(mesh, cfg):
    """``mesh``'s process group with the groups of ``cfg`` (every rank
    calls, with the same ``cfg``)."""
    from orion_tpu_torch.parallel.mesh import init_distributed

    if cfg == mesh.cfg:
        return mesh
    return init_distributed(cfg, device="cpu", rank=mesh.rank, world_size=mesh.world,
                            local_rank=mesh.rank, local_world_size=mesh.world)


def collective_cases(mesh, payload):
    """``all_gather`` (dims 0 and 1), ``reduce_scatter`` and
    ``all_reduce_mean`` over each group of ``payload["groups"]`` (names of
    the mesh's group attributes), each forward and the gradient of sum(out
    * ct) with this rank's cotangent, on the mesh's device -> {group: (this
    rank's index in it, {case: (out, grad)}), "transport": the mesh's}."""
    from orion_tpu_torch.parallel import collectives as coll

    out = {"transport": mesh.transport}
    dev = mesh.device
    for name in payload["groups"]:
        group = getattr(mesh, name)
        me = dist.get_rank(group)
        res = {}
        for case, (key, fn) in {
            "gather0": ("x", lambda x, g: coll.all_gather(x, g, 0)),
            "gather1": ("x", lambda x, g: coll.all_gather(x, g, 1)),
            "mean": ("x", coll.all_reduce_mean),
            "scatter0": ("y", lambda x, g: coll.reduce_scatter(x, g, 0)),
            "scatter1": ("y", lambda x, g: coll.reduce_scatter(x, g, 1)),
        }.items():
            x = torch.from_numpy(payload[key][me]).to(dev).requires_grad_(case[:7] != "scatter")
            y = fn(x, group)
            assert y.device == x.device
            grad = None
            if x.requires_grad:
                ct = payload["ct_" + case][mesh.rank][tuple(slice(0, n) for n in y.shape)]
                (y * torch.from_numpy(ct).to(dev)).sum().backward()
                grad = x.grad.cpu().numpy()
            res[case] = (y.detach().cpu().numpy(), grad)
        out[name] = (me, res)
    return out


def mesh_runs(mesh, payload):
    """Each run of ``payload["runs"]`` on its own mesh of this process group
    (``run["mesh"]``, default the spawn's): the port's Trainer from ``run["tree"]`` (the JAX
    params tree) or from its seed, restored from ``run["ckpt"]`` at
    ``run["restore"]`` when given, then one step a batch of
    ``run["batches"]``, each followed by the trainer's save into
    ``run["ckpt"]`` (cadence ``run["save_every"]``) -> per run (losses,
    grad norms, the whole params by name as fp32 numpy, their dtypes)."""
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.training.checkpoint import Checkpointer
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    results = []
    for run in payload["runs"]:
        m = remesh(mesh, run.get("mesh", mesh.cfg))
        cfg = TrainConfig(model=run["model"], mesh=m.cfg, **{**payload["kw"], **run.get("kw", {})})
        tr = Trainer(cfg, device="cpu", mesh=m)
        if run.get("tree") is not None:
            tr.load_params(params_from_jax(run["tree"], cfg.model))
        ckpt = (Checkpointer(run["ckpt"], save_every=run.get("save_every", 0))
                if run.get("ckpt") else None)
        if run.get("restore") is not None:
            tr.restore(ckpt, run["restore"])
        losses, norms = [], []
        for b in run["batches"]:
            m_ = tr.step(torch.from_numpy(b).long())
            losses.append(m_["loss"])
            norms.append(m_["grad_norm"])
            if ckpt is not None:
                tr._save(ckpt, tr.step_count)
        whole = tr.whole_params()  # numpy: a tensor would travel as a handle to this process
        results.append((losses, norms, {n: t.float().numpy() for n, t in whole.items()},
                        {n: str(t.dtype) for n, t in whole.items()}))
    return results


def preempt_runs(mesh, payload):
    """Three ``train()`` runs on this mesh (dp over the spawn's ranks):
    uninterrupted into ``payload["dirs"][0]``; into ``dirs[1]`` with a
    SIGTERM raised on rank ``payload["signal_rank"]`` alone at step
    ``payload["at"]``'s boundary (a fault plan armed on that rank only);
    then resumed in ``dirs[1]`` -> (preempted_at and step of each run, the
    deliveries on this rank, the files of ``dirs[1]`` after the
    preempted run)."""
    import os

    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.train import train
    from orion_tpu_torch.training.trainer import TrainConfig

    def cfg(d):
        return TrainConfig(model=payload["model"], mesh=mesh.cfg, ckpt_dir=d, **payload["kw"])

    runs, delivered = [], []
    for d, at in ((payload["dirs"][0], None), (payload["dirs"][1], payload["at"]),
                  (payload["dirs"][1], None)):
        plan = inject.FaultPlan()
        if at is not None and mesh.rank == payload["signal_rank"]:
            plan.preempt_at(at)
        with inject.inject(plan):
            tr, _ = train(cfg(d), data="synthetic", device="cpu", mesh=mesh)
        runs.append((tr.preempted_at, tr.step_count))
        delivered += plan.delivered
        if at is not None:
            mesh.barrier()
            files = sorted(os.listdir(d))
    return runs, delivered, files


__all__ = ["run_ranks", "raise_on_rank_1", "bodies", "remesh", "collective_cases",
           "mesh_runs", "preempt_runs", "TIMEOUT_S"]
