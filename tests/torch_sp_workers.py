"""Rank workers of the sequence-parallel tests: gloo process groups of CPU
ranks, started with ``torch.multiprocessing`` (spawn).

This module imports torch and the port only, never JAX, so the spawned
ranks do not start JAX (``tests/conftest.py`` sets it up for the test
process). ``run_ranks(world, fn, payload)`` starts ``world`` ranks, each
joining a gloo group on a free localhost port, calls ``fn(mesh, payload)``
in each and returns the ranks' results in rank order. Every start has a
deadline: a rank that raises fails the call at once with its traceback,
and ranks that do not finish in time (a collective some rank never joined)
are killed and the call fails, never hangs.
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
        mesh = init_distributed(MeshConfig(dp=1, sp=world), device="cpu",
                                init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, local_rank=rank, local_world_size=world)
        out.put((rank, True, fn(mesh, payload)))
    except BaseException:  # noqa: BLE001 -- the traceback goes to the test
        out.put((rank, False, traceback.format_exc()))
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
# The trainer
# ---------------------------------------------------------------------------


def trainer_steps(mesh, payload):
    """For each run of ``payload["runs"]`` (a TrainConfig's model overrides
    and the numpy params tree): the port's Trainer on this rank from those
    params, ``len(batches)`` steps -> (losses, params by name)."""
    from orion_tpu_torch.convert import load_jax_params
    from orion_tpu_torch.training.trainer import MeshConfig, TrainConfig, Trainer

    results = []
    for run in payload["runs"]:
        cfg = TrainConfig(model=run["model"], mesh=MeshConfig(dp=1, sp=mesh.sp), **payload["kw"])
        tr = Trainer(cfg, device="cpu", mesh=mesh)
        load_jax_params(tr.model, run["tree"])
        losses = [tr.step(torch.from_numpy(b).long())["loss"] for b in payload["batches"]]
        results.append((losses, {n: p.detach().numpy().copy() for n, p in tr.params.items()}))
    return results


__all__ = ["run_ranks", "bodies", "trainer_steps", "TIMEOUT_S"]
