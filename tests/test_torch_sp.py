"""The sequence-parallel collectives and bodies held against the JAX
package's global functions, on the CPU.

Each world size (2 and 4) is started once: ``tests/torch_sp_workers.py``
spawns that many gloo ranks (processes that import torch and the port,
never JAX), each takes its contiguous shard of the same numpy-drawn global
inputs, runs every case and hands back its output shard and the gradients
of sum(out * w) for its shard of a numpy-drawn cotangent w. The JAX side
runs the global functions once, on the conftest's virtual CPU mesh at sp 4,
their gradients through ``jax.vjp`` under one jit: their global result
does not depend on the shard count, so both worlds are held against it
(the collectives, whose per-rank result does, run on a mesh of the world's
size). Cases:

- ``ppermute_shift`` (shift 1 and -1) and ``exclusive_prefix_sum`` under a
  shard_map;
- ``sp_linear_attention``: the two-pass form against the XLA form, the
  parts form against the Pallas form in interpret mode;
- ``ring_attention``: contiguous causal (rank 0 skips every block but its
  own: the skewed case, where a missing backward collective would hang the
  ranks into the deadline), bidirectional, windowed (W 6), striped, and
  the striped kernel form (flash blocks with ``shift``, the port's plain
  version) against the JAX striped Pallas form in interpret mode;
- ``swa_halo_attention``: W 6 (h = 1) and W 12 (h = 2 at world 4, where
  T_loc is 8; h is capped at 1 at world 2) against the JAX halo in
  interpret mode.

fp32 throughout; tolerance 2e-5 relative and absolute (sums in another
order, as ``tests/test_torch_flash_offsets.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_sp_workers as workers
from orion_tpu.parallel import collectives as jax_coll
from orion_tpu.parallel.mesh import MeshConfig, make_mesh
from orion_tpu.parallel.ring import ring_attention, swa_halo_attention
from orion_tpu.parallel.sequence import sp_linear_attention
from orion_tpu.utils.compat import shard_map

_TOL = dict(atol=2e-5, rtol=2e-5)
B, H, T, D = 1, 2, 32, 8

# (name, kind, inputs, port options, JAX function of (q, k, v, mesh))
CASES = [
    ("ppermute +1", "ppermute", "x", {"shift": 1}, None),
    ("ppermute -1", "ppermute", "x", {"shift": -1}, None),
    ("exclusive prefix", "prefix", "x", {}, None),
    ("linear two_pass", "linear", "phi", {"form": "two_pass", "backend": "torch", "chunk": 8},
     lambda q, k, v, m: sp_linear_attention(q, k, v, m, backend="xla", chunk=8)),
    ("linear parts", "linear", "phi", {"form": "parts", "backend": "torch", "chunk": 8},
     lambda q, k, v, m: sp_linear_attention(q, k, v, m, backend="pallas_interpret", chunk=8)),
    ("ring causal, rank 0 skips all but its own block", "ring", "qkv", {"causal": True},
     lambda q, k, v, m: ring_attention(q, k, v, m, causal=True)),
    ("ring bidirectional", "ring", "qkv", {"causal": False},
     lambda q, k, v, m: ring_attention(q, k, v, m, causal=False)),
    ("ring window 6", "ring", "qkv", {"causal": True, "window": 6},
     lambda q, k, v, m: ring_attention(q, k, v, m, causal=True, window=6)),
    ("ring striped", "ring", "qkv", {"striped": True, "kernel_blocks": False},
     lambda q, k, v, m: ring_attention(q, k, v, m, striped=True)),
    ("ring striped, flash blocks", "ring", "qkv", {"striped": True, "kernel_blocks": True},
     lambda q, k, v, m: ring_attention(q, k, v, m, striped=True, backend="pallas_interpret")),
    ("halo window 6", "halo", "qkv", {"window": 6},
     lambda q, k, v, m: swa_halo_attention(q, k, v, m, window=6, backend="pallas_interpret")),
    ("halo window 12", "halo", "qkv", {"window": 12},
     lambda q, k, v, m: swa_halo_attention(q, k, v, m, window=12, backend="pallas_interpret")),
]


def _inputs():
    rng = np.random.default_rng(20)
    draw = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    qkv = [draw(B, H, T, D) for _ in range(3)]
    phi = [np.abs(draw(B, H, T, D)) + 0.1 for _ in range(2)] + [draw(B, H, T, D)]
    return ({"x": [draw(4, 3, 5)], "qkv": qkv, "phi": phi},
            {"x": draw(4, 3, 5), "qkv": draw(B, H, T, D), "phi": draw(B, H, T, D)})


@functools.lru_cache(maxsize=None)
def _port(world):
    inputs, cts = _inputs()
    # the collectives take rank r's row of x: the first ``world`` rows
    inputs = dict(inputs, x=[inputs["x"][0][:world]])
    cts = dict(cts, x=cts["x"][:world])
    payload = {"inputs": inputs, "cotangents": cts,
               "cases": [{"name": n, "kind": k, "inputs": i, "opts": o}
                         for n, k, i, o, _ in CASES]}
    return workers.run_ranks(world, workers.bodies, payload)


@functools.lru_cache(maxsize=None)
def _jax(world, name):
    inputs, cts = _inputs()
    mesh = make_mesh(MeshConfig(dp=1, sp=world))
    _, kind, key, opts, fn = next(c for c in CASES if c[0] == name)
    if kind in ("ppermute", "prefix"):
        body = ((lambda x: jax_coll.ppermute_shift(x[0], "sp", opts["shift"])[None])
                if kind == "ppermute" else (lambda x: jax_coll.exclusive_prefix_sum(x[0], "sp")[None]))
        fn_ = shard_map(body, mesh=mesh, in_specs=P("sp"), out_specs=P("sp"), check_vma=False)
        x, ct = inputs["x"][0][:world], cts["x"][:world]
        out, vjp = jax.vjp(fn_, jnp.asarray(x))
        return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    @jax.jit
    def value_and_grads(q, k, v, ct):
        out, vjp = jax.vjp(lambda *a: fn(*a, mesh), q, k, v)
        return out, vjp(ct)

    out, grads = value_and_grads(*(jnp.asarray(x) for x in inputs[key]), jnp.asarray(cts[key]))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sp_body_matches_the_jax_global_function(world, name):
    ranks = [r[name] for r in _port(world)]
    kind = next(c[1] for c in CASES if c[0] == name)
    ref_out, ref_grads = _jax(world if kind in ("ppermute", "prefix") else 4, name)
    axis = 0 if kind in ("ppermute", "prefix") else 2
    if axis == 0:  # each rank's tensor is one row of the global [n, ...]
        out = np.stack([r[0] for r in ranks])
        grads = [np.stack([r[1][0] for r in ranks])]
    else:  # the shards of the sequence, in rank order
        out = np.concatenate([r[0] for r in ranks], axis=2)
        grads = [np.concatenate([r[1][i] for r in ranks], axis=2) for i in range(3)]
    np.testing.assert_allclose(out, ref_out, **_TOL, err_msg=f"{name}: out")
    for got, ref, what in zip(grads, ref_grads, ("dq", "dk", "dv")):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, **_TOL, err_msg=f"{name}: {what}")


def test_a_rank_that_raises_fails_the_start_and_ends_the_others():
    """A rank that never joins the collective its peers wait in: the start
    fails with that rank's traceback instead of hanging, and no rank
    outlives the call."""
    import multiprocessing

    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        workers.run_ranks(2, workers.raise_on_rank_1, {}, timeout=60)
    assert "rank 1 raises before the barrier" in str(err.value)
    assert not multiprocessing.active_children()
