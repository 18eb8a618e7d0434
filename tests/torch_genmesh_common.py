"""Shared pieces of the mesh generate tests against the JAX package
(``tests/test_torch_genmesh.py`` on 2 ranks, ``tests/test_torch_genmesh4.py``
on 4): the model, the prompt, the JAX references and the checks. The rank
bodies are in ``tests/torch_genmesh_workers.py``, which imports no JAX.

The model has every layer kind (linear, softmax, swa; fp32, two heads) and
the prompt is 4 x 6, so sp 4 right-pads it to 8 (the padded path). Each
case's checks:

- greedy tokens: every rank's equal the JAX ``generate(..., mesh=make_mesh(
  MeshConfig(...)))`` on the host's CPU devices at the same mesh (and that
  equals the JAX single-device run: the reference's own contract);
- the prefill: every rank's first-token logits within 1e-5 of the JAX
  prefill's, and its decode states within ``STATE_RTOL`` of each state's
  largest element (fp32; the shards' sums run in another order) of the JAX
  single-device states: the whole sequence's on an sp rank (the rotated
  keys and values gathered, the linear state summed over the ranks), this
  rank's heads under tp;
- sampled tokens (temperature 0.8, top-k 8) where the rows split over the
  data ranks: bitwise the port's one-rank run (each row draws with its
  global row's key; the port's counter keys draw other numbers than
  threefry, so a sampled token is held against the port).
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_genmesh_workers as gm_workers
import torch_sp_workers as workers
from orion_tpu.generate import SampleConfig as JaxSampleConfig
from orion_tpu.generate import generate as jax_generate
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig, make_mesh
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel.mesh import MeshConfig

GEN = dict(name="genmesh", vocab_size=64, d_model=32, n_layers=3, n_heads=2,
           layer_types=("linear", "softmax", "swa"), window=4, max_seq_len=64, dtype="float32")
NEW = 9
SAMPLE = dict(temperature=0.8, top_k=8)
SEED = 11
STATE_RTOL = 1e-5


def prompt():
    return np.array(jax.random.randint(jax.random.PRNGKey(3), (4, 6), 0, GEN["vocab_size"]))


@functools.lru_cache(maxsize=None)
def jax_model():
    """The JAX model and its params from seed 0."""
    jm = JaxLM(JaxModelConfig(**dict(GEN, backend="xla")))
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))


def jax_mesh(sizes):
    return make_mesh(JaxMeshConfig(**{"dp": 1, **sizes}))


@functools.lru_cache(maxsize=None)
def jax_prefill():
    """The JAX model's prefill of the prompt: (last logits, states), and its
    single-device greedy tokens."""
    jm, params = jax_model()
    p = jnp.asarray(prompt())
    logits, states = jax.jit(functools.partial(jm.apply, method="prefill"))(params, p)
    greedy = np.asarray(jax_generate(jm, params, p, NEW, JaxSampleConfig(temperature=0.0)))
    return np.asarray(logits)[:, -1], jax.device_get(states), greedy


def jax_meshed(sizes, quant=""):
    """The JAX greedy tokens at the mesh ``sizes`` (quantized with
    ``quant``)."""
    jm, params = jax_model()
    return np.asarray(jax_generate(jm, params, jnp.asarray(prompt()), NEW,
                                   JaxSampleConfig(temperature=0.0), mesh=jax_mesh(sizes),
                                   quant=quant))


def run_with_jax(world, cases, jax_work):
    """The ranks' ``generate_cases`` on ``world`` gloo ranks while
    ``jax_work()`` runs here -> (the ranks' results by case, in case order:
    a list of per-rank results each; ``jax_work``'s result)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(workers.run_ranks, world, gm_workers.generate_cases,
                          {"mesh": MeshConfig(dp=world), "cases": cases})
        ref = jax_work()
        got = fut.result()
    return [[got[r][i] for r in range(world)] for i in range(len(cases))], ref


def case(sizes, **kw):
    """A case of ``generate_case`` at the mesh ``sizes``."""
    return dict(model=ModelConfig(**GEN), tree=jax_model()[1], prompt=prompt(), new=NEW,
                mesh=MeshConfig(**{"dp": 1, **sizes}), **kw)


def heads(sizes, coords):
    """The heads [lo, hi) a rank of this mesh holds (tp cuts them)."""
    tp, h = sizes.get("tp", 1), GEN["n_heads"]
    t = coords[2]
    return t * h // tp, (t + 1) * h // tp


def check_greedy(ranks, meshed):
    """Every rank's greedy tokens are the JAX run's at the same mesh, which
    are the JAX single-device run's."""
    np.testing.assert_array_equal(meshed, jax_prefill()[2])
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["greedy"], meshed, err_msg=f"rank {r}")


def check_prefill(ranks, sizes):
    """Every rank's prefill logits and states against the JAX prefill's."""
    logits, states, _ = jax_prefill()
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["logits"], logits, rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")
        lo, hi = heads(sizes, res["coords"])
        assert len(res["states"]) == len(states)
        for i, (st, ref) in enumerate(zip(res["states"], states)):
            assert set(st) == set(ref)
            for key, got in st.items():
                want = np.asarray(ref[key])[:, lo:hi]
                assert got.shape == want.shape, (r, i, key, got.shape, want.shape)
                scale = max(float(np.abs(want).max()), 1.0)
                np.testing.assert_allclose(got, want, rtol=0, atol=STATE_RTOL * scale,
                                           err_msg=f"rank {r} layer {i} {key}")


def check_sampled(ranks):
    """Every rank's sampled tokens are bitwise the port's one-rank run's."""
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.generate import SampleConfig, generate
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = ModelConfig(**GEN)
    one = TransformerLM(cfg, device="cpu")
    one.load_state_dict(params_from_jax(jax_model()[1], cfg), strict=True)
    want = generate(one, torch.from_numpy(prompt()).long(), NEW, SampleConfig(**SAMPLE),
                    SEED).numpy()
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["sampled"], want, err_msg=f"rank {r}")


@functools.lru_cache(maxsize=None)
def jax_quantized(quant):
    """The JAX package's quantized tree of the model (``quantize_for_decode``)
    and its single-device greedy tokens."""
    from orion_tpu.generate import quantize_for_decode as jax_quantize

    jm, params = jax_model()
    qm, qparams = jax_quantize(jm, params, mode=quant)
    tokens = np.asarray(jax_generate(qm, qparams, jnp.asarray(prompt()), NEW,
                                     JaxSampleConfig(temperature=0.0)))
    return jax.device_get(qparams), tokens


def mesh_of(sizes, rank):
    """This rank's ``Mesh`` of ``sizes`` without a process group: enough to
    cut a state dict (``TransformerLM.shard_state`` reads the rules and the
    rank's coordinates only)."""
    from orion_tpu_torch.parallel.mesh import Mesh

    cfg = MeshConfig(**{"dp": 1, **sizes})
    world = cfg.dp * cfg.fsdp * cfg.tp * cfg.sp
    return Mesh(cfg, rank, world, torch.device("cpu"), "gloo", None)


def check_quantized_shards(ranks, sizes, quant):
    """Every rank's quantized buffers are bitwise the one-rank port model's
    quantization cut to that rank's shards: each leaf was quantized whole,
    then cut (a row-parallel scale whole, a column-parallel one sliced with
    its channels)."""
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.generate import quantize_for_decode
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = ModelConfig(**GEN)
    one = TransformerLM(cfg, device="cpu")
    one.load_state_dict(params_from_jax(jax_model()[1], cfg), strict=True)
    whole = quantize_for_decode(one, quant).state_dict()
    for r, res in enumerate(ranks):
        cut = TransformerLM(cfg, device="cpu", mesh=mesh_of(sizes, r), quant=quant).shard_state(
            whole)
        assert set(cut) == set(res["buffers"])
        for k, t in cut.items():
            np.testing.assert_array_equal(res["buffers"][k], t.numpy(), err_msg=f"rank {r} {k}")
