"""Shared pieces of the serving tests (``tests/test_torch_{chunked_decode,
prefill_extend,batched_decode,decode_caches,session}.py``): the in-scan
suite's tiny config with one layer of each kind (linear, softmax, swa of
window 4; linear chunk 4) in both packages, a flax parameter tree drawn
with numpy, and ``Slots``, a bare host of the port's slot programs for the
tests of the programs themselves (admission by a solo prefill and
``insert_decode_slot``, or staged for the in-scan pieces; each request's
tokens collected as its slot emits them); the engine-level contracts go
through ``serving.SlotEngine`` (``tests/test_torch_slot_engine.py``). The
programs hand back inference tensors, so the host writes into the carry
under ``torch.inference_mode``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orion_tpu.generate import SampleConfig as JaxSampleConfig
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu_torch import generate as gen
from orion_tpu_torch.convert import expected_params, load_jax_params
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.models.transformer import (TransformerLM, init_decode_state,
                                                insert_decode_slot)

_KW = dict(name="inscan_test", vocab_size=64, d_model=32, n_layers=3, n_heads=2,
           layer_types=("linear", "softmax", "swa"), window=4, max_seq_len=96,
           dtype="float32", chunk=4)
CFG = ModelConfig(**_KW)
JAX_CFG = JaxModelConfig(**_KW, backend="xla")
GREEDY = gen.SampleConfig(temperature=0.0)
SAMPLED = gen.SampleConfig(temperature=0.8, top_k=5, top_p=0.9, eos_token=3, pad_token=0)
# fp32 on both sides: logits and states agree to 1e-4 (tests/test_torch_model.py)
TOL = dict(rtol=1e-4, atol=1e-4)


def jax_sample(cfg):
    return JaxSampleConfig(cfg.temperature, cfg.top_k, cfg.top_p, cfg.eos_token, cfg.pad_token)


@functools.lru_cache(maxsize=None)
def tree(seed=0):
    """A flax param tree for CFG drawn with numpy at the flax init scales,
    norm scales around 1 so that they matter."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, (_, shape, transpose) in expected_params(CFG).items():
        shape = shape[::-1] if transpose else shape
        if path.endswith("scale"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            arr = rng.standard_normal(shape) / np.sqrt(shape[0] if transpose else shape[1])
        node = out
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": out}


def torch_model(seed=0):
    return load_jax_params(TransformerLM(CFG, device="cpu"), tree(seed))


def jax_model():
    return JaxLM(JAX_CFG)


def prompt(i, length):
    return np.random.default_rng(3000 + i).integers(0, CFG.vocab_size, (1, length))


def np_states(states):
    return [{k: np.asarray(v) for k, v in st.items()} for st in states]


def assert_states_close(got, ref, rows=None, lengths=None):
    """Per-layer states within TOL of the reference's largest magnitude:
    (S, z) whole, a softmax cache at its first ``lengths[b]`` positions, a
    swa ring at the slots of the last W positions before ``lengths[b]``;
    ``rows`` picks the batch rows of ``got`` to compare."""
    for lt, g, r in zip(CFG.layer_types, got, ref):
        for key in r:
            a = np.asarray(g[key].float()) if isinstance(g[key], torch.Tensor) else g[key]
            b = np.asarray(r[key])
            if rows is not None:
                a = a[rows]
            for i in range(b.shape[0]):
                x, y = a[i], b[i]
                if lengths is not None and lt != "linear":
                    n = lengths[i]
                    idx = (np.arange(n) if lt == "softmax" else
                           np.arange(max(0, n - CFG.window), n) % CFG.window)
                    x, y = x[:, idx], y[:, idx]
                scale = max(1.0, float(np.abs(y).max()))
                np.testing.assert_allclose(x, y, rtol=TOL["rtol"], atol=TOL["atol"] * scale,
                                           err_msg=f"{lt}.{key} row {i}")


def states_equal(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


class Slots:
    """The port's slot-multiplexed carry and a host that admits, stages and
    collects. ``admit`` prefills a request solo (``prefill_carry``) and
    inserts its row; ``stage`` parks a prompt for the in-scan pieces
    (``decode_batched_prefill_chunk``). Each request's tokens are the
    columns its slot emitted (``emit`` counts them)."""

    def __init__(self, model, n, sample, bucket=32):
        self.model, self.sample, self.n = model, sample, n
        z = torch.zeros(n, dtype=torch.long)
        states = init_decode_state(model.cfg, n, "cpu")
        self.carry = (z.clone(), states, z.clone(), z.clone(), torch.zeros(n, dtype=torch.bool))
        self.keys = torch.zeros(n, 2, dtype=torch.long)
        self.active = torch.zeros(n, dtype=torch.bool)
        self.pbuf = torch.zeros(n, bucket, dtype=torch.long)
        self.plen = z.clone()
        self.pfold = z.clone()
        self.owner = [None] * n
        self.want = {}
        self.got = {}

    @torch.inference_mode()
    def _set(self, j, token, t, done):
        tok, states, tt, emit, dn = self.carry
        tok[j], tt[j], emit[j], dn[j] = token, t, 0, done
        self.active[j] = True

    @torch.inference_mode()
    def admit(self, j, tag, tokens, seed, max_new):
        key = gen.request_keys(seed, 1)
        c = gen.prefill_carry(self.model, tokens, self.sample, key)
        insert_decode_slot(self.states, c[1], j)
        self._set(j, c[0][0], c[2], False)
        self.keys[j] = key[0]
        self.plen[j] = 0
        self._own(j, tag, max_new)

    @torch.inference_mode()
    def stage(self, j, tag, tokens, seed, max_new):
        tokens = torch.as_tensor(tokens).long()[0]
        zero = init_decode_state(self.model.cfg, 1, "cpu")
        insert_decode_slot(self.states, zero, j)
        self._set(j, 0, 0, False)
        self.keys[j] = gen.request_keys(seed, 1)[0]
        self.pbuf[j] = 0
        self.pbuf[j, :tokens.shape[0]] = tokens
        self.plen[j] = tokens.shape[0]
        self.pfold[j] = 0
        self._own(j, tag, max_new)

    def _own(self, j, tag, max_new):
        self.owner[j] = tag
        self.want[tag] = max_new
        self.got[tag] = []

    def free(self, j):
        self.active[j] = False
        self.owner[j] = None

    @torch.inference_mode()
    def chunk(self, n_steps, pchunk=0):
        before = self.carry[3].clone()
        if pchunk:
            self.carry, toks = gen.decode_batched_prefill_chunk(
                self.model, self.carry, self.keys, self.active, self.pbuf, self.plen,
                self.pfold, n_steps, pchunk, self.sample)
        else:
            self.carry, toks = gen.decode_batched_chunk(
                self.model, self.carry, self.keys, self.active, n_steps, self.sample)
        for j, tag in enumerate(self.owner):
            if tag is None:
                continue
            k = int(self.carry[3][j] - before[j])
            if k:
                self.got[tag].extend(toks[j, n_steps - k:].tolist())
            if len(self.got[tag]) >= self.want[tag]:
                self.got[tag] = self.got[tag][:self.want[tag]]
                self.free(j)
        return toks

    @property
    def states(self):
        """The carry's states: the caches are written in place, but a linear
        layer's (S, z) is new at every step."""
        return self.carry[1]

    @property
    def busy(self):
        return any(o is not None for o in self.owner)


def jax_params():
    return jax.tree.map(jnp.asarray, tree())
