"""Rank workers of the mesh generate tests (``tests/test_torch_genmesh*.py``):
bodies that ``torch_sp_workers.run_ranks`` runs on gloo CPU ranks.

Like ``torch_sp_workers``, this module imports torch and the port only,
never JAX, so the spawned ranks do not start JAX. Every result crosses the
process boundary as numpy.
"""

from __future__ import annotations

import dataclasses

import torch

from torch_sp_workers import remesh


def _model(m, case):
    """The case's model on mesh ``m``: the JAX params ``case["tree"]`` (or
    the port's whole state dict ``case["state"]``) cut to this rank's
    shards, quantized on the mesh with ``case["quant"]``; or,
    with ``case["qtree"]``, the JAX package's quantized tree cut straight
    onto the quantized model."""
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.generate import quantize_for_decode
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = case["model"]
    if m.sp > 1:
        cfg = dataclasses.replace(cfg, sequence_parallel=True)
    quant = case.get("quant", "")
    if case.get("qtree") is not None:
        model = TransformerLM(cfg, device="cpu", mesh=m, quant=quant)
        model.load_state_dict(model.shard_state(params_from_jax(case["qtree"], cfg, quant)),
                              strict=True)
        return model
    model = TransformerLM(cfg, device="cpu", mesh=m)
    whole = (params_from_jax(case["tree"], cfg) if case.get("state") is None
             else {k: torch.from_numpy(v) for k, v in case["state"].items()})
    model.load_state_dict(model.shard_state(whole), strict=True)
    return quantize_for_decode(model, quant) if quant else model


def generate_case(mesh, case):
    """One case on the mesh ``case["mesh"]`` of the spawn's group -> a dict
    of numpy: this rank's (d, f, t, s) ``coords``; the prefill of the whole
    prompt (``logits`` of its last position, this rank's ``states``: its
    heads under tp, the whole sequence's under sp); ``greedy`` tokens of
    ``generate``; ``sampled`` tokens at ``case["sample"]`` and seed
    ``case["seed"]`` (when given); with ``case["buffers"]`` this rank's
    state dict."""
    from orion_tpu_torch.generate import SampleConfig, generate, prefill_prompt

    m = remesh(mesh, case["mesh"])
    model = _model(m, case)
    prompt = torch.from_numpy(case["prompt"]).long()
    with torch.inference_mode():
        logits, states = prefill_prompt(model, prompt)
    out = {"coords": m.coords, "logits": logits.float().numpy(),
           "states": [{k: v.float().numpy() for k, v in st.items()} for st in states],
           "greedy": generate(model, prompt, case["new"], SampleConfig(temperature=0.0)).numpy()}
    if case.get("buffers"):
        out["buffers"] = {k: v.numpy() for k, v in model.state_dict().items()}
    if case.get("sample"):
        out["sampled"] = generate(model, prompt, case["new"], SampleConfig(**case["sample"]),
                                  case["seed"]).numpy()
    return out


def generate_cases(mesh, payload):
    """``generate_case`` for each case of ``payload["cases"]``, in order
    (every rank builds every case's mesh, so the groups line up)."""
    return [generate_case(mesh, case) for case in payload["cases"]]


def refusals(mesh, payload):
    """What still refuses on a mesh, each caught on every rank -> {case: the
    exception's type and message, None where it ran}: a verify piece and a
    prefill piece of a sequence-parallel model. MoE layers under sp run (a
    prefill of a prompt's shard: "moe under sp" is None)."""
    from orion_tpu_torch.models.transformer import TransformerLM

    out = {}
    cfg = payload["model"]
    sp = dataclasses.replace(cfg, sequence_parallel=True)

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:  # noqa: BLE001 -- the message is the result
            out[name] = (type(e).__name__, str(e))

    def moe_prefill():
        moe = TransformerLM(dataclasses.replace(sp, n_experts=4, moe_period=2, moe_dropless=True),
                            device="cpu", mesh=mesh)
        with torch.inference_mode():
            logits, _ = moe.prefill_last(mesh.shard(torch.zeros(1, 8, dtype=torch.long)))
        assert bool(torch.isfinite(logits).all())

    catch("moe under sp", moe_prefill)
    model = TransformerLM(sp, device="cpu", mesh=mesh)
    prompt = torch.zeros(1, 8, dtype=torch.long)
    with torch.inference_mode():
        _, states = model.prefill_last(mesh.shard(prompt))
        catch("verify piece on sp", lambda: model.verify_step(prompt[:, :2], states,
                                                              torch.tensor([8])))
        catch("prefill piece on sp", lambda: model.prefill_extend_step(prompt[:, :4], states,
                                                                       8, 4))
    return out


__all__ = ["generate_case", "generate_cases", "refusals"]
