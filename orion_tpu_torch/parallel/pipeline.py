"""Pipeline parallelism: the GPipe schedule over a ``pp`` group, the
counterpart of ``orion_tpu/parallel/pipeline.py``.

The JAX package writes the schedule as one SPMD ``lax.scan`` over
``n_micro + pp - 1`` steps: at step s stage i works on microbatch s - i when
that is in range and idles on zeros otherwise, activations hop i -> i + 1 by
``ppermute``, and autodiff through the scan gives the reverse schedule. The
port runs one process a rank, so each rank runs its own stage's part of the
same schedule explicitly (``gpipe``):

- forward, microbatch m = 0 .. n_micro - 1: stage 0 takes its input (the
  embedding of microbatch m), every later stage receives its neighbour's
  output as a leaf that needs a gradient; the stage runs its blocks, sends
  its output on (``collectives.send_to``) and keeps it; the last stage
  applies the head to it;
- backward, m = n_micro - 1 .. 0: the last stage starts from its head's
  loss, every earlier stage receives the gradient of its output, calls
  ``backward`` on it (and on the stage's auxiliary loss), and sends the
  gradient of its input back.

A stage computes nothing on an idle step (the JAX scan computes on zeros and
masks the result away: the same numbers). The parameter gradients of a stage
are the sums over its microbatches, as autodiff through the scan gives them.
The fraction of a step a stage idles is the bubble, ``bubble_fraction``:
(pp - 1) / (n_micro + pp - 1); n_micro >= 4 pp keeps it under about 20 %.

Within a phase data moves one way only, so no stage waits on a stage that
waits on it; every send is waited on before the phase ends. The collectives
inside a stage (tp's sums, fsdp's gathers, sp's exchanges, a MoE layer's
statistics) run over groups of that stage's ranks, which all walk the same
microbatches in the same order.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from orion_tpu_torch.parallel.collectives import recv_from, send_to

Tensor = torch.Tensor


def bubble_fraction(pp: int, n_micro: int) -> float:
    """The share of a GPipe step each stage idles: (pp - 1) / (n_micro + pp
    - 1)."""
    return (pp - 1) / (n_micro + pp - 1)


def gpipe(
    stage: Callable[[int, Tensor], Tuple[Tensor, Optional[Tensor]]],
    n_micro: int,
    *,
    group,
    pp_rank: int,
    pp: int,
    shape: Sequence[int],
    dtype: torch.dtype,
    device,
    first: Optional[Callable[[int], Tensor]] = None,
    last: Optional[Callable[[int, Tensor], Tensor]] = None,
    backward: bool = True,
    aux_weight: float = 1.0,
) -> Tuple[List[Tensor], List[Tensor]]:
    """This rank's stage of one GPipe step over ``n_micro`` microbatches.

    ``stage(m, h)`` runs the stage's blocks on microbatch m's activation h
    -> (its output, the stage's auxiliary loss or None); ``first(m)`` gives
    stage 0 its input; ``last(m, out)`` gives the last stage's result of
    microbatch m (with ``backward``: a scalar loss to start the backward
    from). ``shape`` / ``dtype``: the activation one microbatch carries
    between stages. With ``backward`` every stage runs its part of the
    reverse schedule, each microbatch's auxiliary loss weighted by
    ``aux_weight`` (its gradients accumulate in the parameters' ``.grad``).
    ``group``: the pp group (None with pp = 1).

    -> (the last stage's results, one a microbatch, empty elsewhere; each
    microbatch's weighted auxiliary loss on this stage, detached)."""
    is_first, is_last = pp_rank == 0, pp_rank == pp - 1
    kept, sends = [], []
    for m in range(n_micro):
        if is_first:
            h = first(m)
        else:
            h = recv_from(shape, dtype, device, group, pp_rank - 1)
            if backward:
                h.requires_grad_()
        out, aux = stage(m, h)
        res = None
        if is_last:
            res = last(m, out)
            out = None
        else:
            sends.append(send_to(out, group, pp_rank + 1))
        kept.append([h, out, aux, res])
    for s in sends:
        s.wait()
    results = [k[3].detach() if k[3] is not None and backward else k[3] for k in kept]
    auxes = [(k[2] * aux_weight).detach() for k in kept if k[2] is not None]
    if not backward:
        return (results if is_last else []), auxes
    sends = []
    for m in reversed(range(n_micro)):
        h, out, aux, res = kept[m]
        tensors, grads = [], []
        if is_last:
            tensors.append(res)
            grads.append(None)
        else:
            tensors.append(out)
            grads.append(recv_from(out.shape, out.dtype, device, group, pp_rank + 1))
        if aux is not None and aux.requires_grad:
            tensors.append(aux * aux_weight)
            grads.append(None)
        torch.autograd.backward(tensors, grads)
        if not is_first:
            sends.append(send_to(h.grad, group, pp_rank - 1))
        kept[m] = None  # this microbatch's activations go
    for s in sends:
        s.wait()
    return (results if is_last else []), auxes


__all__ = ["gpipe", "bubble_fraction"]
