"""Which ops of a decode step depend on the batch a row sits in.

``row_variant_ops`` runs ``TransformerLM.decode_step`` on a batch of rows and
on one of those rows alone, records every aten op of the two runs but
the views (a ``TorchDispatchMode``; ``q4_matmul_cuda``, whose kernel writes outside the
dispatcher, as one op of its own) and pairs them in order. At each op it
compares the row in both runs: a tensor of the batch's rows (leading dim B
or B times something) by that row's slice, a tensor padded to
``DECODE_ROWS`` by the row's index, anything else whole. An op whose inputs
agree bitwise on the row but whose output does not is one whose result
depends on the batch -- a library that chooses its kernel or its reduction
order by the row count. Diagnostics for the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``) and the CPU tests; the serving path never
calls it.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from orion_tpu_torch.models import transformer
from orion_tpu_torch.models.transformer import snapshot_decode_state

_UNINITIALIZED = ("aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty")


def _tensors(tree) -> List[torch.Tensor]:
    return [a for a in tree_flatten(tree)[0] if isinstance(a, torch.Tensor)]


def _row_pair(a4, a1, b: int, r: int):
    """(row r of a4, from the b-row run; the same row of a1, from the
    one-row run), or None where the two hold no such rows or no floating
    values (indices and masks hold row numbers, which differ by design)."""
    if not a4.dtype.is_floating_point:
        return None
    if a4.shape == a1.shape:
        if a4.dim() and a4.shape[0] == transformer.DECODE_ROWS > r:
            return a4[r], a1[0]
        return a4, a1
    if a1.numel() and a4.numel() == b * a1.numel():
        return a4.reshape(b, -1)[r], a1.reshape(-1)
    return None


def _agree(pairs) -> bool:
    return all(torch.equal(x, y) for x, y in pairs)


def _gap(pairs) -> float:
    worst = 0.0
    for x, y in pairs:
        if not torch.equal(x, y):
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


class _Recorder(TorchDispatchMode):
    """Runs each op; in "record" mode keeps copies of its inputs (before
    the op: in-place ops move them) and outputs, in "compare" mode checks
    them against the recorded run's op at the same index."""

    def __init__(self, params, b: int = 1, r: int = 0, ref=None):
        super().__init__()
        self.params, self.b, self.r, self.ref = params, b, r, ref
        self.ops, self.inside = [], False

    def _keep(self, t):
        return t if t.data_ptr() in self.params else t.clone()

    def run(self, name, fn, ins):
        if self.ref is None:
            kept = [self._keep(a) for a in ins]
            out = fn()
            self.ops.append((name, kept, [self._keep(o) for o in _tensors(out)]))
            return out
        i = len(self.ops)
        if i >= len(self.ref) or self.ref[i][0] != name:
            self.ops.append({"op": name, "index": i, "misaligned": True})
            return fn()
        pairs_in = [p for a, c in zip(ins, self.ref[i][1])
                    if (p := _row_pair(a, c, self.b, self.r)) is not None]
        ins_equal = _agree(pairs_in)
        out = fn()
        pairs_out = [p for a, c in zip(_tensors(out), self.ref[i][2])
                     if (p := _row_pair(a, c, self.b, self.r)) is not None]
        self.ops.append({"op": name, "index": i, "ins_equal": ins_equal,
                         "out_equal": _agree(pairs_out), "gap": _gap(pairs_out),
                         "shapes": [list(a.shape) for a in ins][:3]})
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        # views compute nothing (and one-row indexing adds some)
        if self.inside or func.is_view or name.startswith(_UNINITIALIZED):
            return func(*args, **kwargs)
        return self.run(name, lambda: func(*args, **kwargs), _tensors((args, kwargs)))


@contextlib.contextmanager
def _q4_as_one_op(rec: _Recorder):
    from orion_tpu_torch.ops.kernels import q4_matmul as q4

    kernel = q4.q4_matmul_cuda

    def wrapped(x, p, s, *a, **kw):
        # called from the model, not from the dispatcher: the mode is on,
        # so the kernel's own ops and the recorder's are kept out by hand
        rec.inside = True
        try:
            return rec.run("q4_matmul_cuda", lambda: kernel(x, p, s, *a, **kw), [x, p, s])
        finally:
            rec.inside = False

    q4.q4_matmul_cuda = wrapped
    try:
        yield
    finally:
        q4.q4_matmul_cuda = kernel


@torch.inference_mode()
def row_variant_ops(model, token: torch.Tensor, states, t: torch.Tensor, row: int) -> dict:
    """One ``decode_step`` of the b-row batch (``token`` [b], ``states``,
    positions ``t`` [b], every row written) and of its row ``row`` alone,
    op by op. -> {"ops": count, "culprits": [the ops whose row differs
    though their row inputs agree], "first_differs": the first op whose row
    differs, "logits_equal", "states_equal", "misaligned": the op where the
    two runs' sequences part, or None}. The caller's states are not
    touched."""
    b = token.shape[0]
    params = {p.data_ptr() for p in model.parameters()} | {
        x.data_ptr() for x in model.buffers()}
    one = [{k: v[row:row + 1].clone() for k, v in st.items()} for st in states]
    token1, t1 = token[row:row + 1], t[row:row + 1]
    write1 = torch.ones(1, dtype=torch.bool, device=token.device)
    rec = _Recorder(params)
    with _q4_as_one_op(rec), rec:
        lg1, st1 = model.decode_step(token1, one, t1, write1)
    cmp = _Recorder(params, b, row, ref=rec.ops)
    write = torch.ones(b, dtype=torch.bool, device=token.device)
    copy = snapshot_decode_state(states)
    with _q4_as_one_op(cmp), cmp:
        lg, st = model.decode_step(token, copy, t, write)
    misaligned = next((o for o in cmp.ops if o.get("misaligned")), None)
    differs = [o for o in cmp.ops if not o.get("misaligned") and not o["out_equal"]]
    return {
        "ops": len(cmp.ops),
        "culprits": [o for o in differs if o["ins_equal"]],
        "first_differs": differs[0] if differs else None,
        "logits_equal": bool(torch.equal(lg[row], lg1[0])),
        "states_equal": all(torch.equal(x[k][row], y[k][0]) for x, y in zip(st, st1) for k in x),
        "misaligned": misaligned,
    }


__all__ = ["row_variant_ops"]
