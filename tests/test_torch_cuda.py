"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a card (decided inside the
fixture, never at import). On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: fp32 outputs to 1e-4 relative (sums in another order); bf16
outputs to one bf16 rounding step (2^-7 relative) plus 1e-4 absolute for
elements near zero, the limits of ``chip_smoke.py``; fp32 states to 1e-4 of
their largest magnitude.
"""

import pytest
import torch

from orion_tpu_torch.ops import linear_attention as la
from orion_tpu_torch.ops.kernels import causal_dot

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "dtype,bh,t,dk,dv,state",
    [
        (torch.float32, 3, 70, 32, 24, False),
        (torch.float32, 2, 129, 128, 200, True),
        (torch.bfloat16, 5, 1, 16, 64, True),
        (torch.bfloat16, 4, 333, 128, 128, True),
        (torch.bfloat16, 2, 64, 100, 72, False),
    ],
)
def test_causal_dot_norm_matches_plain(dev, dtype, bh, t, dk, dv, state):
    g = torch.Generator(device=dev).manual_seed(t)
    q = (torch.nn.functional.elu(torch.randn(bh, t, dk, device=dev, generator=g)) + 1).to(dtype)
    k = (torch.nn.functional.elu(torch.randn(bh, t, dk, device=dev, generator=g)) + 1).to(dtype)
    v = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    s0 = z0 = None
    if state:
        s0 = torch.randn(bh, dk, dv, device=dev, generator=g)
        z0 = torch.rand(bh, dk, device=dev, generator=g) * 10
    before = causal_dot.launches
    out, s, z = causal_dot.causal_dot_norm_cuda(q, k, v, s0, z0)
    assert causal_dot.launches == before + 1
    r_out, r_s, r_z = causal_dot.causal_dot_norm_plain(q, k, v, s0, z0)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), r_out.float(), rtol=2**-7, atol=1e-4)
    else:
        torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)
    for got, ref in ((s, r_s), (z, r_z)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_linear_attention_auto_uses_the_kernel(dev):
    q = torch.rand(2, 3, 50, 32, device=dev)
    before = causal_dot.launches
    out, (s, z) = la.linear_attention(q, q, q, return_state=True)
    assert causal_dot.launches == before + 1
    ref, (rs, rz) = la.linear_attention(q, q, q, return_state=True, backend="torch")
    assert causal_dot.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, rs, rtol=1e-4, atol=1e-3)


def test_kernel_rejects_what_it_does_not_take(dev):
    q = torch.rand(2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        causal_dot.causal_dot_norm_cuda(q.transpose(0, 1).contiguous().transpose(0, 1), q, q)
    with pytest.raises(TypeError):
        causal_dot.causal_dot_norm_cuda(q.half(), q.half(), q.half())
    big = torch.rand(1, 4, 256, device=dev)
    with pytest.raises(ValueError, match="Dk"):
        causal_dot.causal_dot_norm_cuda(big, big, big)
