"""Row 14's variants on the CPU: which kernel the wrapper launches, its host
path, and the mma kernel's arithmetic emulated.

- ``q4_matmul_variant`` chooses from dtype, widths and alignment alone: "mma"
  for bf16 x with d % 8 == 0, out % 16 == 0 and 16-byte-aligned bases, "simt"
  for the rest.
- The host path (``q4_matmul_cuda``), with its library, stream and device
  stood in by fakes (this machine has no card): a weight is checked once and
  its plan made once; an in-place reload checks it again; a bad x, p or s
  after a good call on the same layer still raises with the checks'
  messages; the wrapper launches the variant the chooser names.
- The mma kernel's unpack (``csrc/q4_matmul.cu``: prmt, lop3 0x6A with the
  source's constants, a bf16x2 fma subtracting 136), emulated bit for bit
  on all 256 byte values at each byte of a word, equals ``unpack_nibbles``.
- Its sums: the cluster's K split (``mma_geometry``, the Python mirror of
  the source's geometry that ``test_q4_geometry_mirror_matches_the_library``
  in ``tests/test_torch_cuda.py`` holds to the library on the card: each
  rank a range of boxes of 64 packed rows, each warp a k16 slice of every
  box) emulated in
  fp32 on the unpacked weights, warps added in order, then ranks in order,
  times s, rounded once, against ``q4_matmul_torch`` and the JAX package's
  ``q4_matmul(..., interpret=True)`` within ``chip_smoke.Q4_RTOL`` /
  ``Q4_ATOL_OF_MAX``.

Inputs are drawn with numpy from a seed.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orion_tpu import quant as jq
from orion_tpu_torch.ops.kernels import q4_matmul as q4

BF16, FP32 = torch.bfloat16, torch.float32
SOURCE = q4.SOURCES["q4"].read_text()


def _aligned(shape, dtype, offset_bytes=0):
    """A contiguous tensor whose base lies ``offset_bytes`` past a 16-byte
    boundary."""
    es = torch.empty(0, dtype=dtype).element_size()
    n = int(np.prod(shape))
    flat = torch.zeros(n + 64 // es, dtype=dtype)
    skip = (-flat.data_ptr() % 16 + offset_bytes) // es
    t = flat[skip:skip + n].view(shape)
    assert t.data_ptr() % 16 == offset_bytes
    return t


@pytest.mark.parametrize(
    "dtype,b,d,out,x_off,p_off,want",
    [
        (BF16, 4, 2048, 2048, 0, 0, "mma"),  # lm_1b3's wq..wo at decode
        (BF16, 4, 2048, 5504, 0, 0, "mma"),  # gate / up
        (BF16, 4, 5504, 2048, 0, 0, "mma"),  # down
        (BF16, 64, 2048, 16, 0, 0, "mma"),  # the most rows, one 16-channel step
        (BF16, 1, 8, 16, 0, 0, "mma"),  # the least widths
        (BF16, 4, 2048, 200, 0, 0, "simt"),  # out % 16 != 0
        (BF16, 4, 2004, 2048, 0, 0, "simt"),  # d % 8 != 0: x's rows off 16 bytes
        (BF16, 4, 2048, 2048, 8, 0, "simt"),  # x's base 8 bytes off
        (BF16, 4, 2048, 2048, 0, 4, "simt"),  # p's base 4 bytes off
        (FP32, 4, 2048, 2048, 0, 0, "simt"),  # fp32 x: the tiny models
        (FP32, 2, 128, 384, 0, 0, "simt"),
    ],
)
def test_variant_chooser(dtype, b, d, out, x_off, p_off, want):
    x = _aligned((b, d), dtype, x_off)
    p = _aligned((d // 2, out), torch.int8, p_off)
    assert q4.q4_matmul_variant(x, p, torch.ones(out)) == want


# ---------------------------------------------------------------------------
# The host path, with fakes for what needs the card
# ---------------------------------------------------------------------------


class _FakeLibrary:
    """The library's four entry points: counts the calls and keeps each mma
    launch's early-start flag, writes nothing."""

    def __init__(self):
        self.calls = {"q4_plan": 0, "q4_matmul_mma": 0, "q4_matmul": 0}
        self.early = []

    def q4_plan_bytes(self):
        return 192

    def q4_plan(self, plan, p_ptr, kp, out):
        self.calls["q4_plan"] += 1
        return 0

    def q4_matmul_mma(self, plan, x, s, y, b, early, stream):
        self.calls["q4_matmul_mma"] += 1
        self.early.append(early)
        return 0

    def q4_matmul(self, x, p, s, y, b, d, out, is_bf16, vec, stream):
        self.calls["q4_matmul"] += 1
        return 0


def _check_launch_on_cpu(fn_name, acts, fp32s):
    """``library.check_launch`` with the CPU standing in for the card: its
    checks of devices, dtypes and contiguity, the same messages."""
    fp32s = [x for x in fp32s if x is not None]
    tensors = list(acts) + fp32s
    if any(x.device != tensors[0].device for x in tensors):
        raise ValueError("all inputs must lie on one device")
    dt = acts[0].dtype
    if dt not in (BF16, FP32) or any(x.dtype != dt for x in acts):
        raise TypeError(f"{fn_name}: the activations must share dtype bf16 or fp32; got "
                        f"{[x.dtype for x in acts]}")
    if any(x.dtype != FP32 for x in fp32s):
        raise TypeError(f"{fn_name}: states and row statistics must be float32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("inputs must be contiguous")


@pytest.fixture
def host(monkeypatch):
    """The wrapper on CPU tensors: a fake library, the CPU's device index,
    and a count of the full checks."""
    lib = _FakeLibrary()
    counts = {"checked": 0}
    real_checked = q4._checked

    def checked(x, p, s):
        counts["checked"] += 1
        return real_checked(x, p, s)

    monkeypatch.setattr(q4, "_library", lambda: lib)
    monkeypatch.setattr(q4, "check_launch", _check_launch_on_cpu)
    monkeypatch.setattr(q4, "_current_device", lambda: -1)
    monkeypatch.setattr(q4, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(q4, "_checked", checked)
    monkeypatch.setattr(q4, "_weights", {})
    return lib, counts


def _layer(rng, d=2048, out=2048):
    p = _aligned((d // 2, out), torch.int8)
    p.copy_(torch.from_numpy(rng.integers(-128, 128, (d // 2, out), dtype=np.int8)))
    s = torch.from_numpy(rng.random(out, dtype=np.float32) + 0.5)
    return p, s


def _x(rng, b=4, d=2048, dtype=BF16):
    x = _aligned((b, d), dtype)
    x.copy_(torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)))
    return x


def test_a_weight_is_checked_and_planned_once(host):
    """Checked and planned at the first call, which launches after the
    kernel ahead of it; the later calls launch early."""
    lib, counts = host
    rng = np.random.default_rng(0)
    p, s = _layer(rng)
    for _ in range(5):
        y = q4.q4_matmul_cuda(_x(rng), p, s)
        assert y.shape == (4, 2048) and y.dtype == BF16
    assert counts["checked"] == 1 and lib.calls == {"q4_plan": 1, "q4_matmul_mma": 5,
                                                    "q4_matmul": 0}
    assert lib.early == [0, 1, 1, 1, 1]


def test_an_in_place_reload_checks_again(host):
    """load_state_dict's copy_ bumps the version counter: the next call runs
    the full checks; the plan (pointer and shape unchanged) is made anew with
    the entry. A call on a changed weight never launches early: its bytes
    may be the output of the kernel ahead of it."""
    lib, counts = host
    rng = np.random.default_rng(1)
    p, s = _layer(rng)
    q4.q4_matmul_cuda(_x(rng), p, s)
    p.copy_(torch.from_numpy(rng.integers(-128, 128, tuple(p.shape), dtype=np.int8)))
    q4.q4_matmul_cuda(_x(rng), p, s)
    s.mul_(2.0)
    q4.q4_matmul_cuda(_x(rng), p, s)
    q4.q4_matmul_cuda(_x(rng), p, s)
    assert counts["checked"] == 3 and lib.calls["q4_plan"] == 3
    assert lib.early == [0, 0, 0, 1]


def test_a_new_scale_tensor_checks_again(host):
    _, counts = host
    rng = np.random.default_rng(2)
    p, s = _layer(rng)
    q4.q4_matmul_cuda(_x(rng), p, s)
    q4.q4_matmul_cuda(_x(rng), p, s.clone())
    assert counts["checked"] == 2


@pytest.mark.parametrize(
    "bad,exc,match",
    [
        ("x 3-D", ValueError, "takes x"),
        ("x of another width", ValueError, "packed kernel rows"),
        ("x of 65 rows", ValueError, "at most 64 rows"),
        ("x fp16", TypeError, "bf16 or fp32"),
        ("x not contiguous", ValueError, "contiguous"),
        ("x requires grad", RuntimeError, "carries no gradient"),
        ("p int16", TypeError, "int8"),
        ("p not contiguous", TypeError, "contiguous int8"),
        ("p of another shape", ValueError, "packed kernel rows"),
        ("s of another length", ValueError, "scale shape"),
        ("s fp64", TypeError, "float32"),
        ("s not contiguous", ValueError, "contiguous"),
    ],
)
def test_refusals_after_a_good_call(host, bad, exc, match):
    """A good call on the layer first, then one bad operand: the full checks
    run and raise as they always did; the layer's next good call works."""
    lib, _ = host
    rng = np.random.default_rng(3)
    p, s = _layer(rng)
    x = _x(rng)
    q4.q4_matmul_cuda(x, p, s)
    args = {"x": x, "p": p, "s": s}
    if bad == "x 3-D":
        args["x"] = x[None]
    elif bad == "x of another width":
        args["x"] = _x(rng, d=1024)
    elif bad == "x of 65 rows":
        args["x"] = _x(rng, b=65)
    elif bad == "x fp16":
        args["x"] = x.half()
    elif bad == "x not contiguous":
        args["x"] = _x(rng, b=2048, d=4).t()
    elif bad == "x requires grad":
        args["x"] = x.float().requires_grad_()
    elif bad == "p int16":
        args["p"] = p.short()
    elif bad == "p not contiguous":
        args["p"] = torch.zeros(2048, 1024, dtype=torch.int8).t()
    elif bad == "p of another shape":
        args["p"] = p[:512]
    elif bad == "s of another length":
        args["s"] = s[:100]
    elif bad == "s fp64":
        args["s"] = s.double()
    elif bad == "s not contiguous":
        args["s"] = torch.ones(2048, 2)[:, 0]
    with pytest.raises(exc, match=match):
        q4.q4_matmul_cuda(args["x"], args["p"], args["s"])
    before = lib.calls["q4_matmul_mma"]
    q4.q4_matmul_cuda(x, p, s)
    assert lib.calls["q4_matmul_mma"] == before + 1


@pytest.mark.parametrize(
    "dtype,d,out,x_off",
    [(BF16, 2048, 2048, 0), (BF16, 2048, 200, 0), (BF16, 2004, 2048, 0), (BF16, 2048, 2048, 8),
     (FP32, 2048, 2048, 0)],
)
def test_the_wrapper_launches_the_chosen_variant(host, dtype, d, out, x_off):
    lib, _ = host
    rng = np.random.default_rng(4)
    p, s = _layer(rng, d, out)
    x = _aligned((4, d), dtype, x_off)
    want = q4.q4_matmul_variant(x, p, s)
    counts = (q4.launches, q4.launches_mma, q4.launches_simt)
    q4.q4_matmul_cuda(x, p, s)
    assert (q4.launches, q4.launches_mma, q4.launches_simt) == (
        counts[0] + 1, counts[1] + (want == "mma"), counts[2] + (want == "simt"))
    assert lib.calls["q4_matmul_mma" if want == "mma" else "q4_matmul"] == 1


# ---------------------------------------------------------------------------
# The mma kernel's arithmetic
# ---------------------------------------------------------------------------


def _constant(name):
    m = re.search(rf"constexpr uint32_t {name} = (0x[0-9A-Fa-f]+)u;", SOURCE)
    assert m, name
    return int(m.group(1), 16)


def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode): byte i of the result is byte sel[i] of
    the eight bytes {b, a} (a's bytes 0-3, b's 4-7)."""
    pool = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _lop3(a, b, c, lut):
    """PTX lop3.b32: bit i of the result is bit (a_i b_i c_i) of the LUT,
    with a, b, c read as 0xF0, 0xCC, 0xAA."""
    return sum(((lut >> ((((a >> i) & 1) << 2) | (((b >> i) & 1) << 1) | ((c >> i) & 1))) & 1) << i
               for i in range(32))


def _bf16x2(word):
    halves = np.array([word & 0xFFFF, word >> 16], np.uint32) << 16
    return halves.view(np.float32)


def _unpack_pair(w, c):
    """The source's unpack_pair<c>(w, w >> 4) on the CPU, bit for bit up to
    the fma, whose two products and sums are exact: -> (low, high)."""
    lut = int(re.search(r'lop3\.b32 %0, %1, %2, %3, (0x[0-9A-Fa-f]+);', SOURCE).group(1), 16)
    assert "C | (C << 4) | ((4 + C) << 8) | ((4 + C) << 12)" in SOURCE
    sel = c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12)
    r = _lop3(_prmt(w, w >> 4, sel), _constant("M_NIBBLES"), _constant("M_MAGIC"), lut)
    return _bf16x2(r) * _bf16x2(_constant("M_ONE")) + _bf16x2(_constant("M_OFFSET"))


def test_the_bit_unpack_equals_unpack_nibbles_on_every_byte():
    """All 256 byte values at each of a word's four bytes (the other bytes
    random): the emulated unpack gives each byte's (low, high) nibble as
    ``unpack_nibbles`` does, as exact integers."""
    rng = np.random.default_rng(5)
    values = np.arange(256, dtype=np.uint8)
    lo, hi = q4.unpack_nibbles(torch.from_numpy(values.view(np.int8))[:, None])
    want = np.stack([lo[:, 0].numpy(), hi[:, 0].numpy()], 1).astype(np.float32)
    for c in range(4):
        got = []
        for v in range(256):
            other = int(rng.integers(0, 2**32, dtype=np.uint64))
            w = (other & ~(0xFF << (8 * c)) & 0xFFFFFFFF) | (v << (8 * c))
            got.append(_unpack_pair(w, c))
        np.testing.assert_array_equal(np.array(got), want, err_msg=f"byte {c}")


def _emulate_mma(x, p, s):
    """The mma kernel's sums on the CPU: the weights unpacked by the bit
    path, each warp's partial sum over its k16 slice of each box of its
    rank's range in fp32, warps added in order, then ranks in order (the
    cluster's inbox), times s, rounded once to x's dtype."""
    table = np.array([_unpack_pair(v, 0) for v in range(256)], np.float32)  # byte -> (lo, hi)
    pb = p.numpy().view(np.uint8)
    w = np.empty((2 * p.shape[0], p.shape[1]), np.float32)
    w[0::2], w[1::2] = table[pb, 0], table[pb, 1]
    w = torch.from_numpy(w)
    xf = x.float()
    kp, out = p.shape
    strips, cl, ranks = q4.mma_geometry(kp, out)
    y = torch.zeros(x.shape[0], out)
    for b0, b1 in ranks:
        block = torch.zeros(x.shape[0], out)
        for warp in range(q4.MMA_WARPS):
            rows = torch.tensor([r for box in range(b0, b1)
                                 for r in range(box * q4.MMA_BOX_ROWS + 8 * warp,
                                                box * q4.MMA_BOX_ROWS + 8 * warp + 8)
                                 if r < kp], dtype=torch.long)
            k = torch.stack([2 * rows, 2 * rows + 1], 1).reshape(-1)
            block = block + xf[:, k] @ w[k]
        y = y + block
    return (y * s).to(x.dtype), cl


@pytest.mark.parametrize("b,d,out,want_cl", [(4, 2000, 128, 8), (13, 1000, 192, 4), (1, 5504, 64, 8),
                                             (4, 128, 336, 1)])
def test_the_cluster_split_matches_torch_and_jax(b, d, out, want_cl):
    """Ragged K (1000 and 500 packed rows: a last box of 40 and 52), B 13 (two
    n-tiles), a strip of 16 channels, CL 1, 4 and 8."""
    rng = np.random.default_rng(b * d + out)
    x = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).bfloat16()
    p = torch.from_numpy(rng.integers(-128, 128, (d // 2, out), dtype=np.int8))
    s = torch.from_numpy((rng.random(out, dtype=np.float32) + 0.5) * 0.01)
    got, cl = _emulate_mma(x, p, s)
    assert cl == want_cl
    lim = chip_smoke.Q4_RTOL[BF16]
    jy = jq.q4_matmul(jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(p.numpy()),
                      jnp.asarray(s.numpy()), interpret=True)
    for ref in (q4.q4_matmul_torch(x, p, s), torch.from_numpy(np.array(jy.astype(jnp.float32)))):
        diff, r = (got.float() - ref.float()).abs(), ref.float().abs()
        over = float((diff / (chip_smoke.Q4_ATOL_OF_MAX * r.max() + lim * r)).max())
        assert over <= 1.0, over


def test_the_geometry_of_the_decode_shapes():
    """lm_1b3's decode shapes fill the card with two blocks an SM or more:
    wq..wo 32 strips x 8, gate / up 86 x 4, down 32 x 8 (43 boxes, five or
    six a rank)."""
    assert q4.mma_geometry(1024, 2048)[:2] == (32, 8)
    assert q4.mma_geometry(1024, 5504)[:2] == (86, 4)
    strips, cl, ranks = q4.mma_geometry(2752, 2048)
    assert (strips, cl) == (32, 8) and {b1 - b0 for b0, b1 in ranks} == {5, 6}
    assert ranks[0][0] == 0 and ranks[-1][1] == 43
