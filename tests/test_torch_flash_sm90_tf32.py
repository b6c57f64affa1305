"""The float32 wgmma route of the port's flash attention, on the CPU: the rule
that picks it (``repro_torch.kernels.flash_attention.route``) and an emulation
of its kernel's arithmetic (``csrc/flash_attention_sm90_tf32.cu``) held to the
JAX package's ``repro.kernels.ref.mha_reference``.

The kernel itself runs only on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``'s phase 3). What the emulation repeats, step by step: q
blocks of 64 rows, each over the KV tiles up to its last row's diagonal, 64
keys a tile at D 64 and 32 at D 80, 128 and 256; every operand split once into hi
and lo: q and k as loaded are their own hi operands, which the tensor cores
truncate to TF32 (their top 19 bits), and lo = x - trunc(x) rounded to TF32
(to nearest, ties away: the kernel adds half a TF32 ulp and the tensor cores
drop the 13 low bits); p and v, which the kernel writes, take hi = x rounded
to TF32 and lo = x - hi rounded the same way; each product in three
passes into one accumulator, small passes first (a_lo.b_hi over every 8-deep
k-step, then a_hi.b_lo, then a_hi.b_hi), each k-step's 8 products added to
the accumulator and the sum truncated to float32 (rounded toward zero, the
tensor cores' float32 sums); at D 256 the scores summed so over each half of
the contraction (columns 0-127 and 128-255, one block of a cluster each) and
the two partials added in float32, rounded to nearest; the scale with log2(e) folded in, applied to the
float32 scores on tiles that can hold a masked key, then the mask (-1e30 for
keys the causal mask or the window removes, -inf past Sk), and fused into the
exponent's argument (one rounding, as the kernel's FFMA) on the others; the
running max, exp2 and a running sum of the unrounded p; P.V of each KV tile
from zero, joined to the output by one float32 FMA, ``acc * corr + pv``;
``acc / max(l, 1e-30)``. Inputs are drawn with numpy from a seed; the
tolerance is the reference's float32 one (``tests/test_flash_kernel.py:33``),
2e-5 as rtol and atol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FLASH_CASES
from repro.kernels.ref import mha_reference as jax_mha_reference
from repro_torch.kernels import flash_attention as fa

BQ = 64                    # the kernel's q rows per block (one consumer warpgroup)
LOG2E = 1.4426950408889634
TOL = 2e-5
CASES = [c for c in FLASH_CASES if c[4] in fa.WGMMA_HEAD_DIMS[torch.float32]]


def kv_tile(D: int) -> int:
    """The kernel's keys per K/V tile at head dim D (its Layout<D>::kBKV)."""
    return 64 if D == 64 else 32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: half a TF32 ulp added to the bits, the 13 low
    bits cleared (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 truncated to TF32: the 13 low bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo) of an operand the kernel writes (p, v): hi = rna(x), lo =
    rna(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_loaded(x: torch.Tensor):
    """(hi, lo) of an operand TMA loads (q, k): the tensor cores read x
    truncated, lo = rna(x - trunc(x))."""
    hi = tf32_trunc(x)
    return hi, tf32_rna(x - hi)


def to_f32_rz(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 rounded toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def product(a: torch.Tensor, b: torch.Tensor, splitter=split) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) the kernel's way, both operands split by
    ``splitter``: three passes into one accumulator, a_lo.b_hi, a_hi.b_lo,
    then a_hi.b_hi, each over the 8-deep k-steps in order; a k-step's
    products are exact and its sum with the accumulator is truncated to
    float32."""
    (ah, al), (bh, bl) = splitter(a), splitter(b)
    steps = a.shape[-1] // 8
    acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float64)
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        xs = x.double().unflatten(-1, (steps, 8)).movedim(-2, -3)
        per_step = xs @ y.double().unflatten(-2, (steps, 8))  # (..., steps, M, N)
        for kk in range(steps):
            acc = to_f32_rz(acc + per_step[..., kk, :, :]).double()
    return acc.float()


def scores(q: torch.Tensor, kt: torch.Tensor, first: int = 0) -> torch.Tensor:
    """S = q (..., M, D) @ kt (..., D, N) as the kernel sums it: at D 64, 80
    and 128 one :func:`product`; at D 256 a product over each half of the
    contraction (the partial of one block of the cluster each), the two
    added in float32 (rounded to nearest), half ``first`` on the left (block
    r adds the other block's partial to its own, r's on the left)."""
    D = q.shape[-1]
    if D != 256:
        return product(q, kt, split_loaded)
    h = D // 2
    part = [product(q[..., :h], kt[..., :h, :], split_loaded),
            product(q[..., h:], kt[..., h:, :], split_loaded)]
    return part[first] + part[1 - first]


def emulate_sm90_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
                      blocks=None, first: int = 0) -> torch.Tensor:
    """The sm90_tf32 kernel's arithmetic on float32 (B, Sq, H, D) q and
    (B, Sk, H, D) k, v, on the CPU; ``blocks`` limits it to those q blocks
    (their rows are returned, others are zero); ``first`` is the half of D
    whose partial scores stand on the left of the sum at D 256 (0 as block 0
    adds them, 1 as block 1 does). Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    BKV = kv_tile(D)
    scale_log2 = torch.tensor(LOG2E / np.sqrt(D), dtype=torch.float32)  # rounded once
    qf, kf, vf = (t.permute(0, 2, 1, 3) for t in (q, k, v))   # (B, H, S, D)
    out = torch.zeros((B, H, Sq, D), dtype=torch.float32)
    for q0 in (range(0, Sq, BQ) if blocks is None else [BQ * i for i in blocks]):
        rows = torch.arange(q0, min(q0 + BQ, Sq))
        kv_end = min(Sk, min(q0 + BQ, Sq)) if causal else Sk
        m = torch.full((B, H, len(rows)), -1e30)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), D))
        for k0 in range(0, kv_end, BKV):
            keys = torch.arange(k0, k0 + BKV)
            kt, vt = torch.zeros((B, H, BKV, D)), torch.zeros((B, H, BKV, D))
            n = min(BKV, Sk - k0)  # rows past Sk arrive as zeros
            kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
            s = scores(qf[:, :, rows], kt.transpose(-1, -2), first)
            edge = k0 + BKV > Sk or window > 0 or (causal and k0 + BKV - 1 > q0)
            if edge:
                s = s * scale_log2
                masked = torch.zeros((len(rows), BKV), dtype=torch.bool)
                if causal:
                    masked |= keys[None, :] > rows[:, None]
                if window:
                    masked |= keys[None, :] <= rows[:, None] - window
                s = s.masked_fill(masked, -1e30).masked_fill(keys[None, :] >= Sk, -torch.inf)
                m_new = torch.maximum(m, s.max(dim=-1).values)
                arg = s - m_new[..., None]
            else:
                m_new = torch.maximum(m, s.max(dim=-1).values * scale_log2)
                # s * scale - m rounded once, as the kernel's FFMA
                arg = (s.double() * scale_log2.double() - m_new[..., None].double()).float()
            corr = torch.exp2(m - m_new)
            p = torch.exp2(arg)
            l = l * corr + p.sum(dim=-1)
            pv = product(p, vt)
            # one float32 FMA: exact in float64, rounded once
            acc = (acc.double() * corr[..., None].double() + pv.double()).float()
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


def _inputs(shape_q, shape_k, seed):
    """float32 (torch q, k, v) and (jax q, k, v) from the same draws."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (shape_q, shape_k, shape_k)]
    return [torch.from_numpy(a) for a in arrs], [jnp.asarray(a) for a in arrs]


def _jax(jq, jk, jv, causal, window):
    return np.asarray(jax_mha_reference(jq, jk, jv, causal=causal, window=window), np.float32)


def test_cases_cover_every_head_dim_of_the_kernel():
    assert {c[4] for c in CASES} == set(fa.WGMMA_HEAD_DIMS[torch.float32]) == {64, 80, 128, 256}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_sm90_tf32_arithmetic_matches_jax_reference(case):
    B, Sq, Sk, H, D, causal, window = case
    (q, k, v), (jq, jk, jv) = _inputs((B, Sq, H, D), (B, Sk, H, D), 50)
    got = emulate_sm90_tf32(q, k, v, causal, window)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _jax(jq, jk, jv, causal, window), rtol=TOL, atol=TOL)


def test_emulated_sm90_tf32_long_causal_row_block():
    """The last 64-row block of a causal S 2032 prompt at D 128 (phase 7's
    prefill, one head): its rows sum P.V over 2032 keys in 64 tiles of 32,
    each joined to the output by one FMA, and stay inside 2e-5."""
    (q, k, v), (jq, jk, jv) = _inputs((1, 2032, 1, 128), (1, 2032, 1, 128), 51)
    last = (2032 - 1) // BQ
    got = emulate_sm90_tf32(q, k, v, True, 0, blocks=[last])[:, BQ * last:]
    want = _jax(jq, jk, jv, True, 0)[:, BQ * last:]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_d256_halves_add_to_the_same_scores_in_either_order():
    """At D 256 block 0 adds block 1's partial scores to its own and block 1
    block 0's to its own: float32 addition commutes, so both hold the same S
    bit for bit (here over partials of both signs and magnitudes across many
    binades, where the sum cancels and rounds), and so the same P, l and
    output, which the emulation shows with either half first."""
    rng = np.random.default_rng(54)
    scale = np.exp2(rng.integers(-12, 12, size=(1, 2, 64, 256))).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((1, 2, 64, 256)).astype(np.float32) * scale)
    kt = torch.from_numpy(rng.standard_normal((1, 2, 256, 32)).astype(np.float32))
    s0, s1 = scores(q, kt, first=0), scores(q, kt, first=1)
    assert torch.equal(s0.view(torch.int32), s1.view(torch.int32))
    (q, k, v), _ = _inputs((1, 150, 2, 256), (1, 150, 2, 256), 55)
    for causal, window in ((True, 0), (False, 40)):
        a = emulate_sm90_tf32(q, k, v, causal, window, first=0)
        b = emulate_sm90_tf32(q, k, v, causal, window, first=1)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_emulated_fully_masked_rows_average_v_uniformly():
    """-1e30 in the scaled units stays finite: a row whose keys are all
    masked weighs every key 1, and past-Sk zero rows weigh nothing."""
    for Sq, Sk, window, rows in ((128, 16, 8, (23, 64, 127)), (192, 40, 8, (47, 64, 191))):
        (q, k, v), _ = _inputs((1, Sq, 2, 64), (1, Sk, 2, 64), 52)
        got = emulate_sm90_tf32(q, k, v, causal=False, window=window)
        mean = v[0].mean(dim=0)  # (H, D)
        for row in rows:
            torch.testing.assert_close(got[0, row], mean, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("splitter", [split, split_loaded], ids=["written", "loaded"])
def test_split_parts_carry_about_22_bits(splitter):
    r = torch.from_numpy(np.random.default_rng(53).standard_normal(4096).astype(np.float32))
    hi, lo = splitter(r)
    assert (tf32_rna(hi) == hi).all() and (tf32_rna(lo) == lo).all()
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -21).all()


def test_truncated_sums_round_toward_zero():
    x = torch.tensor([1 + 2 ** -30, -(1 + 2 ** -30), 3.0, 1 - 2 ** -40], dtype=torch.float64)
    assert to_f32_rz(x).tolist() == [1.0, -1.0, 3.0, 1 - 2 ** -24]


def _f32(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS[torch.float32])
def test_route_takes_sm90_tf32_for_aligned_float32(D):
    q, k, v = (_f32((2, 33, 3, D), s) for s in range(3))
    assert all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    assert fa.route(q, k, v) == "sm90_tf32"
    # slices of one fused (B, S, 3H, D) projection: strided, still aligned
    qkv = _f32((2, 33, 9, D))
    assert fa.route(qkv[:, :, :3], qkv[:, :, 3:6], qkv[:, :, 6:]) == "sm90_tf32"
    # a dim of extent 1 is never stepped: its stride does not matter
    one = _f32((1, 1, 1, D + 4))[..., :D]
    assert one.stride() == (D + 4, D + 4, D + 4, 1) and fa.route(one, one, one) == "sm90_tf32"


@pytest.mark.parametrize("D", [16, 32])
def test_route_takes_tf32_for_float32_at_other_head_dims(D):
    q, k, v = (_f32((1, 40, 2, D), s) for s in range(3))
    assert fa.route(q, k, v) == "tf32"


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS[torch.float32])
def test_route_takes_tf32_for_float32_tma_cannot_address(D):
    q, k, v = (_f32((1, 40, 2, D), s) for s in range(3))
    # base pointers 4 and 8 bytes off a 16-byte boundary
    for off in (1, 2):
        moved = _f32(q.numel() + off)[off:].view(q.shape)
        assert moved.data_ptr() % 16 == 4 * off
        assert fa.route(moved, k, v) == fa.route(q, moved, v) == fa.route(q, k, moved) == "tf32"
    # an S stride of D + 1 floats (not a multiple of 16 bytes)
    odd = _f32((1, 40, 2, D + 1))[..., :D]
    assert odd.data_ptr() % 16 == 0 and fa.route(odd, k, v) == "tf32"
    # heads broadcast with stride 0 (expand without a copy)
    assert fa.route(q, _f32((1, 40, 1, D)).expand(1, 40, 2, D), v) == "tf32"
    # a last dim that is not contiguous
    assert fa.route(q, k, _f32((1, 40, 2, 2 * D))[..., ::2]) == "tf32"


def test_route_takes_tf32_for_mixed_dtypes():
    q = _f32((1, 40, 2, 128))
    assert fa.route(q, q, q.to(torch.bfloat16)) == "tf32"
