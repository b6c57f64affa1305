"""The TF32 tensor-core route of the port's flash attention, on the CPU: an
emulation of its kernel's arithmetic (``csrc/flash_attention_tf32.cu``) held
to the JAX package's ``repro.kernels.ref.mha_reference``.

The kernel itself runs only on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``'s phase 3). What the emulation repeats, step by step in
float32: q tiles of 64 rows, each over the KV tiles up to its diagonal, of
the kernel's width for the dtype and head dim; every operand split when its
fragment forms, hi = x rounded to TF32 (to nearest, ties away, as
``cvt.rna.tf32.f32``) and lo = x - hi rounded the same way, and each product
taken in three passes summed over the 8-deep k-steps in order into three
accumulators (hi.hi into the first on even k-steps and the second on odd
ones, hi.lo and lo.hi into the third) and added as d0 + (d1 + d2) (bf16
operands take the hi.hi pass alone); the scale with log2(e) folded in,
applied to the float32 scores; the mask after it (-1e30 for keys the causal
mask or the window removes, -inf past Sk); the running max, exp2 and a
running sum of the unrounded p; p rounded to v's type before P.V; each KV
tile's P.V from zero, joined to the output by one float32 FMA,
``acc * corr + pv``; ``acc / max(l, 1e-30)`` in q's type. Inputs are drawn
with numpy from a seed; the tolerances are the reference's
(``tests/test_flash_kernel.py:33``), 2e-5 in float32 and 2e-2 in bf16, as
rtol and atol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FLASH_CASES
from repro.kernels.ref import mha_reference as jax_mha_reference

BQ = 64                    # the kernel's q rows per block
LOG2E = 1.4426950408889634
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def kv_tile(dtype, D: int) -> int:
    """Keys per KV tile, as the launcher picks them."""
    if D == 256 or (D >= 64 and dtype == torch.float32):
        return 32
    return 64


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits): to nearest, ties
    away from zero, by adding half a TF32 ulp to the bits and clearing the 13
    low ones (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, passes: int):
    """(hi, lo) TF32 operands of float32 x. Three passes split it; one pass
    hands it over whole, and the tensor cores read its top 19 bits (exact
    for bf16 values and p rounded to bf16; a float32 value is truncated)."""
    if passes == 1:
        return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32), None
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) the kernel's way, over 8-deep k-steps in
    order into three accumulators: hi.hi into the first on even k-steps and
    the second on odd ones, hi.lo and lo.hi into the third; then
    d0 + (d1 + d2)."""
    (ah, al), (bh, bl) = split(a, passes), split(b, passes)
    steps = a.shape[-1] // 8

    def per_step(x, y):  # (..., steps, M, N): each k-step's 8-term products
        xs = x.unflatten(-1, (steps, 8)).movedim(-2, -3)
        return xs @ y.unflatten(-2, (steps, 8))

    hh = per_step(ah, bh)
    hl, lh = (per_step(ah, bl), per_step(al, bh)) if passes == 3 else (None, None)
    d = [torch.zeros_like(hh[..., 0, :, :]) for _ in range(3)]
    for kk in range(steps):
        d[kk % 2] += hh[..., kk, :, :]
        if passes == 3:
            d[2] += hl[..., kk, :, :]
            d[2] += lh[..., kk, :, :]
    return d[0] + (d[1] + d[2])


def emulate_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
                 passes: int = 0) -> torch.Tensor:
    """The tf32 kernel's arithmetic on (B, Sq, H, D) q and (B, Sk, H, D) k, v
    in float32 or bf16, on the CPU; ``passes`` 0 takes the kernel's (3 for
    float32, 1 for bf16). Returns (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    passes = passes or (3 if q.dtype == torch.float32 else 1)
    BKV = kv_tile(q.dtype, D)
    scale_log2 = torch.tensor(LOG2E / np.sqrt(D), dtype=torch.float32)  # rounded once
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))   # (B, H, S, D)
    out = torch.empty((B, H, Sq, D), dtype=torch.float32)
    for q0 in range(0, Sq, BQ):
        rows = torch.arange(q0, min(q0 + BQ, Sq))
        kv_end = min(Sk, rows[-1].item() + 1) if causal else Sk
        m = torch.full((B, H, len(rows)), -1e30)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), D))
        for k0 in range(0, kv_end, BKV):
            keys = torch.arange(k0, k0 + BKV)
            kt, vt = torch.zeros((B, H, BKV, D)), torch.zeros((B, H, BKV, D))
            n = min(BKV, Sk - k0)  # rows past Sk arrive as zeros
            kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
            s = product(qf[:, :, rows], kt.transpose(-1, -2), passes) * scale_log2
            masked = torch.zeros((len(rows), BKV), dtype=torch.bool)
            if causal:
                masked |= keys[None, :] > rows[:, None]
            if window:
                masked |= keys[None, :] <= rows[:, None] - window
            s = s.masked_fill(masked, -1e30).masked_fill(keys[None, :] >= Sk, -torch.inf)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = product(p.to(v.dtype).float(), vt, passes)
            # one float32 FMA: exact in float64, rounded once
            acc = (acc.double() * corr[..., None].double() + pv.double()).float()
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _inputs(shape_q, shape_k, dtype, seed):
    """(torch q, k, v) and (jax q, k, v) from the same float32 draws."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (shape_q, shape_k, shape_k)]
    return ([torch.from_numpy(a).to(dtype) for a in arrs],
            [jnp.asarray(a).astype(JAX_DTYPE[dtype]) for a in arrs])


def _jax(jq, jk, jv, causal, window):
    return np.asarray(jax_mha_reference(jq, jk, jv, causal=causal, window=window), np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_tf32_arithmetic_matches_jax_reference(case, dtype):
    B, Sq, Sk, H, D, causal, window = case
    (q, k, v), (jq, jk, jv) = _inputs((B, Sq, H, D), (B, Sk, H, D), dtype, 40)
    got = emulate_tf32(q, k, v, causal, window)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), _jax(jq, jk, jv, causal, window),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_one_tf32_pass_misses_the_float32_tolerance():
    """Why float32 takes three passes: one TF32 pass keeps 11 significant
    bits of each operand, and at D 128 its error is far past 2e-5."""
    (q, k, v), (jq, jk, jv) = _inputs((1, 256, 2, 128), (1, 256, 2, 128), torch.float32, 41)
    want = _jax(jq, jk, jv, True, 0)
    err1 = np.abs(emulate_tf32(q, k, v, True, 0, passes=1).numpy() - want).max()
    err3 = np.abs(emulate_tf32(q, k, v, True, 0, passes=3).numpy() - want).max()
    assert err1 > 10 * TOL[torch.float32] and err3 < TOL[torch.float32]


@pytest.mark.parametrize("D", [16, 80, 256])
def test_bf16_one_pass_equals_three_passes_bit_for_bit(D):
    """A bf16 value and p rounded to bf16 are exact in TF32: their lo parts
    are zero, so the two extra passes add exact zeros."""
    (q, k, v), _ = _inputs((1, 100, 2, D), (1, 150, 2, D), torch.bfloat16, 42)
    for causal, window in ((True, 0), (False, 32)):
        one = emulate_tf32(q, k, v, causal, window, passes=1)
        three = emulate_tf32(q, k, v, causal, window, passes=3)
        assert torch.equal(one.view(torch.int16), three.view(torch.int16))


def test_tf32_split_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 1.0,
                      3.0e-39], dtype=torch.float32)
    # ties (2^-11 is half a TF32 ulp at 1) go away from zero; below half down
    want = torch.tensor([1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0, 1.0, 3.0e-39],
                        dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got[:5], want[:5]) and (got[5] - x[5]).abs() <= 2 ** -149 * 2 ** 13
    # hi + lo carries about 22 significant bits
    r = torch.from_numpy(np.random.default_rng(43).standard_normal(4096).astype(np.float32))
    hi, lo = split(r, 3)
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_emulated_fully_masked_rows_average_v_uniformly(dtype):
    """A bidirectional window with Sq > Sk: rows from 23 on see no key, score
    -1e30 everywhere and weigh every key 1; keys past Sk weigh nothing."""
    (q, k, v), _ = _inputs((1, 128, 2, 64), (1, 16, 2, 64), dtype, 44)
    got = emulate_tf32(q, k, v, causal=False, window=8)
    mean = v[0].float().mean(dim=0)  # (H, D)
    for row in (23, 64, 127):
        torch.testing.assert_close(got[0, row].float(), mean.to(dtype).float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 64, 100])
def test_emulated_window_over_ragged_tiles(dtype, window):
    """A sliding window whose edge falls inside and across KV tiles, causal,
    ragged Sq: the window masks with -1e30 and the first tiles of late rows
    are wholly masked before their keys arrive."""
    (q, k, v), (jq, jk, jv) = _inputs((2, 211, 3, 32), (2, 211, 3, 32), dtype, 45)
    got = emulate_tf32(q, k, v, True, window)
    np.testing.assert_allclose(got.float().numpy(), _jax(jq, jk, jv, True, window),
                               rtol=TOL[dtype], atol=TOL[dtype])
