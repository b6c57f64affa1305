"""The tensor-core route of the port's flash attention, on the CPU: the rule
that picks it (``repro_torch.kernels.flash_attention.route``) and an emulation
of its kernel's arithmetic order (``csrc/flash_attention_sm90.cu``) held to the
JAX package's ``repro.kernels.ref.mha_reference``.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``). What the
emulation repeats, step by step in float32: KV tiles of the kernel's width,
for each 64-row group of a 128-row q tile; bf16 q.k accumulated in float32;
the scale with log2(e) folded in, applied to the float32 scores; the mask
after that scaling (-1e30 for keys the causal mask or the window removes,
-inf for keys past Sk, which the kernel's TMA loads as zero rows), on tiles
that can hold a masked key; on the others the max of the unscaled scores
times the scale and the scale fused into the exponent's argument (one
rounding, as the kernel's FFMA); the running max, exp2 and a running sum of
the unrounded p; p rounded to bf16 before the PV product;
``acc / max(l, 1e-30)`` in bf16; the causal skip of tiles above each 128-row
q tile's diagonal. Inputs are drawn with numpy from a seed; the tolerance is
the reference's bf16 one (``tests/test_flash_kernel.py:33``), 2e-2 as rtol and
atol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import mha_reference as jax_mha_reference
from repro_torch.kernels import flash_attention as fa

BQ, BKV = 128, 128        # the kernel's q rows per block and keys per K/V stage
GROUP = 64                # q rows per consumer warpgroup
LOG2E = 1.4426950408889634
TOL = 2e-2


def emulate_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 window: int) -> torch.Tensor:
    """The sm90 kernel's arithmetic on bf16 (B, Sq, H, D) q and (B, Sk, H, D)
    k, v, in float32 on the CPU. Returns bf16 (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale_log2 = torch.tensor(LOG2E / np.sqrt(D), dtype=torch.float32)  # rounded once
    out = torch.empty((B, Sq, H, D), dtype=torch.bfloat16)
    for b in range(B):
        for h in range(H):
            qf, kf, vf = (t[b, :, h].float() for t in (q, k, v))
            for q0 in range(0, Sq, BQ):
                kv_end = min(Sk, min(q0 + BQ, Sq)) if causal else Sk
                for g0 in range(q0, min(q0 + BQ, Sq), GROUP):
                    rows = torch.arange(g0, min(g0 + GROUP, Sq))
                    out[b, rows, h] = _group(qf[rows], kf, vf, rows, g0, kv_end, causal, window,
                                             scale_log2)
    return out


def _group(qg, kf, vf, rows, g0, kv_end, causal, window, scale_log2):
    """One consumer group's rows over the KV tiles up to kv_end."""
    Sk, D = kf.shape
    m = torch.full((len(rows),), -1e30)
    l = torch.zeros(len(rows))
    acc = torch.zeros((len(rows), D))
    for k0 in range(0, kv_end, BKV):
        keys = torch.arange(k0, k0 + BKV)
        # rows past Sk arrive as zeros
        kt, vt = torch.zeros((BKV, D)), torch.zeros((BKV, D))
        n = min(BKV, Sk - k0)
        kt[:n], vt[:n] = kf[k0:k0 + n], vf[k0:k0 + n]
        s = qg @ kt.T
        edge = k0 + BKV > Sk or window > 0 or (causal and k0 + BKV - 1 > g0)
        if edge:
            s = s * scale_log2
            masked = torch.zeros_like(s, dtype=torch.bool)
            if causal:
                masked |= keys[None, :] > rows[:, None]
            if window:
                masked |= keys[None, :] <= rows[:, None] - window
            s = s.masked_fill(masked, -1e30).masked_fill(keys[None, :] >= Sk, -torch.inf)
            m_new = torch.maximum(m, s.max(dim=1).values)
            arg = s - m_new[:, None]
        else:
            m_new = torch.maximum(m, s.max(dim=1).values * scale_log2)
            # s * scale - m rounded once: exact in float64, then to float32
            arg = (s.double() * scale_log2.double() - m_new[:, None].double()).float()
        corr = torch.exp2(m - m_new)
        p = torch.exp2(arg)
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[:, None]).to(torch.bfloat16)


def _inputs(shape_q, shape_k, seed):
    """bf16 (torch q, k, v) and (jax q, k, v) from the same float32 draws."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (shape_q, shape_k, shape_k)]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs])


CASES = [
    # (B, Sq, Sk, H, D, causal, window): tests/test_flash_kernel.py:12-19 first
    (2, 256, 256, 4, 128, True, 0),
    (1, 512, 512, 2, 128, False, 0),
    (2, 256, 256, 4, 128, True, 64),
    (1, 1024, 1024, 1, 128, True, 0),
    (1, 256, 256, 2, 256, True, 0),
    # ragged lengths, Sq != Sk both ways, a window over ragged tiles
    (2, 77, 77, 3, 64, True, 0),
    (1, 300, 170, 2, 64, True, 0),
    (1, 170, 300, 2, 128, False, 0),
    (1, 260, 260, 2, 64, True, 64),
    # bidirectional window with Sq > Sk: rows from 23 on have every key masked
    (1, 128, 16, 2, 64, False, 8),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_sm90_arithmetic_matches_jax_reference(case):
    B, Sq, Sk, H, D, causal, window = case
    (q, k, v), (jq, jk, jv) = _inputs((B, Sq, H, D), (B, Sk, H, D), 30)
    got = emulate_sm90(q, k, v, causal, window)
    assert torch.isfinite(got.float()).all()
    want = np.asarray(jax_mha_reference(jq, jk, jv, causal=causal, window=window), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=TOL)


def test_emulated_fully_masked_rows_average_v_uniformly():
    """-1e30 in the scaled units stays finite: a row whose keys are all
    masked weighs every key 1, and past-Sk zero rows weigh nothing."""
    (q, k, v), _ = _inputs((1, 128, 2, 64), (1, 16, 2, 64), 31)
    got = emulate_sm90(q, k, v, causal=False, window=8)
    mean = v[0].float().mean(dim=0).to(torch.bfloat16)  # (H, D)
    for row in (23, 64, 127):
        torch.testing.assert_close(got[0, row].float(), mean.float(), rtol=TOL, atol=TOL)


def _bf16(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("D", fa.SM90_HEAD_DIMS)
def test_route_takes_sm90_for_aligned_bf16(D):
    q, k, v = (_bf16((2, 33, 3, D), s) for s in range(3))
    assert all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    assert fa.route(q, k, v) == "sm90"
    # slices of one fused (B, S, 3H, D) projection: strided, still aligned
    qkv = _bf16((2, 33, 9, D))
    assert fa.route(qkv[:, :, :3], qkv[:, :, 3:6], qkv[:, :, 6:]) == "sm90"
    # a dim of extent 1 is never stepped: its stride does not matter
    one = _bf16((1, 1, 1, D + 8))[..., :D]
    assert one.stride() == (D + 8, D + 8, D + 8, 1) and fa.route(one, one, one) == "sm90"


@pytest.mark.parametrize("D", [16, 32, 256])
def test_route_takes_simt_for_other_head_dims(D):
    q, k, v = (_bf16((1, 40, 2, D), s) for s in range(3))
    assert fa.route(q, k, v) == "simt"


@pytest.mark.parametrize("D", fa.SM90_HEAD_DIMS)
def test_route_takes_simt_for_float32(D):
    q, k, v = (_bf16((1, 40, 2, D), s).float() for s in range(3))
    assert fa.route(q, k, v) == "simt"


@pytest.mark.parametrize("D", fa.SM90_HEAD_DIMS)
def test_route_takes_simt_for_what_tma_cannot_address(D):
    q, k, v = (_bf16((1, 40, 2, D), s) for s in range(3))
    # a base pointer 2 bytes off a 16-byte boundary
    off = _bf16(q.numel() + 1)[1:].view(q.shape)
    assert off.data_ptr() % 16 == 2
    assert fa.route(off, k, v) == fa.route(q, off, v) == fa.route(q, k, off) == "simt"
    # an S stride of D + 1 elements (not a multiple of 16 bytes)
    odd = _bf16((1, 40, 2, D + 1))[..., :D]
    assert odd.data_ptr() % 16 == 0 and fa.route(odd, k, v) == "simt"
    # heads broadcast with stride 0 (expand without a copy)
    bc = _bf16((1, 40, 1, D)).expand(1, 40, 2, D)
    assert fa.route(q, bc, v) == "simt"
    # a last dim that is not contiguous
    assert fa.route(q, k, _bf16((1, 40, 2, 2 * D))[..., ::2]) == "simt"


def test_route_is_a_pure_rule_and_counts_nothing_on_the_cpu():
    q, k, v = (_bf16((1, 40, 2, 128), s) for s in range(3))
    fa.reset_route_launches()
    assert fa.route(q, k, v) == fa.route(q, k, v) == "sm90"
    fa.flash_attention(q, k, v)  # the plain version: no kernel, no route count
    assert fa.route_launches() == {"sm90": 0, "simt": 0}
