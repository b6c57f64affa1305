"""The tensor-core route of the port's flash attention, on the CPU: the rule
that picks it (``repro_torch.kernels.flash_attention.route``) and an emulation
of its kernel's arithmetic order (``csrc/flash_attention_sm90.cu``) held to the
JAX package's ``repro.kernels.ref.mha_reference``.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``). What the
emulation repeats, step by step in float32: KV tiles of the kernel's width at
the head dim (128 keys at D 64, 80 at D 256, 64 at the others), for each
64-row warpgroup of a 128-row q block; bf16 q.k accumulated in float32;
the scale with log2(e) folded in, applied to the float32 scores; the mask
after that scaling (-1e30 for keys the causal mask or the window removes,
-inf for keys past Sk, which the kernel's TMA loads as zero rows), on tiles
that can hold a masked key; on the others the max of the unscaled scores
times the scale and the scale fused into the exponent's argument (one
rounding, as the kernel's FFMA); the running max, exp2 and a running sum of
the unrounded p; p rounded to bf16 before the PV product;
``acc / max(l, 1e-30)`` in bf16; the causal skip of tiles wholly above each
64-row warpgroup's diagonal. Inputs are drawn with numpy from a seed; the tolerance is
the reference's bf16 one (``tests/test_flash_kernel.py:33``), 2e-2 as rtol and
atol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import mha_reference as jax_mha_reference
from repro_torch.kernels import flash_attention as fa

GROUP = 64                # q rows per warpgroup (its causal skip's granularity)


def tile_keys(D: int) -> int:
    """The kernel's keys per K/V tile at head dim D (its Layout<D>::kBKV)."""
    return {64: 128, 256: 80}.get(D, 64)


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
            for g0 in range(0, Sq, GROUP):
                rows = torch.arange(g0, min(g0 + GROUP, Sq))
                kv_end = min(Sk, min(g0 + GROUP, Sq)) if causal else Sk
                out[b, rows, h] = _group(qf[rows], kf, vf, rows, g0, kv_end, causal, window,
                                         scale_log2)
    return out


def _group(qg, kf, vf, rows, g0, kv_end, causal, window, scale_log2):
    """One consumer group's rows over the KV tiles up to kv_end."""
    Sk, D = kf.shape
    BKV = tile_keys(D)
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
    # head dim 80 (zamba2-2.7b's shared attention): ragged, Sq != Sk, a window
    (2, 333, 333, 4, 80, True, 0),
    (1, 64, 300, 2, 80, False, 0),
    (1, 200, 200, 2, 80, True, 64),
    # head dim 256: ragged over three 128-row blocks, Sq != Sk both ways, a
    # window over ragged tiles, and a bidirectional window with Sq > Sk whose
    # rows from 47 on have every key masked
    (2, 333, 333, 3, 256, True, 0),
    (1, 300, 170, 2, 256, True, 0),
    (1, 170, 300, 2, 256, False, 0),
    (1, 260, 260, 2, 256, True, 63),
    (1, 192, 40, 2, 256, False, 8),
    # head dims 16 and 32: ragged, Sq != Sk both ways, a window over ragged
    # tiles
    (2, 77, 77, 3, 16, True, 0),
    (1, 300, 170, 2, 32, True, 0),
    (1, 170, 300, 2, 16, False, 0),
    (1, 260, 260, 2, 32, True, 64),
]
# the edges of the kernel's KV tiles and 64-row warpgroups, at each head dim
# of the route: Sk one short of, at and one past a 64-key tile (and of two);
# at D 64 also at and around 128-key tiles; a window one short of, at and one
# past a tile; one 64-row causal diagonal; a bidirectional window with Sq > Sk
# whose rows from 47 on have every key masked
EDGE_CASES = [
    *[(1, 100, Sk, 2, D, False, 0) for Sk, D in ((63, 64), (64, 80), (65, 128), (127, 64), (129, 80))],
    *[(1, Sk, Sk, 2, D, True, 0) for Sk, D in ((63, 128), (64, 64), (65, 80), (127, 128), (129, 64))],
    *[(1, 150, Sk, 2, 64, causal, 0) for Sk, causal in ((128, False), (255, True), (257, False))],
    *[(1, 200, 200, 2, D, causal, w) for w, D, causal in ((63, 64, True), (64, 80, False),
                                                          (65, 128, True))],
    (2, 64, 64, 3, 128, True, 0),
    (1, 192, 40, 2, 64, False, 8),
    # D 256 (80-key tiles): Sk one short of and one past a tile and one past
    # two, Sq one past a 128-row block, a window of 81
    (1, 100, 79, 2, 256, False, 0), (1, 100, 81, 2, 256, False, 0), (1, 170, 161, 2, 256, False, 0),
    (1, 129, 129, 2, 256, True, 0), (1, 200, 200, 2, 256, True, 81),
    # D 16 and 32 (64-key tiles): Sk one short of, at and one past a tile
    # and one past two, causal and not; a window one short of, at and one
    # past a tile; a 64-row causal diagonal; a bidirectional window with Sq >
    # Sk whose rows from 47 on have every key masked
    *[(1, 100, Sk, 2, D, False, 0) for D in (16, 32) for Sk in (63, 64, 65, 129)],
    *[(1, Sk, Sk, 2, D, True, 0) for Sk, D in ((63, 32), (64, 16), (65, 32), (129, 16))],
    *[(1, 200, 200, 2, D, causal, w) for D in (16, 32)
      for w, causal in ((63, True), (64, False), (65, True))],
    *[(2, 64, 64, 3, D, True, 0) for D in (16, 32)],
    *[(1, 192, 40, 2, D, False, 8) for D in (16, 32)],
]


@pytest.mark.parametrize("case", CASES + EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
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
    for Sq, Sk, window, rows in ((128, 16, 8, (23, 64, 127)), (192, 40, 8, (47, 64, 191))):
        (q, k, v), _ = _inputs((1, Sq, 2, 64), (1, Sk, 2, 64), 31)
        got = emulate_sm90(q, k, v, causal=False, window=window)
        mean = v[0].float().mean(dim=0).to(torch.bfloat16)  # (H, D)
        for row in rows:
            torch.testing.assert_close(got[0, row].float(), mean.float(), rtol=TOL, atol=TOL)


def _bf16(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS[torch.bfloat16])
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


# (dtype, D) of aligned contiguous operands at the head dims no wgmma route
# of their dtype has: float32 at D 16 and 32 (bf16 at every head dim takes
# sm90: test_route_takes_sm90_for_aligned_bf16; float32 at D 256 sm90_tf32:
# test_route_takes_tf32_for_float32)
OTHER_HEAD_DIMS = [(torch.float32, 16), (torch.float32, 32)]


@pytest.mark.parametrize("dtype,D", OTHER_HEAD_DIMS,
                         ids=[f"{D}" if dt == torch.bfloat16 else f"float32-{D}"
                              for dt, D in OTHER_HEAD_DIMS])
def test_route_takes_tf32_for_other_head_dims(dtype, D):
    q, k, v = (_bf16((1, 40, 2, D), s).to(dtype) for s in range(3))
    assert fa.route(q, k, v) == "tf32"


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS[torch.float32])
def test_route_takes_tf32_for_float32(D):
    """float32 never takes sm90: aligned it takes sm90_tf32, and tf32 where a
    base pointer is off a 16-byte boundary or heads are broadcast."""
    q, k, v = (_bf16((1, 40, 2, D), s).float() for s in range(3))
    assert fa.route(q, k, v) == "sm90_tf32"
    off = _bf16(q.numel() + 1).float()[1:].view(q.shape)
    assert off.data_ptr() % 16 == 4 and fa.route(off, k, v) == "tf32"
    assert fa.route(q, k[:, :, :1].expand(1, 40, 2, D), v) == "tf32"


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS[torch.bfloat16])
def test_route_takes_tf32_for_what_tma_cannot_address(D):
    q, k, v = (_bf16((1, 40, 2, D), s) for s in range(3))
    # a base pointer 2 bytes off a 16-byte boundary
    off = _bf16(q.numel() + 1)[1:].view(q.shape)
    assert off.data_ptr() % 16 == 2
    assert fa.route(off, k, v) == fa.route(q, off, v) == fa.route(q, k, off) == "tf32"
    # an S stride of D + 1 elements (not a multiple of 16 bytes)
    odd = _bf16((1, 40, 2, D + 1))[..., :D]
    assert odd.data_ptr() % 16 == 0 and fa.route(odd, k, v) == "tf32"
    # heads broadcast with stride 0 (expand without a copy)
    bc = _bf16((1, 40, 1, D)).expand(1, 40, 2, D)
    assert fa.route(q, bc, v) == "tf32"
    # a last dim that is not contiguous
    assert fa.route(q, k, _bf16((1, 40, 2, 2 * D))[..., ::2]) == "tf32"


def test_route_is_a_pure_rule_and_counts_nothing_on_the_cpu():
    q, k, v = (_bf16((1, 40, 2, 128), s) for s in range(3))
    fa.reset_route_launches()
    assert fa.route(q, k, v) == fa.route(q, k, v) == "sm90"
    fa.flash_attention(q, k, v)  # the plain version: no kernel, no route count
    assert fa.route_launches() == {"sm90": 0, "sm90_tf32": 0, "tf32": 0}
