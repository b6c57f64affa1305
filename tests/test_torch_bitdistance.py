"""The port's bit distance against the JAX package: ``ops.hamming_total`` /
``ops.bit_distance`` and ``bitx_xor.xor`` (plain path on the CPU) against the
Pallas kernels in interpret mode and numpy, and the Monte-Carlo threshold
calibration against ``repro.core.bitdistance``.

Inputs are made with numpy from a seed. Integer bit counts are exact, so the
kernel comparisons are exact equality. The calibration draws its random
numbers from another generator than jax's, so its estimates are held to the
reference within 5 Monte-Carlo standard errors of the difference of two
independent means; its deterministic core (rounding and counting the same
float32 draws) is held to the reference's float32 mean within 1e-6 relative
and to the reference's integer count exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as stt

from repro.core import bitdistance as jbd
from repro.kernels import bitx_xor as jbitx
from repro.kernels import hamming as jham
from repro.kernels import ops as jops
from repro_torch.core import bitdistance as bd
from repro_torch.kernels import _build, bitx_xor, hamming, ops, ref

# the lengths of tests/test_torch_kernels.py: the 2-D tiles of
# tests/test_kernels.py flattened, plus awkward lengths
LENGTHS = [1 * 1024, 4 * 1024, 256 * 1024, 3 * 2048, 257 * 1024, 0, 1, 1023, 1025]
SHAPES = [(1, 1024), (4, 1024), (256, 1024), (3, 2048), (257, 1024)]  # tests/test_kernels.py:15

MC_N = 20_000
SIGMA_W, SIGMA_D = (0.01, 0.015, 0.02, 0.03, 0.04, 0.05), (0.0005, 0.001, 0.002, 0.005, 0.01, 0.02)
CORNERS = [(sw, sd) for sw in (SIGMA_W[0], SIGMA_W[-1]) for sd in (SIGMA_D[0], SIGMA_D[-1])]


def _bits(n, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max, n, dtype=dtype, endpoint=True)


def _np_total(a, b):
    return int(np.bitwise_count(np.bitwise_xor(a, b)).astype(np.uint64).sum())


# ---------------------------------------------------------------------------
# hamming and xor against the Pallas kernels (interpret mode) and numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("n", LENGTHS)
def test_hamming_matches_jax_pallas_and_numpy(n, dtype):
    a, b = _bits(n, dtype, 11), _bits(n, dtype, 12)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    before = _build.launch_counts()
    got = ops.hamming_total(ta, tb)
    assert isinstance(got, int)
    assert got == _np_total(a, b)
    assert got == jops.hamming_total(ja, jb, use_pallas=True)
    a2, _ = jops._pack_2d(ja)
    b2, _ = jops._pack_2d(jb)
    assert got == jham.hamming_total_2d(a2, b2, block_rows=jops._block_rows(a2.shape[0]),
                                        interpret=True)
    assert ops.bit_distance(ta, tb) == jops.bit_distance(ja, jb, use_pallas=True)
    # CPU tensors take the plain versions: nothing is launched
    assert _build.launch_counts() == before


@pytest.mark.parametrize("dtype", [np.uint8, np.uint64])
def test_hamming_one_and_eight_byte_words_match_numpy(dtype):
    """Widths the Pallas path does not cover, against the numpy host path."""
    for n in (0, 1, 1023, 1025, 4099):
        a, b = _bits(n, dtype, 13), _bits(n, dtype, 14)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        assert ops.hamming_total(ta, tb) == _np_total(a, b) == bd.hamming_total_arrays(a, b)
        assert ops.bit_distance(ta, tb) == bd.bit_distance_arrays(a, b)
        partials = hamming.hamming_partials(torch.from_numpy(a.view(np.uint8)),
                                            torch.from_numpy(b.view(np.uint8)), a.itemsize)
        assert partials.dtype == torch.int64 and partials.tolist() == [_np_total(a, b)]


@pytest.mark.parametrize("shape", [(7,), (33, 5), (2, 3, 129)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_float_bit_distance_matches_jax(shape, dtype):
    """Float tensors ride their bit views: bf16 -> u16, f32 -> u32."""
    rng = np.random.default_rng(15)
    base32 = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    ft32 = base32 + (rng.standard_normal(shape) * 0.005).astype(np.float32)
    jbase, jft = jnp.asarray(base32).astype(dtype), jnp.asarray(ft32).astype(dtype)
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    tbase = torch.from_numpy(np.array(jops.to_bit_view(jbase))).view(tdt)
    tft = torch.from_numpy(np.array(jops.to_bit_view(jft))).view(tdt)
    assert ops.hamming_total(tbase, tft) == jops.hamming_total(jbase, jft, use_pallas=True)
    assert ops.bit_distance(tbase, tft) == jops.bit_distance(jbase, jft, use_pallas=True)


def test_bit_distance_rejects_mismatched_operands():
    x = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops.hamming_total(x, torch.zeros(9, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ops.bit_distance(x, torch.zeros(8, dtype=torch.float32))
    with pytest.raises(ValueError):
        ops.hamming_total(torch.zeros(8, dtype=torch.int16), torch.zeros(8, dtype=torch.int16))
    with pytest.raises(ValueError):
        hamming.hamming_total(torch.zeros(8, dtype=torch.uint8), torch.zeros(4, dtype=torch.uint8), 2)
    with pytest.raises(ValueError):
        bitx_xor.xor(torch.zeros(6, dtype=torch.uint8), torch.zeros(6, dtype=torch.uint8), 4)
    assert ops.bit_distance(torch.empty(0), torch.empty(0)) == 0.0


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("shape", SHAPES)
def test_xor_matches_jax_xor_2d(shape, dtype):
    a, b = _bits(shape[0] * shape[1], dtype, 16), _bits(shape[0] * shape[1], dtype, 17)
    ta, tb = torch.from_numpy(a.view(np.uint8)), torch.from_numpy(b.view(np.uint8))
    got = bitx_xor.xor(ta, tb, a.itemsize)
    assert got.dtype == torch.uint8 and got.shape == ta.shape
    rows = shape[0]
    want = jbitx.xor_2d(jnp.asarray(a.reshape(shape)), jnp.asarray(b.reshape(shape)),
                        block_rows=256 if rows % 256 == 0 else rows, interpret=True)
    np.testing.assert_array_equal(got.numpy().view(dtype).reshape(shape), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().view(dtype), np.bitwise_xor(a, b))
    assert torch.equal(got, ref.xor_words(ta, tb))


@settings(max_examples=20, deadline=None)
@given(stt.integers(1, 5000), stt.integers(0, 2**32 - 1))
def test_property_hamming_symmetry_and_identity(n, seed):
    rng = np.random.RandomState(seed % 2**31)
    a = rng.randint(0, 2**16, n).astype(np.uint16)
    b = rng.randint(0, 2**16, n).astype(np.uint16)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert ops.hamming_total(ta, ta) == 0
    assert ops.hamming_total(ta, tb) == ops.hamming_total(tb, ta) == bd.hamming_total_arrays(a, b)
    assert ops.bit_distance(ta, tb) <= 16.0


# ---------------------------------------------------------------------------
# Monte-Carlo calibration against repro.core.bitdistance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("sigma_w,sigma_delta", CORNERS)
def test_deterministic_core_matches_reference(sigma_w, sigma_delta, dtype):
    """The same float32 w and δ through the port's helper and through the
    reference's lines (src/repro/core/bitdistance.py:118-126) in jnp."""
    rng = np.random.default_rng(18)
    w = rng.standard_normal(MC_N).astype(np.float32) * np.float32(sigma_w)
    d = rng.standard_normal(MC_N).astype(np.float32) * np.float32(sigma_delta)
    got = bd.rounded_bit_distance(torch.from_numpy(w), torch.from_numpy(d), dtype)

    jw, jd = jnp.asarray(w), jnp.asarray(d)
    wt, ft = jw.astype(dtype), (jw + jd).astype(dtype)
    u = jnp.uint16 if jnp.dtype(dtype).itemsize == 2 else jnp.uint32
    bits = jax.lax.population_count(jnp.bitwise_xor(jax.lax.bitcast_convert_type(wt, u),
                                                    jax.lax.bitcast_convert_type(ft, u)))
    want = float(jnp.mean(bits.astype(jnp.float32)))
    assert want > 0
    assert abs(got - want) <= 1e-6 * want
    # and the rounding is the same element by element: the counts agree exactly
    assert round(got * MC_N) == int(np.asarray(bits).astype(np.int64).sum())


def _port_bits(sigma_w, sigma_delta, n, seed, dtype="bfloat16"):
    """Per-element differing bits of the port's draws, counted with numpy."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.randn(n, generator=gen, dtype=torch.float32) * sigma_w
    d = torch.randn(n, generator=gen, dtype=torch.float32) * sigma_delta
    target = getattr(torch, dtype)
    # numpy has no bf16: cross as bytes, count on the unsigned words
    wb = w.to(target).view(torch.uint8).numpy().view(np.uint8)
    fb = (w + d).to(target).view(torch.uint8).numpy().view(np.uint8)
    words = np.bitwise_count(np.bitwise_xor(wb, fb)).reshape(n, -1)
    return words.sum(axis=1).astype(np.float64)


def _five_se(bits):
    """5 standard errors of the difference of two independent means of n
    draws each, from the per-element variance."""
    return 5.0 * np.sqrt(2.0 * bits.var(ddof=1) / bits.size)


@pytest.mark.parametrize("sigma_w,sigma_delta", CORNERS + [(0.015, 0.02)])
def test_mc_estimate_agrees_with_reference(sigma_w, sigma_delta):
    got = bd.expected_bit_distance_mc(sigma_w, sigma_delta, n=MC_N, device="cpu")
    bits = _port_bits(sigma_w, sigma_delta, MC_N, seed=0)
    assert got == pytest.approx(bits.mean(), rel=1e-12)  # seeding as documented
    want = jbd.expected_bit_distance_mc(sigma_w, sigma_delta, n=MC_N)
    assert abs(got - want) <= _five_se(bits)


def test_mc_calibration_within_family_band():
    """The band checks of tests/test_core_storage.py:163-177 on the port."""
    lo = bd.expected_bit_distance_mc(0.05, 0.0005, n=MC_N, device="cpu")
    hi = bd.expected_bit_distance_mc(0.015, 0.02, n=MC_N, device="cpu")
    assert 0.5 <= lo <= 6.0
    assert 2.5 <= hi <= 7.0
    # cross-family (independent draws) clearly exceeds the threshold of 4
    gen = torch.Generator(device="cpu").manual_seed(0)
    w1 = (torch.randn(MC_N, generator=gen) * 0.02).to(torch.bfloat16)
    w2 = (torch.randn(MC_N, generator=gen) * 0.02).to(torch.bfloat16)
    assert ops.bit_distance(w1, w2) > 4.5


def test_calibration_heatmap_matches_reference():
    n = 5_000
    got = bd.calibration_heatmap(n=n, device="cpu")
    want = jbd.calibration_heatmap(n=n)
    assert got.sigma_w_grid == want.sigma_w_grid == list(SIGMA_W)
    assert got.sigma_delta_grid == want.sigma_delta_grid == list(SIGMA_D)
    assert got.heatmap.shape == want.heatmap.shape == (6, 6)
    for i, sw in enumerate(SIGMA_W):
        for j, sd in enumerate(SIGMA_D):
            bits = _port_bits(sw, sd, n, seed=i * 31 + j)
            assert got.heatmap[i, j] == pytest.approx(bits.mean(), rel=1e-12)
            assert abs(got.heatmap[i, j] - want.heatmap[i, j]) <= _five_se(bits)
    band = got.heatmap[1:, :]  # sigma_w in [0.015, 0.05], every sigma_delta <= 0.02
    assert got.within_family_range == (band.min(), band.max())
    assert got.recommended_threshold() == want.recommended_threshold() == bd.DEFAULT_THRESHOLD
