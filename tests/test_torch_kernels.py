"""The port's kernel ops (``repro_torch.kernels.ops``, plain path on the CPU)
against the JAX package: ``repro.kernels.ops`` with the Pallas kernels in
interpret mode, ``repro.kernels.ref`` and the numpy host path.

Inputs are made with numpy from a seed and cross between the packages as
numpy arrays. Everything is lossless bit manipulation, so every comparison is
exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as stt

from repro.core.bitx import NumpyBackend
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops

# the 2-D tiles of tests/test_kernels.py, flattened, plus awkward lengths
LENGTHS = [1 * 1024, 4 * 1024, 256 * 1024, 3 * 2048, 257 * 1024, 0, 1, 1023, 1025]
DTYPES = [np.uint16, np.uint32]

NP = NumpyBackend()


def _bits(n, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max, n, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_ops_match_jax_pallas_and_ref(n, dtype):
    a, b = _bits(n, dtype, 1), _bits(n, dtype, 2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    before = _build.launch_counts()

    planes = ops.bitx_encode_planes(ta, tb)
    want_pallas = jops.bitx_encode_planes(ja, jb, use_pallas=True)
    want_ref = jref.xor_split_planes(ja, jb)
    assert len(planes) == len(want_pallas) == a.itemsize
    for p, wp, wr in zip(planes, want_pallas, want_ref):
        assert p.dtype == torch.uint8
        np.testing.assert_array_equal(p.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(p.numpy(), np.asarray(wr))

    back = ops.bitx_decode_planes(planes, ta)
    jback = jops.bitx_decode_planes(want_pallas, ja, use_pallas=True)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    np.testing.assert_array_equal(back.numpy(), b)

    split = ops.zipnn_split_planes(ta)
    for p, wp, wr in zip(split, jops.zipnn_split_planes(ja, use_pallas=True),
                         jref.byte_split(ja)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(p.numpy(), np.asarray(wr))
    merged = ops.zipnn_merge_planes(split, ta.dtype, (n,))
    jmerged = jops.zipnn_merge_planes([np.asarray(p) for p in split], a.dtype, (n,),
                                      use_pallas=True)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    np.testing.assert_array_equal(merged.numpy(), a)
    # CPU tensors take the plain versions: nothing is launched
    assert _build.launch_counts() == before


@pytest.mark.parametrize("shape", [(7,), (33, 5), (2, 3, 129), (1025,)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_float_ops_match_jax(shape, dtype):
    """Float tensors ride their bit views: bf16 -> u16, f32 -> u32."""
    rng = np.random.default_rng(4)
    base32 = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    ft32 = base32 + (rng.standard_normal(shape) * 0.005).astype(np.float32)
    jbase, jft = jnp.asarray(base32).astype(dtype), jnp.asarray(ft32).astype(dtype)
    # the same bits on both sides: hand the JAX-rounded words to torch
    bits = {"bfloat16": torch.uint16, "float32": torch.uint32}[dtype]
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    tbase = torch.from_numpy(np.array(jops.to_bit_view(jbase))).view(tdt)
    tft = torch.from_numpy(np.array(jops.to_bit_view(jft))).view(tdt)
    assert ops.bit_view_dtype(tdt) == bits

    planes = ops.bitx_encode_planes(tbase, tft)
    for p, w in zip(planes, jops.bitx_encode_planes(jbase, jft, use_pallas=True)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    out = ops.bitx_decode_planes(planes, tbase)
    assert out.dtype == bits and tuple(out.shape) == shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(jops.to_bit_view(jft)))

    split = ops.zipnn_split_planes(tft)
    for p, w in zip(split, jops.zipnn_split_planes(jft, use_pallas=True)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    merged = ops.zipnn_merge_planes(split, tdt, shape)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jops.to_bit_view(jft)))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint64])
def test_one_and_eight_byte_words_match_numpy_backend(dtype):
    """Widths the Pallas path does not cover (int8's bitxq lane, f64/u64)
    against the reference host path."""
    for n in (0, 1, 1023, 1025, 4099):
        a, b = _bits(n, dtype, 5), _bits(n, dtype, 6)
        planes = ops.bitx_encode_planes(torch.from_numpy(a), torch.from_numpy(b))
        want = NP.xor_delta_planes(a, b)
        assert len(planes) == len(want) == a.itemsize
        for p, w in zip(planes, want):
            np.testing.assert_array_equal(p.numpy(), w)
        back = ops.bitx_decode_planes(planes, torch.from_numpy(a))
        np.testing.assert_array_equal(back.numpy(), NP.merge_planes_xor(want, a))
        split = ops.zipnn_split_planes(torch.from_numpy(a))
        for p, w in zip(split, NP.byte_planes(a)):
            np.testing.assert_array_equal(p.numpy(), w)
        merged = ops.zipnn_merge_planes(split, torch.from_numpy(a).dtype, (n,))
        np.testing.assert_array_equal(merged.numpy(), NP.merge_planes(NP.byte_planes(a), a.dtype, (n,)))


def test_bit_view_dtype_map():
    assert ops.bit_view_dtype(torch.bfloat16) == torch.uint16
    assert ops.bit_view_dtype(torch.float16) == torch.uint16
    assert ops.bit_view_dtype(torch.float32) == torch.uint32
    assert ops.bit_view_dtype(torch.float64) == torch.uint64
    assert ops.bit_view_dtype(torch.uint32) == torch.uint32
    with pytest.raises(ValueError):
        ops.bit_view_dtype(torch.int32)


@settings(max_examples=30, deadline=None)
@given(stt.lists(stt.floats(width=32, allow_nan=True, allow_infinity=True),
                 min_size=1, max_size=300))
def test_property_bitx_roundtrip_any_floats(xs):
    """BitX is lossless for ANY bit pattern, including NaN/Inf payloads, and
    emits the reference host path's planes."""
    base = np.asarray(xs, np.float32)
    ft = base[::-1].copy()
    planes = ops.bitx_encode_planes(torch.from_numpy(base), torch.from_numpy(ft))
    for p, w in zip(planes, NP.xor_delta_planes(base, ft)):
        np.testing.assert_array_equal(p.numpy(), w)
    out = ops.bitx_decode_planes(planes, torch.from_numpy(base))
    np.testing.assert_array_equal(out.numpy(), ft.view(np.uint32))
