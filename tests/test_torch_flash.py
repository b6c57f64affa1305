"""The port's flash attention (``repro_torch.kernels.flash_attention``, plain
path on the CPU) and its ``layers.attention`` against the JAX package:
``repro.kernels.ref.mha_reference`` and ``repro.models.layers.attention``.

The Pallas kernel itself does not run on this tree (jax 0.9.0 removed
``pl.load``, which it calls), so the reference's dense oracle and its XLA
attention are what the port is held to. Inputs are made with numpy from a seed
and cross as numpy arrays; bf16 inputs are rounded from the same float32 draws
in both packages (round to nearest even in both). Tolerances are the
reference's (``tests/test_flash_kernel.py:33``): 2e-5 in float32, 2e-2 in
bf16, where sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.ref import mha_reference as jax_mha_reference
from repro.models import layers as JL
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as TL

# (B, S, H, D, causal, window): tests/test_flash_kernel.py:12-19, block sizes dropped
CASES = [
    (2, 256, 4, 128, True, 0),
    (1, 512, 2, 128, False, 0),
    (2, 256, 4, 128, True, 64),
    (1, 1024, 1, 128, True, 0),
    (1, 256, 2, 256, True, 0),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(shape_q, shape_k, dtype_name, seed):
    """(torch q, k, v), (jax q, k, v) from the same float32 numpy draws."""
    tdt, jdt, _ = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (shape_q, shape_k, shape_k)]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(jdt) for a in arrs])


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_flash_plain_path_matches_jax_reference(case, dtype):
    B, S, H, D, causal, window = case
    (q, k, v), (jq, jk, jv) = _inputs((B, S, H, D), (B, S, H, D), dtype, 42)
    before = _build.launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert _build.launch_counts() == before  # the CPU path launches nothing
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jax_mha_reference(jq, jk, jv, causal=causal, window=window), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_layers_attention_matches_jax_reference(case, dtype):
    B, S, H, D, causal, window = case
    (q, k, v), (jq, jk, jv) = _inputs((B, S, H, D), (B, S, H, D), dtype, 43)
    got = TL.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype
    _close(got, jax_mha_reference(jq, jk, jv, causal=causal, window=window), DTYPES[dtype][2])


@pytest.mark.parametrize("impl", ["flash", "layers"])
def test_long_sequence_matches_jax_chunked_attention(impl):
    """S = 4096 takes the reference's chunked XLA path
    (tests/test_flash_kernel.py:38-49) and the port's chunked path."""
    (q, k, v), (jq, jk, jv) = _inputs((1, 4096, 2, 128), (1, 4096, 2, 128), "float32", 7)
    if impl == "flash":
        got = flash_attention(q, k, v, causal=True)
    else:
        got = TL.attention(q, k, v, causal=True)
    _close(got, JL.attention(jq, jk, jv, causal=True), 2e-5)


def test_chunked_attention_bf16_scores_match_jax():
    """``score_dtype=bfloat16`` rounds each score block in the chunked path of
    both packages; float32 sums in another order can move a score across a
    bf16 rounding boundary, hence the bf16 tolerance."""
    (q, k, v), (jq, jk, jv) = _inputs((1, 4096, 2, 64), (1, 4096, 2, 64), "float32", 8)
    got = TL.attention(q, k, v, causal=True, score_dtype=torch.bfloat16)
    _close(got, JL.attention(jq, jk, jv, causal=True, score_dtype=jnp.bfloat16), 2e-2)


@pytest.mark.parametrize("shape", [
    # (B, Sq, Sk, H, D, causal, window, q_offset)
    (2, 33, 33, 3, 16, True, 0, 0),
    (1, 1000, 1000, 2, 128, True, 0, 0),
    (1, 300, 300, 2, 64, False, 64, 0),
    (1, 2500, 2500, 1, 32, True, 0, 0),      # ragged chunks: no divisibility assert
    (1, 3000, 3000, 1, 16, False, 100, 0),
    (2, 1, 40, 2, 16, True, 0, 39),          # one decode query over a cache
])
def test_ragged_and_windowed_attention_match_jax_reference(shape):
    B, Sq, Sk, H, D, causal, window, q_offset = shape
    (q, k, v), (jq, jk, jv) = _inputs((B, Sq, H, D), (B, Sk, H, D), "float32", 9)
    got = TL.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = JL.attention(jq, jk, jv, causal=causal, window=window, q_offset=q_offset) \
        if Sq <= 2048 else jax_mha_reference(jq, jk, jv, causal=causal, window=window)
    _close(got, want, 2e-5)
    if q_offset == 0:
        _close(flash_attention(q, k, v, causal=causal, window=window), want, 2e-5)


def test_fully_masked_rows_average_v_uniformly():
    """A row whose keys are all masked gets the finite -1e30 everywhere, so
    softmax is uniform and the row is the mean of v, as in the references."""
    (q, k, v), (jq, jk, jv) = _inputs((1, 64, 1, 16), (1, 8, 1, 16), "float32", 10)
    got = flash_attention(q, k, v, causal=False, window=4)
    want = jax_mha_reference(jq, jk, jv, causal=False, window=4)
    _close(got, want, 2e-5)
    torch.testing.assert_close(got[0, -1, 0], v[0, :, 0].mean(dim=0))


def test_wrapper_checks_and_refusals():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="heads"):
        flash_attention(q, torch.zeros((1, 8, 1, 16)), torch.zeros((1, 8, 1, 16)))
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=-1)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q.clone().requires_grad_(), q, q)
    meta = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError):
        flash_attention(meta, meta, meta)


@pytest.mark.filterwarnings("ignore:Accessing the data pointer of FakeTensor")
def test_cuda_tensors_go_to_the_launcher(monkeypatch):
    """A CUDA tensor never takes the plain path: the wrapper hands the kernel's
    launcher the pointers, the shape, every operand's B/S/H strides (q, k and v
    read in place, with the strides of a fused projection), causal, window and
    the dtype code, in the order of the C signature. Fake CUDA tensors stand in
    for a card."""
    calls = []

    def fake_launch(kernel, device, *args):
        calls.append((kernel, device.type, args[4:]))
        raise RuntimeError("no card here")

    monkeypatch.setattr(_build, "launch_args", fake_launch)
    with FakeTensorMode():
        q, k, v = (torch.empty_strided((2, 5, 4, 32), (5 * 12 * 32, 12 * 32, 32, 1),
                                       device="cuda", dtype=torch.bfloat16) for _ in range(3))
        with pytest.raises(RuntimeError, match="no card"):
            flash_attention(q, k, v, causal=True, window=3)
    (kernel, dev, args), = calls
    assert kernel == "flash_attention" and dev == "cuda"
    fused = (5 * 12 * 32, 12 * 32, 32)
    out = (5 * 4 * 32, 4 * 32, 32)
    assert args == (2, 5, 5, 4, 32, *fused, *fused, *fused, *out, 1, 3, 1)
    assert len(args) + 4 + 1 == len(_build._SIGNATURES["flash_attention"])


def test_mha_reference_ports_the_jax_oracle():
    (q, k, v), (jq, jk, jv) = _inputs((2, 50, 3, 32), (2, 70, 3, 32), "bfloat16", 11)
    for causal, window in ((True, 0), (False, 0), (True, 16), (False, 16)):
        got = ref.mha_reference(q, k, v, causal=causal, window=window)
        assert got.dtype == torch.bfloat16
        _close(got, jax_mha_reference(jq, jk, jv, causal=causal, window=window), 2e-2)
