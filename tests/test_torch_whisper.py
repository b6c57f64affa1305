"""The port's whisper backbone (``repro_torch.models.whisper``) against the
JAX package's (``repro.models.whisper``), on the CPU.

At the smoke config in float32 the JAX ``init_params`` output crosses through
``params_from_reference`` and the batch (frames stub included) through numpy;
``loss``, prefill logits, every cache entry and one ``decode_step`` must agree
within 1e-4 (float32 sums in another order; the observed gap is about 1e-7).
The bf16 prefill→decode check uses ``tests/test_models_smoke.py:106``'s 2e-2.

The serving engines differ on purpose: the JAX engine pads every cache entry
tagged "sp", the cross-attention K/V too, so its decode attends to zero keys
beyond the encoder's frames. The port grows only ``self_k``/``self_v``, so its
greedy tokens are held to the JAX *model's* prefill and decode with the self
caches alone grown, and one test records what the JAX engine does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.models import api as japi
from repro.models import whisper as jwhisper
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import _build
from repro_torch.models import api, whisper
from repro_torch.serve.engine import ServeEngine

ARCH = "whisper-medium"
TOL = 1e-4
SEED = 5          # top-2 margin >= 4e-3 at every greedy step of the engine test
MARGIN = 1e-3
SELF = ("self_k", "self_v")


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _grow_self(cache, extra):
    """A JAX cache with the self-attention K/V alone grown along their
    sequence axis (axis 2 of (L, B, S, Kv, hd))."""
    out = dict(cache)
    for k in SELF:
        out[k] = jnp.pad(cache[k], [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, port cfg, JAX params, port params), float32."""
    jcfg = _fp32(jax_get_config(ARCH, smoke=True))
    tcfg = _fp32(get_config(ARCH, smoke=True))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = api.params_from_reference({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("S,d,offset", [(1500, 1024, 0), (16, 64, 0), (1, 1024, 37),
                                        (1, 64, 448)])
def test_sinusoid_positions_match_jax(S, d, offset):
    got = whisper.sinusoid_positions(S, d, offset=offset)
    want = np.asarray(jwhisper.sinusoid_positions(S, d, offset=offset))
    assert got.dtype == torch.float32 and got.shape == want.shape
    # the angles are equal; XLA's float32 sin and cos and PyTorch's differ by
    # at most one ulp (6e-8 below 1), so equality is held to 1e-7
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_loss_matches_jax(pair):
    jcfg, tcfg, jp, tp = pair
    jb = japi.make_batch(jcfg, JaxShapeCell("t", "train", 32, 2), jax.random.PRNGKey(1))
    want = float(japi.get_model(jcfg).loss(jp, jb))
    for attn in ("flash", "plain"):
        got = api.get_model(tcfg, attn=attn).loss(tp, _to_torch(jb))
        assert got.shape == () and got.dtype == torch.float32
        _close(float(got), want)


@pytest.mark.parametrize("S_dec,S_enc", [(16, 16), (12, 40)])
def test_prefill_and_decode_match_jax(pair, S_dec, S_enc):
    """Prefill (cross attention with Sq != Sk in the second case), every
    cache entry, and one decode step with the self caches grown."""
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(S_enc)
    tokens = rng.integers(1, tcfg.vocab, (2, S_dec)).astype(np.int32)
    frames = (rng.standard_normal((2, S_enc, tcfg.d_model)) * 0.02).astype(np.float32)
    jm, tm = japi.get_model(jcfg), api.get_model(tcfg)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                                   "frames": torch.from_numpy(frames)})
    assert tlog.shape == (2, tcfg.vocab) and tlog.dtype == torch.float32
    _close(tlog, jlog)
    assert tcache.keys() == jcache.keys()
    for k in SELF + ("cross_k", "cross_v"):
        assert tuple(tcache[k].shape) == jcache[k].shape, k
        _close(tcache[k], jcache[k])
    assert tcache["cross_k"].shape[2] == S_enc and tcache["self_k"].shape[2] == S_dec
    assert tcache["len"] == int(jcache["len"]) == S_dec

    nxt = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
    jlog2, jcache2 = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, _grow_self(jcache, 1))
    grown = ServeEngine(tcfg, tp, device="cpu")._pad_cache(tcache, 1)
    tlog2, tcache2 = tm.decode_step(tp, {"tokens": torch.from_numpy(nxt)}, grown)
    _close(tlog2, jlog2)
    assert tcache2["self_k"] is grown["self_k"]  # written in place
    for k in SELF + ("cross_k", "cross_v"):
        _close(tcache2[k], jcache2[k])
    assert tcache2["len"] == int(jcache2["len"]) == S_dec + 1


def test_prefill_decode_consistency():
    """Decode after prefill matches re-prefilling the longer sequence (the
    bf16 smoke config, bf16 frames, as in tests/test_models_smoke.py:74-107)."""
    cfg = get_config(ARCH, smoke=True)
    model = api.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, gen)
    S = 16
    batch = api.make_batch(cfg, ShapeCell("p", "prefill", S, 2), gen)
    assert batch["frames"].dtype == torch.bfloat16
    logits_p, cache = model.prefill(params, batch)
    assert logits_p.shape == (2, cfg.vocab) and torch.isfinite(logits_p).all()
    nxt = logits_p.argmax(-1).to(torch.int32)[:, None]
    grown = ServeEngine(cfg, params, device="cpu")._pad_cache(cache, 1)
    logits_d, _ = model.decode_step(params, {"tokens": nxt}, grown)
    batch2 = dict(batch, tokens=torch.cat([batch["tokens"], nxt], dim=1))
    logits_f, _ = model.prefill(params, batch2)
    np.testing.assert_allclose(logits_d.numpy(), logits_f.numpy(), rtol=2e-2, atol=2e-2)


def test_pad_cache_grows_the_self_cache_only():
    cfg = get_config(ARCH, smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(1))
    eng = ServeEngine(cfg, params, device="cpu")
    batch = api.make_batch(cfg, ShapeCell("p", "prefill", 10, 2), torch.Generator().manual_seed(2))
    _, cache = eng.model.prefill(params, batch)
    grown = eng._pad_cache(cache, 4)
    for k in SELF:
        assert grown[k].shape[2] == cache[k].shape[2] + 4
        assert torch.equal(grown[k][:, :, :10], cache[k]) and not grown[k][:, :, 10:].any()
    for k in ("cross_k", "cross_v"):
        assert grown[k] is cache[k]


def test_reference_engine_pads_the_cross_cache():
    """A fact about the reference kept out of the port: the JAX engine's
    ``_pad_cache`` grows every entry tagged "sp", ``cross_k``/``cross_v``
    too, with zero keys that its non-causal, unmasked decode cross attention
    then takes into the softmax."""
    jcfg = jax_get_config(ARCH, smoke=True)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(3))
    eng = JaxServeEngine(jcfg, jp)
    assert set(eng._grow_axes) == {"self_k", "self_v", "cross_k", "cross_v"}
    jb = japi.make_batch(jcfg, JaxShapeCell("p", "prefill", 8, 2), jax.random.PRNGKey(4))
    _, cache = eng._prefill(jp, jb)
    grown = eng._pad_cache(cache, 3)
    assert grown["cross_k"].shape[2] == cache["cross_k"].shape[2] + 3
    assert not np.asarray(grown["cross_k"][:, :, 8:], np.float32).any()
    # and the reference's template sizes the cross cache by the decoder's seq
    assert jwhisper.WhisperModel(jcfg).cache_templates(2, 5)["cross_k"].shape[2] == 5


def test_generate_matches_jax_model_with_self_caches_grown(pair):
    """The port's engine tokens equal a greedy loop over the JAX model's
    prefill and decode_step with the self caches alone grown; the port's
    top-2 logit margin stays above 1e-3 at every step."""
    jcfg, tcfg, _, _ = pair
    jp = japi.init_params(jcfg, jax.random.PRNGKey(SEED))
    eng = ServeEngine(tcfg, api.params_from_reference({k: np.asarray(v) for k, v in jp.items()},
                                                      "cpu"), device="cpu")
    margins = []

    def recorded(fn):
        def call(*args):
            logits, cache = fn(*args)
            top = logits.topk(2, dim=-1).values
            margins.append(float((top[:, 0] - top[:, 1]).min()))
            return logits, cache
        return call

    eng.model.prefill = recorded(eng.model.prefill)
    eng.model.decode_step = recorded(eng.model.decode_step)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(1, tcfg.vocab, (3, 16)).astype(np.int32)
    frames = (rng.standard_normal((3, 24, tcfg.d_model)) * 0.02).astype(np.float32)
    n_new = 6
    before = _build.launch_counts()
    got = eng.generate(prompts, n_new, extra_inputs={"frames": frames})
    assert _build.launch_counts() == before  # the CPU path launches nothing
    assert len(margins) == n_new and min(margins) > MARGIN

    jm = japi.get_model(jcfg)
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)})
    cache = _grow_self(cache, n_new)
    toks = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for _ in range(n_new - 1):
        logits, cache = jm.decode_step(jp, {"tokens": toks[-1][:, None]}, cache)
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    want = np.concatenate([prompts, np.stack([np.asarray(t) for t in toks], 1)], 1)
    assert got.tokens.shape == (3, 22) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want)


def test_flash_and_plain_engines_agree_on_the_cpu():
    """Under attn="flash" the encoder, decoder-self and cross attention take
    the kernel's plain version on CPU tensors: both engines give one prefill,
    and the cross cache keeps the encoder's length."""
    cfg = _fp32(get_config(ARCH, smoke=True))
    params = api.init_params(cfg, torch.Generator().manual_seed(8))
    gen = torch.Generator().manual_seed(9)
    batch = {"tokens": torch.randint(1, cfg.vocab, (2, 12), generator=gen),
             "frames": torch.randn((2, 30, cfg.d_model), generator=gen) * 0.02}
    lf, cf = api.get_model(cfg, attn="flash").prefill(params, batch)
    lp, cp = api.get_model(cfg, attn="plain").prefill(params, batch)
    torch.testing.assert_close(lf, lp, rtol=1e-5, atol=1e-5)
    for k in SELF + ("cross_k", "cross_v"):
        torch.testing.assert_close(cf[k], cp[k], rtol=1e-5, atol=1e-5)
    assert cf["cross_k"].shape[2] == 30
