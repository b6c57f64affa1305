"""The port's transformer family (``repro_torch.models``) against the JAX
package's (``repro.models``), on the CPU; the parameter and cache templates,
``init_params``/``init_cache`` and the loss gradients of all ten configs.

For each of the seven transformer smoke configs, float32 copies
(``param_dtype = act_dtype = "float32"``) are made in both packages; the JAX
``init_params`` output crosses through ``params_from_reference``, the batch
through numpy, and ``loss``, prefill logits and cache, and one
``decode_step`` must agree within 1e-4 (float32 sums in another order; the
observed gap is about 1e-6). The port's own prefill→decode check follows
``tests/test_models_smoke.py:74-107`` on the bf16 smoke configs with its
tolerance.
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
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import _build
from repro_torch.models import api

TRANSFORMERS = ["qwen2-7b", "qwen2-vl-7b", "granite-20b", "phi4-mini-3.8b",
                "deepseek-coder-33b", "mixtral-8x7b", "grok-1-314b"]
TOL = 1e-4
TRAIN = (2, 32)     # (B, S) of the loss batch
PREFILL = (2, 16)


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=TRANSFORMERS)
def pair(request):
    """(arch, JAX cfg, port cfg, JAX params, port params), float32."""
    arch = request.param
    jcfg = _fp32(jax_get_config(arch, smoke=True))
    tcfg = _fp32(get_config(arch, smoke=True))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = api.params_from_reference({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return arch, jcfg, tcfg, jp, tp


def _grow(cache, extra):
    """The JAX cache, grown along its sequence axis (axis 2 of (L, B, S, Kv, hd))."""
    out = dict(cache)
    for k in ("k", "v"):
        out[k] = jnp.pad(cache[k], [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])
    return out


def test_loss_matches_jax(pair):
    arch, jcfg, tcfg, jp, tp = pair
    jb = japi.make_batch(jcfg, JaxShapeCell("t", "train", TRAIN[1], TRAIN[0]),
                         jax.random.PRNGKey(1))
    want = float(japi.get_model(jcfg).loss(jp, jb))
    for attn in ("flash", "plain"):
        got = api.get_model(tcfg, attn=attn).loss(tp, _to_torch(jb))
        assert got.shape == () and got.dtype == torch.float32
        _close(float(got), want)


def test_prefill_and_decode_match_jax(pair):
    arch, jcfg, tcfg, jp, tp = pair
    B, S = PREFILL
    jb = japi.make_batch(jcfg, JaxShapeCell("p", "prefill", S, B), jax.random.PRNGKey(2))
    jm, tm = japi.get_model(jcfg), api.get_model(tcfg)
    jlog, jcache = jm.prefill(jp, jb)
    tlog, tcache = tm.prefill(tp, _to_torch(jb))
    assert tlog.shape == (B, tcfg.vocab) and tlog.dtype == torch.float32
    _close(tlog, jlog)
    for k in ("k", "v"):
        assert tcache[k].shape == jcache[k].shape
        _close(tcache[k], jcache[k])
    assert tcache["len"] == int(jcache["len"]) == S

    nxt = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
    jlog2, jcache2 = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, _grow(jcache, 1))
    grown = {k: torch.nn.functional.pad(tcache[k], (0, 0, 0, 0, 0, 1)) for k in ("k", "v")}
    grown["len"] = tcache["len"]
    tlog2, tcache2 = tm.decode_step(tp, {"tokens": torch.from_numpy(nxt)}, grown)
    _close(tlog2, jlog2)
    assert tcache2["k"] is grown["k"]  # written in place
    for k in ("k", "v"):
        _close(tcache2[k], jcache2[k])
    assert tcache2["len"] == int(jcache2["len"]) == S + 1


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_prefill_decode_consistency(arch):
    """Greedy decode after prefill matches re-prefilling the longer sequence
    (the bf16 smoke config, as in tests/test_models_smoke.py:74-107)."""
    cfg = get_config(arch, smoke=True)
    model = api.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, gen)
    S = 16
    batch = api.make_batch(cfg, ShapeCell("p", "prefill", S, 2), gen)
    logits_p, cache = model.prefill(params, batch)
    assert logits_p.shape == (2, cfg.vocab) and torch.isfinite(logits_p).all()
    nxt = logits_p.argmax(-1).to(torch.int32)[:, None]
    grown = dict(cache)
    for k, spec in model.cache_templates(2, S).items():
        if "sp" in spec.axes:
            ax = spec.axes.index("sp")
            pad = [0, 0] * (cache[k].dim() - 1 - ax) + [0, 1]
            grown[k] = torch.nn.functional.pad(cache[k], pad)
    logits_d, _ = model.decode_step(params, {"tokens": nxt}, grown)
    batch2 = dict(batch)
    batch2["tokens"] = torch.cat([batch["tokens"], nxt], dim=1)
    if "patch_embeds" in batch2:
        batch2["patch_embeds"] = torch.nn.functional.pad(batch2["patch_embeds"], (0, 0, 0, 1))
        batch2["positions3"] = torch.nn.functional.pad(batch2["positions3"], (0, 1), value=S)
    logits_f, _ = model.prefill(params, batch2)
    np.testing.assert_allclose(logits_d.numpy(), logits_f.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_templates_match_jax(arch):
    """Same names, shapes, dtypes, axes and init recipes as the reference, and
    the same published parameter counts, for all ten configs."""
    jt = japi.get_model(jax_get_config(arch)).param_templates()
    tt = api.get_model(get_config(arch)).param_templates()
    assert jt.keys() == tt.keys()
    for name in jt:
        a, b = jt[name], tt[name]
        assert (a.shape, a.dtype, a.axes, a.init, a.init_scale, a.stacked) == \
            (b.shape, b.dtype, b.axes, b.init, b.init_scale, b.stacked), name
    assert get_config(arch).param_count() == jax_get_config(arch).param_count()
    assert get_config(arch).active_param_count() == jax_get_config(arch).active_param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_and_cache_cover_every_config(arch):
    """``init_params`` and ``init_cache`` build every config's smoke size;
    the cache templates equal the reference's."""
    cfg = get_config(arch, smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    tmpl = api.get_model(cfg).param_templates()
    assert params.keys() == tmpl.keys()
    for k, spec in tmpl.items():
        assert tuple(params[k].shape) == spec.shape and params[k].dtype == getattr(torch, spec.dtype)
    cache = api.init_cache(cfg, batch=2, seq=24, device="cpu")
    jt = japi.get_model(jax_get_config(arch, smoke=True)).cache_templates(2, 24)
    tt = api.get_model(cfg).cache_templates(2, 24)
    assert jt.keys() == tt.keys() == cache.keys()
    for k in jt:
        assert (jt[k].shape, jt[k].dtype, jt[k].axes) == (tt[k].shape, tt[k].dtype, tt[k].axes), k
        if k != "len":
            assert tuple(cache[k].shape) == tt[k].shape and not cache[k].any()
    assert cache["len"] == 0


# (arch, rtol, atol) of the gradient comparison: float32 sums in another
# order through a few layers; atol sits far below the gradients' scale
GRAD_CASES = [("qwen2-7b", 1e-3, 1e-6), ("falcon-mamba-7b", 1e-3, 1e-6),
              ("zamba2-2.7b", 1e-3, 1e-6), ("whisper-medium", 1e-3, 1e-6)]


@pytest.mark.parametrize("arch,rtol,atol", GRAD_CASES)
def test_loss_gradients_match_jax(arch, rtol, atol):
    """``loss`` keeps the autograd graph: with attn="plain", the gradient of
    every parameter matches ``jax.grad`` of the reference's loss (what its
    train step differentiates, ``src/repro/train/step.py:40-41``). Under
    attn="flash" a differentiated loss of a model that attends is refused:
    the kernel is forward-only."""
    jcfg = _fp32(jax_get_config(arch, smoke=True))
    tcfg = _fp32(get_config(arch, smoke=True))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(3))
    jb = japi.make_batch(jcfg, JaxShapeCell("t", "train", 16, 2), jax.random.PRNGKey(4))
    jm = japi.get_model(jcfg)
    jloss, jgrad = jax.value_and_grad(lambda p: jm.loss(p, jb))(jp)
    tp = {k: v.requires_grad_() for k, v in
          api.params_from_reference({k: np.asarray(v) for k, v in jp.items()}, "cpu").items()}
    tb = _to_torch(jb)
    loss = api.get_model(tcfg, attn="plain").loss(tp, tb)
    assert loss.requires_grad
    _close(float(loss), float(jloss))
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in names])
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]), rtol=rtol, atol=atol,
                                   err_msg=k)
    if tcfg.family != "ssm":
        with pytest.raises(RuntimeError, match="forward-only"):
            api.get_model(tcfg, attn="flash").loss(tp, tb)


def test_init_params_is_seeded_and_follows_the_recipe():
    cfg = get_config("qwen2-7b", smoke=True)
    a = api.init_params(cfg, torch.Generator().manual_seed(3))
    b = api.init_params(cfg, torch.Generator().manual_seed(3))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(t.dtype == torch.bfloat16 for t in a.values())
    assert (a["final_norm"] == 1).all() and (a["blocks.bq"] == 0).all()
    assert 0.015 < float(a["embed"].float().std()) < 0.025
    assert float(a["blocks.wo"].float().std()) < 0.01  # scaled by 0.02 / sqrt(2 L)


def test_params_from_reference_keeps_bf16_bits():
    """A JAX bf16 array crosses with the same 16 bits and becomes
    torch.bfloat16, without ml_dtypes on the port's side."""
    jp = japi.init_params(jax_get_config("qwen2-7b", smoke=True), jax.random.PRNGKey(5))
    flat = {k: np.asarray(v) for k, v in jp.items()}
    tp = api.params_from_reference(flat, "cpu")
    for k, v in flat.items():
        assert tp[k].dtype == torch.bfloat16 and tp[k].shape == v.shape
        assert (tp[k].view(torch.int16).numpy() == v.view(np.int16)).all(), k


def test_flash_flag_and_cpu_path_launch_nothing():
    cfg = _fp32(get_config("mixtral-8x7b", smoke=True))  # sliding window too
    params = api.init_params(cfg, torch.Generator().manual_seed(6))
    batch = api.make_batch(cfg, ShapeCell("p", "prefill", 24, 2), torch.Generator().manual_seed(7))
    before = _build.launch_counts()
    lf, cf = api.get_model(cfg, attn="flash").prefill(params, batch)
    lp, cp = api.get_model(cfg, attn="plain").prefill(params, batch)
    assert _build.launch_counts() == before
    torch.testing.assert_close(lf, lp, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        api.get_model(cfg, attn="sdpa")


def test_init_cache_and_templates():
    cfg = get_config("mixtral-8x7b", smoke=True)
    cache = api.init_cache(cfg, batch=2, seq=64, device="cpu")
    # rolling SWA cache: the sequence axis is cut to the window
    assert cache["k"].shape == (cfg.n_layers, 2, cfg.swa_window, cfg.n_kv_heads, cfg.hd)
    assert cache["len"] == 0
    t = api.input_templates(get_config("qwen2-vl-7b", smoke=True), ShapeCell("p", "prefill", 8, 2))
    assert set(t) == {"tokens", "patch_embeds", "positions3"}
