"""The port's training path (``repro_torch.optim``, ``.train.step``,
``.data``, the models' remat and ``moe_block``'s groups) against the JAX
package's, on the CPU.

* The reference's own optimizer, schedule, clip, microbatch, bf16-grad,
  data, prefetch and MoE cases (``tests/test_substrate.py``) and its
  ``test_forward_and_train_step`` / ``test_loss_decreases``
  (``tests/test_models_smoke.py``), run against the port with the
  reference's sizes and bounds.
* AdamW and Adafactor on identical numpy gradients, five steps through
  warmup and cosine: params and state within 1e-6 of each tensor's largest
  magnitude (float32 arithmetic in the same order; the per-step scalars are
  rounded once from float64, where XLA computes them in float32).
* One train step from identical float32 params and batch, G 1 and 2, grad
  dtype float32 and bfloat16: loss, grad norm and the clipped gradients the
  optimizer receives within 1e-5 of each tensor's max; new params within
  1e-5, except where |g| is under 1e-6 of its tensor's max: there Adam's first
  step is ±lr whatever the gradient's size, so the sign of a gradient that is
  zero but for rounding decides it, and the bound is 2·lr. In bfloat16 a
  gradient element may also sit one bfloat16 step (at most 2^-7 of its size)
  from the reference's for each rounding to bfloat16 on its way to the
  optimizer (2 at G 1: the cast and the clip; 4 at G 2: two casts, the sum
  and the clip), where the two float32 values round to either side.
* Remat: loss and gradients are bit-equal under "nothing", "dots" and "none"
  for the four model classes; the chunked cross-entropy and the chunked
  attention keep no chunk's logits or score block for the backward pass.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.optim import optimizers as jopt
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.checkpoint.straggler import speculative_map
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticTokens
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.optim.optimizers import (AdamW, Adafactor, OptimizerConfig,
                                          clip_by_global_norm, global_norm, make_optimizer,
                                          warmup_cosine)
from repro_torch.train.step import make_eval_step, make_train_step


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _scaled_close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want| (want's scale; 1 when want is 0)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max error {err} vs {tol} x {scale}"


# ---------------------------------------------------------------------------
# Optimizers: the reference's cases (tests/test_substrate.py:26-77)
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_step():
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=10, b1=0.9, b2=0.99,
                          weight_decay=0.0, min_lr_ratio=1.0)
    opt = AdamW(cfg)
    p = {"w": torch.tensor([[1.0, 2.0]])}
    g = {"w": torch.tensor([[0.5, -0.5]])}
    s = opt.init(p)
    new_p, s = opt.update(g, s, p)
    # delta = g/(|g|+eps) = sign(g) -> p - lr*sign(g)
    np.testing.assert_allclose(new_p["w"].numpy(), [[1.0 - 0.1, 2.0 + 0.1]], rtol=1e-4)
    assert int(s["step"]) == 1 and s["step"].dtype == torch.int32


def test_adamw_weight_decay_skips_vectors():
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=0.5, min_lr_ratio=1.0)
    opt = AdamW(cfg)
    p = {"norm": torch.ones(4), "w": torch.ones(2, 2)}
    g = {"norm": torch.zeros(4), "w": torch.zeros(2, 2)}
    s = opt.init(p)
    new_p, _ = opt.update(g, s, p)
    np.testing.assert_allclose(new_p["norm"].numpy(), np.ones(4))   # no decay
    assert float(new_p["w"][0, 0]) < 1.0                            # decayed


def test_adafactor_factored_state_shapes():
    cfg = OptimizerConfig(name="adafactor", factored_min_dim=4)
    opt = Adafactor(cfg)
    p = {"big": torch.ones(3, 8, 16), "small": torch.ones(2)}
    s = opt.init(p)
    assert s["vr"]["big"].shape == (3, 8)
    assert s["vc"]["big"].shape == (3, 16)
    assert s["v"]["small"].shape == (2,)
    g = {"big": torch.full((3, 8, 16), 0.1), "small": torch.full((2,), 0.1)}
    new_p, s2 = opt.update(g, s, p)
    assert all(bool(torch.isfinite(v).all()) for v in new_p.values())


def test_clip_by_global_norm():
    t = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, g = clip_by_global_norm(t, 1.0)
    np.testing.assert_allclose(float(g), np.sqrt(10 * 9 + 10 * 16), rtol=1e-5)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)


def test_warmup_cosine_shape():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    s = warmup_cosine(cfg)
    assert float(s(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(s(10)) - 1.0) < 1e-6
    assert float(s(100)) == pytest.approx(0.1, rel=1e-3)
    assert float(s(55)) < 1.0


def test_warmup_cosine_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_ratio=0.1)
    js = jopt.warmup_cosine(jopt.OptimizerConfig(**cfg))
    ts = warmup_cosine(OptimizerConfig(**cfg))
    for step in range(0, 60):
        want = float(js(jnp.int32(step)))
        assert ts(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_optimizer_state_templates_match_jax():
    """The state templates (the checkpoint's ``opt/*`` layout) are the reference's."""
    from repro.sharding.rules import ParamSpec as JSpec
    from repro_torch.sharding.rules import ParamSpec
    shapes = {"w": ((256, 128), ("fsdp", "tp")), "n": ((128,), (None,)),
              "s": ((2, 128, 256), (None, "fsdp", "tp"))}
    for name, kw in (("adamw", {}), ("adafactor", {"factored_min_dim": 128})):
        jt = jopt.make_optimizer(jopt.OptimizerConfig(name=name, **kw)).state_templates(
            {k: JSpec(s, "bfloat16", a) for k, (s, a) in shapes.items()})
        tt = make_optimizer(OptimizerConfig(name=name, **kw)).state_templates(
            {k: ParamSpec(s, "bfloat16", a) for k, (s, a) in shapes.items()})
        flat = lambda tree: {(k, kk): (v.shape, v.dtype, v.axes, v.stacked)
                             for k, sub in tree.items()
                             for kk, v in (sub.items() if isinstance(sub, dict) else [("", sub)])}
        assert flat(jt) == flat(tt), name


# ---------------------------------------------------------------------------
# Optimizers against JAX on identical numpy gradients
# ---------------------------------------------------------------------------

OPT_SHAPES = {"w": (8, 16), "stack": (3, 8, 16), "norm": (16,), "bias": (5,), "tall": (4, 6)}
OPT_CASES = [
    ("adamw", {}),
    ("adafactor", {"factored_min_dim": 4}),     # factored second moment for w, stack, tall
    ("adafactor", {"factored_min_dim": 128}),   # nothing factored
]


@pytest.mark.parametrize("name,kw", OPT_CASES, ids=["adamw", "adafactor-factored",
                                                    "adafactor-unfactored"])
def test_optimizer_matches_jax_over_five_steps(name, kw):
    ocfg = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1, **kw)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg))
    to = make_optimizer(OptimizerConfig(**ocfg))
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in OPT_SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = _t(p0)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
             for k, s in OPT_SHAPES.items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update(_t(g), ts, tp)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in p0:
            _scaled_close(tp[k].numpy(), np.asarray(jp[k]), 1e-6, f"step {step + 1} param {k}")
        for part in ("m", "v", "vr", "vc"):
            assert set(ts.get(part, {})) == set(js.get(part, {})), part
            for k in ts.get(part, {}):
                _scaled_close(ts[part][k].numpy(), np.asarray(js[part][k]), 1e-6,
                              f"step {step + 1} {part}/{k}")


def test_optimizer_updates_in_place_and_keeps_dtypes():
    """bf16 params stay bf16 and are written in place; moments are float32."""
    p = {"w": torch.randn(4, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    before = p["w"].clone()
    ptr = p["w"].data_ptr()
    opt = AdamW(OptimizerConfig(lr=1e-2, warmup_steps=0))
    s = opt.init(p)
    new_p, s = opt.update({"w": torch.ones(4, 8, dtype=torch.bfloat16)}, s, p)
    assert new_p["w"].data_ptr() == ptr and new_p["w"].dtype == torch.bfloat16
    assert not torch.equal(new_p["w"], before)
    assert s["m"]["w"].dtype == s["v"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# One train step against the reference's
# ---------------------------------------------------------------------------

class _Recording:
    """An optimizer that records the (clipped) gradients it is handed."""

    def __init__(self, inner):
        self.inner = inner
        self.grads = None

    def update(self, grads, state, params):
        self.grads = grads
        return self.inner.update(grads, state, params)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
def test_train_step_matches_jax(G, grad_dtype):
    arch = "qwen2-7b"
    jcfg, tcfg = _fp32(jax_get_config(arch, smoke=True)), _fp32(get_config(arch, smoke=True))
    ocfg = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(5))
    jb = japi.make_batch(jcfg, JaxShapeCell("t", "train", 16, 4), jax.random.PRNGKey(6))
    jrec = _Recording(jopt.AdamW(jopt.OptimizerConfig(**ocfg)))
    jstep = jax_make_train_step(japi.get_model(jcfg), jrec, microbatches=G, grad_dtype=grad_dtype)
    jnew, jstate, jm = jstep(jp, jrec.inner.init(jp), jb)

    tp = api.params_from_reference({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    p0 = {k: v.clone() for k, v in tp.items()}
    trec = _Recording(AdamW(OptimizerConfig(**ocfg)))
    tstep = make_train_step(api.get_model(tcfg, attn="plain"), trec, microbatches=G,
                            grad_dtype=grad_dtype)
    tnew, tstate, tm = tstep(tp, trec.inner.init(tp), _t(jb))

    assert tm["loss"].shape == () and int(tm["step"]) == int(jm["step"]) == 1
    _scaled_close(float(tm["loss"]), float(jm["loss"]), 1e-5, "loss")
    _scaled_close(float(tm["grad_norm"]), float(jm["grad_norm"]), 1e-5, "grad_norm")
    lr = ocfg["lr"]
    ulp = 2.0 ** -7  # one bfloat16 rounding step is at most this share of the value
    roundings = 2 if G == 1 else 4
    for k in sorted(jp):
        jg = np.asarray(jrec.grads[k], np.float64)
        tg = trec.grads[k].double().numpy()
        assert trec.grads[k].dtype == getattr(torch, grad_dtype), k
        gmax = max(float(np.abs(jg).max()), 1e-30)
        err = np.abs(tg - jg)
        ok = err <= 1e-5 * gmax
        if grad_dtype == "bfloat16":
            ok |= err <= roundings * ulp * np.abs(jg)
        assert ok.all(), f"clipped grad {k}: max error {err[~ok].max()} at scale {gmax}"
        # new params: within 1e-5, or 2*lr where the gradient is rounding noise
        pe = np.abs(tnew[k].double().numpy() - np.asarray(jnew[k], np.float64))
        tiny = np.abs(jg) < 1e-6 * gmax
        assert (pe[~tiny] <= 1e-5).all(), f"param {k}: max error {pe[~tiny].max()}"
        assert (pe[tiny] <= 2 * lr + 1e-7).all(), f"param {k} (|g| ~ 0): {pe[tiny].max()}"
        assert not torch.equal(tnew[k], p0[k]) or not np.any(jg), k


def test_eval_step_is_the_loss_without_a_graph():
    cfg = _fp32(get_config("qwen2-7b", smoke=True))
    model = api.get_model(cfg, attn="plain")
    gen = torch.Generator().manual_seed(0)
    params = {k: v.requires_grad_() for k, v in api.init_params(cfg, gen).items()}
    batch = api.make_batch(cfg, ShapeCell("t", "train", 16, 2), gen)
    out = make_eval_step(model)(params, batch)
    assert not out["loss"].requires_grad
    assert torch.equal(out["loss"], model.loss(params, batch).detach())


# ---------------------------------------------------------------------------
# Grad accumulation semantics (tests/test_substrate.py:84-128)
# ---------------------------------------------------------------------------

def _value_and_grad(model, params, batch):
    names = sorted(params)
    leaves = {k: params[k].detach().requires_grad_() for k in names}
    loss = model.loss(leaves, batch)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))


def test_microbatch_accumulation_equivalence():
    """G=4 fp32-accumulated mean gradients match the full-batch gradients."""
    cfg = get_config("qwen2-7b", smoke=True)
    model = api.get_model(cfg, attn="plain")
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, gen)
    batch = api.make_batch(cfg, ShapeCell("t", "train", 16, 8), gen)
    loss_full, g_full = _value_and_grad(model, params, batch)
    G = 4
    g_acc = {k: torch.zeros(p.shape) for k, p in params.items()}
    losses = []
    for i in range(G):
        mb = {k: x.reshape((G, x.shape[0] // G) + x.shape[1:])[i] for k, x in batch.items()}
        l, g = _value_and_grad(model, params, mb)
        losses.append(float(l))
        for k in g_acc:
            g_acc[k] += g[k].float() / G
    np.testing.assert_allclose(float(loss_full), np.mean(losses), rtol=1e-2)
    for k in g_full:
        a = g_full[k].float()
        denom = max(float(a.abs().max()), 1e-6)
        assert float((a - g_acc[k]).abs().max()) / denom < 0.06, k


def test_bf16_grad_compression_still_learns():
    cfg = get_config("qwen2-7b", smoke=True)
    model = api.get_model(cfg, attn="plain")
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, gen)
    batch = api.make_batch(cfg, ShapeCell("t", "train", 16, 4), gen)
    opt = AdamW(OptimizerConfig(lr=3e-3, warmup_steps=0, weight_decay=0.0))
    state = opt.init(params)
    step = make_train_step(model, opt, microbatches=2, grad_dtype="bfloat16")
    first = None
    for _ in range(4):
        params, state, m = step(params, state, batch)
        first = first or float(m["loss"])
    assert float(m["loss"]) < first


# ---------------------------------------------------------------------------
# Per-architecture train steps (tests/test_models_smoke.py:28-72)
# ---------------------------------------------------------------------------

TRAIN_CELL = ShapeCell("t", "train", 32, 4, microbatches=2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_train_step(arch):
    cfg = get_config(arch, smoke=True)
    model = api.get_model(cfg, attn="plain")
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, gen)
    batch = api.make_batch(cfg, TRAIN_CELL, gen)

    loss = model.loss(params, batch)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), f"{arch}: non-finite loss"

    before = {k: v.clone() for k, v in params.items()}
    opt = make_optimizer(OptimizerConfig(name=cfg.optimizer, lr=1e-3, warmup_steps=1))
    state = opt.init(params)
    step = make_train_step(model, opt, microbatches=TRAIN_CELL.microbatches)
    new_params, new_state, metrics = step(params, state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert int(new_state["step"]) == 1
    # every parameter stays finite and at least one changed
    changed = False
    for k in before:
        assert bool(torch.isfinite(new_params[k].float()).all()), k
        assert new_params[k].dtype == before[k].dtype, k
        if not torch.equal(new_params[k], before[k]):
            changed = True
    assert changed


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_decreases(arch):
    """A few steps on one repeated batch must reduce the loss (learnability)."""
    cfg = get_config(arch, smoke=True)
    model = api.get_model(cfg, attn="plain")
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, gen)
    batch = api.make_batch(cfg, TRAIN_CELL, gen)
    opt = make_optimizer(OptimizerConfig(name=cfg.optimizer, lr=3e-3, warmup_steps=0,
                                         weight_decay=0.0))
    state = opt.init(params)
    step = make_train_step(model, opt)
    first = None
    for _ in range(5):
        params, state, m = step(params, state, batch)
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < first, f"{arch}: loss did not decrease"


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b", "falcon-mamba-7b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    cfg = _fp32(get_config(arch, smoke=True))
    gen = torch.Generator().manual_seed(1)
    params = api.init_params(cfg, gen)
    batch = api.make_batch(cfg, ShapeCell("t", "train", 32, 2), gen)
    out = {}
    for policy in ("none", "nothing", "dots"):
        model = api.get_model(cfg, attn="plain", remat_policy=policy)
        assert model.remat_policy == policy
        out[policy] = _value_and_grad(model, params, batch)
    loss0, g0 = out["none"]
    for policy in ("nothing", "dots"):
        loss, g = out[policy]
        assert torch.equal(loss, loss0), policy
        for k in g0:
            assert torch.equal(g[k], g0[k]), (policy, k)
    with pytest.raises(ValueError, match="remat policy"):
        api.get_model(cfg, remat_policy="everything")


def _saved_numels(fn, *args):
    """numel of every floating-point tensor autograd saves for the backward
    pass of fn(*args)."""
    sizes = []

    def pack(t):
        if t.dtype.is_floating_point:
            sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*args)
    return out, sizes


def test_chunked_cross_entropy_keeps_no_chunk_logits():
    """Only the inputs are saved; each chunk's (B, chunk, V) float32 logits
    are recomputed in the backward pass, as the reference's checkpointed chunk
    body does (``src/repro/models/layers.py:448``). The loss and the gradients
    equal an unchunked float32 cross-entropy's."""
    B, S, d, V, chunk = 2, 64, 8, 512, 16
    gen = torch.Generator().manual_seed(2)
    h = torch.randn(B, S, d, generator=gen, requires_grad=True)
    w = torch.randn(d, V, generator=gen, requires_grad=True)
    labels = torch.randint(-1, V, (B, S), generator=gen)
    loss, sizes = _saved_numels(lambda: L.chunked_cross_entropy(h, w, labels, chunk=chunk))
    assert max(sizes) < B * chunk * V, sizes
    gh, gw = torch.autograd.grad(loss, [h, w])
    logits = h @ w
    valid = labels >= 0
    want = torch.nn.functional.cross_entropy(logits[valid], labels[valid])
    wh, ww = torch.autograd.grad(want, [h, w])
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gh, wh, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(gw, ww, rtol=1e-5, atol=1e-7)


def test_chunked_attention_keeps_no_score_block():
    """The chunked path (S > 2048) saves the (m, l, o) accumulators and not
    the (B, H, chunk_q, chunk_kv) score blocks; its gradients equal the
    unchunked path's."""
    B, S, H, D, c = 1, 2304, 2, 4, 256
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(B, S, H, D, generator=gen, requires_grad=True) for _ in range(3))
    out, sizes = _saved_numels(lambda: L.attention(q, k, v, causal=True, chunk_q=c, chunk_kv=c))
    assert max(sizes) < B * H * c * c, sorted(sizes)[-5:]
    grads = torch.autograd.grad(out.square().sum(), [q, k, v])
    scale = 1.0 / D ** 0.5
    s = torch.einsum("bqhd,bshd->bhqs", q, k) * scale
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, torch.autograd.grad(want.square().sum(), [q, k, v])):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# MoE dispatch groups (tests/test_substrate.py:286-332)
# ---------------------------------------------------------------------------

def _moe_inputs(seed, B, S, d, f, E):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    router = rng.standard_normal((d, E)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    return [x, router, *ws]


@pytest.mark.parametrize("G", [1, 2, 4])
def test_moe_groups_match_jax(G):
    """Group-local dispatch at tight capacity (tokens drop) equals the
    reference's ``moe_block`` (``ws=None``) with the same groups."""
    args = _moe_inputs(G, 2, 16, 8, 16, 4)
    want, waux = jlayers.moe_block(*map(jnp.asarray, args), top_k=2, capacity_factor=1.0,
                                   n_groups=G)
    got, aux = L.moe_block(*map(torch.from_numpy, args), top_k=2, capacity_factor=1.0,
                           n_groups=G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_moe_group_local_dispatch_equivalence():
    """With ample capacity, group-local dispatch computes the same function as
    global dispatch."""
    x, router, wg, wu, wd = map(torch.from_numpy, _moe_inputs(3, 2, 16, 8, 16, 4))
    y1, aux1 = L.moe_block(x, router, wg, wu, wd, top_k=2, capacity_factor=8.0, n_groups=1)
    y4, aux4 = L.moe_block(x, router, wg, wu, wd, top_k=2, capacity_factor=8.0, n_groups=4)
    np.testing.assert_allclose(y1.numpy(), y4.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux1), float(aux4), rtol=1e-5)


def test_moe_matches_dense_reference_ample_capacity():
    """Scatter dispatch == per-token dense gating when nothing drops."""
    B, S, d, f, E, k = 1, 8, 4, 8, 4, 2
    x, router, wg, wu, wd = map(torch.from_numpy, _moe_inputs(9, B, S, d, f, E))
    got, _ = L.moe_block(x, router, wg, wu, wd, top_k=k, capacity_factor=16.0)
    probs = torch.softmax(x.reshape(-1, d) @ router, dim=-1).numpy()
    want = np.zeros((B * S, d), np.float32)
    for t in range(B * S):
        idx = np.argsort(-probs[t])[:k]
        w = probs[t][idx] / probs[t][idx].sum()
        for e, wi in zip(idx, w):
            h = x.reshape(-1, d)[t].numpy()
            g = h @ wg[e].numpy()
            u = h @ wu[e].numpy()
            silu = g / (1 + np.exp(-g))
            want[t] += wi * ((silu * u) @ wd[e].numpy())
    np.testing.assert_allclose(got.reshape(-1, d).numpy(), want, rtol=2e-4, atol=2e-4)


def test_transformer_dispatches_in_one_group_on_one_device():
    model = api.get_model(get_config("mixtral-8x7b", smoke=True))
    assert model._dp_degree() == 1


# ---------------------------------------------------------------------------
# Data pipeline (tests/test_substrate.py:135-152)
# ---------------------------------------------------------------------------

def test_data_determinism_and_restart():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=4, seed=3)
    d1 = SyntheticTokens(cfg)
    b5 = d1.batch_at(5)
    d2 = SyntheticTokens(cfg)
    np.testing.assert_array_equal(d2.batch_at(5)["tokens"], b5["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b5["tokens"][:, 1:], b5["labels"][:, :-1])
    # host sharding covers distinct data
    ca = DataConfig(vocab=100, seq_len=16, global_batch=4, seed=3, n_hosts=2, host_index=0)
    cb = DataConfig(vocab=100, seq_len=16, global_batch=4, seed=3, n_hosts=2, host_index=1)
    assert not np.array_equal(SyntheticTokens(ca).batch_at(0)["tokens"],
                              SyntheticTokens(cb).batch_at(0)["tokens"])


def test_data_matches_the_reference_stream():
    from repro.data.pipeline import DataConfig as JDataConfig, SyntheticTokens as JTokens
    kw = dict(vocab=1000, seq_len=32, global_batch=4, seed=7)
    ours, theirs = SyntheticTokens(DataConfig(**kw)), JTokens(JDataConfig(**kw))
    for step in (0, 3, 8):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_iterator():
    it = PrefetchIterator(iter([1, 2, 3]), prefetch=2)
    assert list(it) == [1, 2, 3]


# ---------------------------------------------------------------------------
# Straggler mitigation (tests/test_substrate.py:212-243)
# ---------------------------------------------------------------------------

def test_speculative_map_resubmits_straggler():
    calls = {"n": 0}
    lock = threading.Lock()
    first_stuck = threading.Event()

    def task(x):
        with lock:
            calls["n"] += 1
            mine = calls["n"]
        if x == 1 and mine == 2:        # first attempt of item 1 hangs
            first_stuck.wait(5.0)
            return -1
        return x * 10

    out = speculative_map(task, [0, 1, 2], timeout=0.2, workers=4)
    first_stuck.set()
    assert out == [0, 10, 20]
    assert calls["n"] >= 4              # at least one speculative resubmission


def test_speculative_map_propagates_hard_failure():
    def bad(x):
        raise ValueError("boom")

    with pytest.raises(ValueError):
        speculative_map(bad, [1], timeout=0.05, workers=2, max_attempts=2)
