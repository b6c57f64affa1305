"""The port's state-space models (``repro_torch.models.ssm``: ``MambaLM`` for
falcon-mamba-7b, ``Zamba2LM`` for zamba2-2.7b) against the JAX package's
(``repro.models.ssm``), on the CPU.

At each smoke config in float32 (``param_dtype = act_dtype = "float32"``) the
JAX ``init_params`` output crosses through ``params_from_reference`` and the
batch through numpy; ``loss``, prefill logits, every cache entry and one
``decode_step`` must agree within 1e-4 (float32 sums in another order, and the
port's doubling scan combines in another tree than ``associative_scan``; the
observed gap is about 1e-7). The building blocks (``_causal_conv``,
``_conv_step``, ``_selective_scan``, ``_ssd``) are held to their JAX functions
on seeded numpy inputs at the same tolerance. The bf16 prefill→decode check
uses ``tests/test_models_smoke.py:106``'s 2e-2.
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
from repro.models import ssm as jssm
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import _build
from repro_torch.models import api, ssm
from repro_torch.serve.engine import ServeEngine

SSMS = ["falcon-mamba-7b", "zamba2-2.7b"]
TOL = 1e-4
TRAIN = (2, 32)     # (B, S) of the loss batch: 4 chunks of the smoke chunk 8
PREFILL = (2, 20)   # S 20 is not a multiple of the smoke chunk 8: chunks of 4


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _grow_jax(model, cache, growing, extra):
    """The JAX cache with ``growing`` entries padded along their "sp" axis."""
    out = dict(cache)
    tmpl = model.cache_templates(1, 8)
    for k in growing:
        pad = [(0, 0)] * cache[k].ndim
        pad[tmpl[k].axes.index("sp")] = (0, extra)
        out[k] = jnp.pad(cache[k], pad)
    return out


@pytest.fixture(scope="module", params=SSMS)
def pair(request):
    """(arch, JAX cfg, port cfg, JAX params, port params), float32."""
    arch = request.param
    jcfg = _fp32(jax_get_config(arch, smoke=True))
    tcfg = _fp32(get_config(arch, smoke=True))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = api.params_from_reference({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return arch, jcfg, tcfg, jp, tp


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
    assert tcache.keys() == jcache.keys()
    for k in jcache:
        if k != "len":
            assert tuple(tcache[k].shape) == jcache[k].shape, k
            assert str(tcache[k].dtype).split(".")[-1] == jcache[k].dtype.name, k
            _close(tcache[k], jcache[k])
    assert tcache["len"] == int(jcache["len"]) == S

    nxt = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
    jgrown = _grow_jax(jm, jcache, tm.GROWING_CACHE, 1)
    jlog2, jcache2 = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jgrown)
    eng = ServeEngine(tcfg, tp, device="cpu")
    grown = eng._pad_cache(tcache, 1)
    tlog2, tcache2 = tm.decode_step(tp, {"tokens": torch.from_numpy(nxt)}, grown)
    _close(tlog2, jlog2)
    for k in jcache2:
        if k != "len":
            _close(tcache2[k], jcache2[k])
    assert tcache2["len"] == int(jcache2["len"]) == S + 1


@pytest.mark.parametrize("arch", SSMS)
def test_prefill_decode_consistency(arch):
    """Decode after prefill matches re-prefilling the longer sequence (the
    bf16 smoke config, as in tests/test_models_smoke.py:74-107)."""
    cfg = get_config(arch, smoke=True)
    model = api.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, gen)
    S = 16
    batch = api.make_batch(cfg, ShapeCell("p", "prefill", S, 2), gen)
    logits_p, cache = model.prefill(params, batch)
    assert logits_p.shape == (2, cfg.vocab) and torch.isfinite(logits_p).all()
    nxt = logits_p.argmax(-1).to(torch.int32)[:, None]
    grown = ServeEngine(cfg, params, device="cpu")._pad_cache(cache, 1)
    logits_d, _ = model.decode_step(params, {"tokens": nxt}, grown)
    logits_f, _ = model.prefill(params, {"tokens": torch.cat([batch["tokens"], nxt], dim=1)})
    np.testing.assert_allclose(logits_d.numpy(), logits_f.numpy(), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# building blocks on seeded numpy inputs
# ---------------------------------------------------------------------------

def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("B,S,C,K", [(2, 17, 12, 4), (1, 5, 8, 2), (3, 3, 6, 4)])
def test_causal_conv_matches_jax(B, S, C, K):
    rng = np.random.default_rng(B * 100 + S)
    x, w, b = _rand(rng, B, S, C), _rand(rng, C, K), _rand(rng, C)
    got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _close(got, jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), 1e-5)


@pytest.mark.parametrize("B,C,K", [(2, 12, 4), (1, 8, 2)])
def test_conv_step_matches_jax(B, C, K):
    rng = np.random.default_rng(B * 10 + C)
    x, st, w, b = _rand(rng, B, C), _rand(rng, B, K - 1, C), _rand(rng, C, K), _rand(rng, C)
    out, new = ssm._conv_step(*(torch.from_numpy(a) for a in (x, st, w, b)))
    jout, jnew = jssm._conv_step(*(jnp.asarray(a) for a in (x, st, w, b)))
    _close(out, jout, 1e-5)
    _close(new, jnew, 1e-5)


def test_conv_step_continues_causal_conv():
    """Feeding tokens one at a time through ``_conv_step`` from a zero state
    gives the full-sequence causal conv."""
    rng = np.random.default_rng(3)
    x, w, b = (torch.from_numpy(a) for a in (_rand(rng, 2, 9, 6), _rand(rng, 6, 4), _rand(rng, 6)))
    full = ssm._causal_conv(x, w, b)
    state = torch.zeros((2, 3, 6))
    for t in range(9):
        out, state = ssm._conv_step(x[:, t], state, w, b)
        torch.testing.assert_close(out, full[:, t], rtol=1e-6, atol=1e-6)


# S values: one chunk, several chunks, an S that is not a multiple of the chunk
# (the chunk halves until it divides S), and S shorter than the chunk
SCAN_CASES = [(8, 8), (32, 8), (20, 8), (24, 16), (5, 8)]


@pytest.mark.parametrize("S,chunk", SCAN_CASES)
def test_selective_scan_matches_jax(S, chunk):
    rng = np.random.default_rng(S * 7 + chunk)
    B, DI, N = 2, 6, 4
    x, Bs, Cs = _rand(rng, B, S, DI), _rand(rng, B, S, N), _rand(rng, B, S, N)
    dt = np.log1p(np.exp(_rand(rng, B, S, DI))).astype(np.float32)
    A = -np.exp(_rand(rng, DI, N, scale=0.5)).astype(np.float32)
    h0 = _rand(rng, B, DI, N)                       # a nonzero carried state
    jm = jssm.MambaLM(_fp32(jax_get_config("falcon-mamba-7b", smoke=True)))
    tm = api.get_model(_fp32(get_config("falcon-mamba-7b", smoke=True)))
    args = (x, dt, A, Bs, Cs, h0)
    jy, jh = jm._selective_scan(*(jnp.asarray(a) for a in args), chunk)
    ty, th = tm._selective_scan(*(torch.from_numpy(a) for a in args), chunk)
    _close(ty, jy)
    _close(th, jh)


def test_affine_scan_matches_a_sequential_recurrence():
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.uniform(0.1, 1.0, (2, 13, 3)).astype(np.float32))
    b = torch.from_numpy(_rand(rng, 2, 13, 3))
    aP, bP = ssm._affine_scan(a, b)
    h, prod = torch.zeros((2, 3)), torch.ones((2, 3))
    for t in range(13):
        h, prod = a[:, t] * h + b[:, t], prod * a[:, t]
        torch.testing.assert_close(bP[:, t], h, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(aP[:, t], prod, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S,chunk", SCAN_CASES)
def test_ssd_matches_jax(S, chunk):
    rng = np.random.default_rng(S * 5 + chunk)
    B, P, hd, N = 2, 3, 4, 5
    x, Bs, Cs = _rand(rng, B, S, P, hd), _rand(rng, B, S, N), _rand(rng, B, S, N)
    dt = np.log1p(np.exp(_rand(rng, B, S, P))).astype(np.float32)
    A = -np.exp(_rand(rng, P, scale=0.5)).astype(np.float32)
    h0 = _rand(rng, B, P, N, hd)
    jm = jssm.Zamba2LM(_fp32(jax_get_config("zamba2-2.7b", smoke=True)))
    tm = api.get_model(_fp32(get_config("zamba2-2.7b", smoke=True)))
    args = (x, dt, A, Bs, Cs, h0)
    jy, jh = jm._ssd(*(jnp.asarray(a) for a in args), chunk)
    ty, th = tm._ssd(*(torch.from_numpy(a) for a in args), chunk)
    _close(ty, jy)
    _close(th, jh)


# ---------------------------------------------------------------------------
# parameters, cache growth and the serving engine
# ---------------------------------------------------------------------------

def test_params_from_reference_keeps_float32_ssm_params():
    """falcon-mamba's flat dict in its bf16 config: the bf16 tensors cross
    with their 16 bits, the float32 A_log and D as float32, bit for bit."""
    jp = japi.init_params(jax_get_config("falcon-mamba-7b", smoke=True), jax.random.PRNGKey(5))
    flat = {k: np.asarray(v) for k, v in jp.items()}
    tp = api.params_from_reference(flat, "cpu")
    assert {k for k, v in flat.items() if v.dtype == np.float32} == {"blocks.A_log", "blocks.D"}
    for k, v in flat.items():
        assert tp[k].shape == v.shape
        if v.dtype == np.float32:
            assert tp[k].dtype == torch.float32 and np.array_equal(tp[k].numpy(), v), k
        else:
            assert tp[k].dtype == torch.bfloat16, k
            assert (tp[k].view(torch.int16).numpy() == v.view(np.int16)).all(), k


@pytest.mark.parametrize("arch,grows", [("falcon-mamba-7b", set()),
                                        ("zamba2-2.7b", {"attn_k", "attn_v"})])
def test_pad_cache_grows_only_the_attention_cache(arch, grows):
    """The engine grows the shared block's K/V along their sequence axis and
    leaves the O(1) SSM and conv states as they are; falcon-mamba's cache has
    the same bytes at every prompt length."""
    cfg = get_config(arch, smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(1))
    eng = ServeEngine(cfg, params, device="cpu")
    sizes = {}
    for S in (8, 24):
        toks = torch.randint(1, cfg.vocab, (2, S), generator=torch.Generator().manual_seed(S))
        _, cache = eng.model.prefill(params, {"tokens": toks})
        grown = eng._pad_cache(cache, 5)
        for k, v in cache.items():
            if k == "len":
                continue
            if k in grows:
                assert grown[k].shape[2] == v.shape[2] + 5, k
                assert torch.equal(grown[k][:, :, :S], v) and not grown[k][:, :, S:].any()
            else:
                assert grown[k] is v, k
        sizes[S] = sum(v.numel() * v.element_size() for k, v in grown.items() if k != "len")
    assert (sizes[8] == sizes[24]) == (not grows)


SEED = 5          # top-2 margin >= 4.1e-3 at every greedy step below, both models
MARGIN = 1e-3


@pytest.mark.parametrize("arch", SSMS)
def test_generate_matches_jax_engine(arch):
    """Greedy tokens of the port's engine equal the JAX engine's; the port's
    top-2 logit margin stays above 1e-3 at every step, far above the float32
    gap between the packages."""
    jcfg = _fp32(jax_get_config(arch, smoke=True))
    tcfg = _fp32(get_config(arch, smoke=True))
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
    prompts = np.random.default_rng(SEED).integers(1, tcfg.vocab, (3, 16)).astype(np.int32)
    before = _build.launch_counts()
    got = eng.generate(prompts, 6)
    assert _build.launch_counts() == before  # the CPU path launches nothing
    want = JaxServeEngine(jcfg, jp).generate(prompts, 6)
    assert len(margins) == 6 and min(margins) > MARGIN
    assert got.tokens.shape == (3, 22) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_zamba2_flash_and_plain_agree_on_the_cpu():
    """Under attn="flash" the shared block's full-sequence attention takes the
    kernel's plain version on CPU tensors: both engines give one prefill."""
    cfg = _fp32(get_config("zamba2-2.7b", smoke=True))
    params = api.init_params(cfg, torch.Generator().manual_seed(8))
    toks = torch.randint(1, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(9))
    lf, cf = api.get_model(cfg, attn="flash").prefill(params, {"tokens": toks})
    lp, cp = api.get_model(cfg, attn="plain").prefill(params, {"tokens": toks})
    torch.testing.assert_close(lf, lp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cf["attn_k"], cp["attn_k"])


def test_falcon_mamba_fine_tune_cold_starts_from_the_store(tmp_path):
    """The path of the card's family phase, at smoke size on the CPU: a
    falcon-mamba base and a fine-tune written by ``write_repo`` (bf16 tensors
    as BF16, the float32 ``A_log`` and ``D`` as F32), ingested, the fine-tune
    BitX-coded against its declared base (4-byte words for the float32
    tensors), then cold-started bit-equal and served."""
    from repro_torch.core.bitx import TorchBackend
    from repro_torch.core.pipeline import ZLLMStore
    from repro_torch.corpus import CorpusSpec, make_finetune, write_repo
    from repro_torch.formats import safetensors as st

    cfg = get_config("falcon-mamba-7b", smoke=True)
    gen = torch.Generator().manual_seed(2)
    base = api.init_params(cfg, gen)
    ft = make_finetune(base, CorpusSpec(untouched_prob=0.0), gen)
    hub = tmp_path / "hub"
    write_repo(str(hub), "org/mamba", {f"params/{k}": v for k, v in base.items()})
    write_repo(str(hub), "u/mamba-ft", {f"params/{k}": v for k, v in ft.items()},
               base_model="org/mamba")
    infos, _, _ = st.read_header(str(hub / "u/mamba-ft" / "model.safetensors"))
    tags = {ti.name: ti.dtype_str for ti in infos}
    assert tags["params/blocks.A_log"] == tags["params/blocks.D"] == "F32"
    assert tags["params/embed"] == "BF16"
    store = ZLLMStore(str(tmp_path / "store"), backend=TorchBackend(device="cpu"))
    try:
        store.ingest_repo(str(hub / "org/mamba"), "org/mamba")
        res = store.ingest_repo(str(hub / "u/mamba-ft"), "u/mamba-ft")[0]
        assert res.base_id == "org/mamba" and res.n_bitx == len(ft)
        eng = ServeEngine.from_store(store, "u/mamba-ft", "model.safetensors", cfg, device="cpu")
    finally:
        store.close()
    assert eng.params.keys() == ft.keys()
    for k, t in ft.items():
        got = eng.params[k]
        assert got.dtype == t.dtype and got.shape == t.shape, k
        bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits), t.view(bits)), k
    out = eng.generate(np.array([[3, 1, 4, 1, 5]], np.int32), 4).tokens
    assert out.shape == (1, 9) and ((0 <= out) & (out < cfg.vocab)).all()
