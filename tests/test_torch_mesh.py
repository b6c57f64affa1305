"""The port's device mesh (``repro_torch.launch.mesh``, the mesh half of
``sharding/rules.py``, ``layers.decode_attention_sp``, the transformer and
train step on DTensors) against the JAX package, on the CPU.

* The reference's rule cases (``tests/test_distributed.py:35-64``) run against
  the port; every parameter's spec equals the reference's for every arch.
* ``decode_attention_sp`` on a real (2, 2) gloo mesh (B 4, H 8, Kv 2, D 16,
  S 64, t 37, float32) matches the port's ``layers.attention`` and the JAX
  dense attention on the same numpy inputs within 2e-5; with a window it
  matches the reference's own ``decode_attention_sp`` (a JAX subprocess on 4
  forced host devices), which keeps one key fewer than the dense path.
* One train step of the qwen2-7b smoke model on a (2, 2) mesh against the
  port's one-device step and the JAX one-device step from the same numpy
  params: the reference's tolerances in bfloat16 (loss 1e-2, grad norm 5e-2
  and Σ|embed| 1e-2 relative) and 1e-5 in float32 (loss and grad norm; every
  new parameter within 1e-5 of its tensor's max, but for Adam's first step
  where a gradient is zero but for rounding, ``_params_close``); on a (1, 4)
  mesh with 2 heads (the tp axis does not divide them, so attention splits
  its query rows) within 1e-5 too.
* mixtral smoke on a (2, 2, 2) mesh with ``fsdp_over_pod``: a finite loss
  equal to the one-device step with as many MoE groups as data shards.

Ranks are spawned CPU processes joined through a ``FileStore`` in
``tmp_path`` (``_torch_ranks.spawn``), each group with its own timeout.
"""

import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import _torch_ranks as R
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.optim.optimizers import AdamW as JAdamW, OptimizerConfig as JOptimizerConfig
from repro.sharding import rules as jrules
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.mesh import HW, make_local_mesh
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.optim.optimizers import AdamW, OptimizerConfig
from repro_torch.sharding.rules import (PartitionSpec, ShardingRules, logical_to_spec, safe_entry,
                                        safe_spec, spec_placements)
from repro_torch.train.step import make_train_step

REPO = os.path.join(os.path.dirname(__file__), "..")


def _mesh(shape, names):
    """The two attributes of a DeviceMesh the rules read (its axis names and
    its rank array's shape), with no process group behind them."""
    return types.SimpleNamespace(mesh_dim_names=names, mesh=torch.zeros(shape))


def _fake_mesh_script(world, body):
    """``body`` run in a subprocess as rank 0 of a fake group of ``world``."""
    script = textwrap.dedent("""
        import os; os.nice(10)
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=%d)
    """ % world) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


# ---------------------------------------------------------------------------
# Rules (tests/test_distributed.py:35-64)
# ---------------------------------------------------------------------------

def test_rules_resolution():
    r = ShardingRules(batch=("pod", "data"), fsdp=("data",))
    assert logical_to_spec(("batch", None, "tp"), r) == PartitionSpec(("pod", "data"), None,
                                                                      "model")
    assert logical_to_spec((None,), r) == PartitionSpec(None)
    jr = jrules.ShardingRules(batch=("pod", "data"), fsdp=("data",))
    assert tuple(logical_to_spec(("batch", None, "tp"), r)) == tuple(
        jrules.logical_to_spec(("batch", None, "tp"), jr)) == tuple(JP(("pod", "data"), None,
                                                                     "model"))


def test_safe_spec_drops_nondivisible():
    out = _fake_mesh_script(8, """
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.sharding.rules import ShardingRules, safe_spec
        mesh = make_local_mesh(4, 2, device_type="cpu")
        rules = ShardingRules.for_mesh(mesh)
        print(safe_spec(mesh, ("batch", "tp"), rules, (8, 6)))
        print(safe_spec(mesh, ("batch", "tp"), rules, (1, 7)))
    """)
    lines = out.strip().splitlines()
    assert "'data'" in lines[0] and "'model'" in lines[0]
    assert lines[1] == "PartitionSpec(None, None)"
    mesh = _mesh((4, 2), ("data", "model"))
    rules = ShardingRules.for_mesh(mesh)
    s1 = safe_spec(mesh, ("batch", "tp"), rules, (8, 6))   # 6 % 2 == 0 -> keep
    s2 = safe_spec(mesh, ("batch", "tp"), rules, (1, 7))   # drop both
    assert s1 == PartitionSpec("data", "model")
    assert repr(s2) == "PartitionSpec(None, None)"
    assert safe_entry(mesh, rules, "batch", 6) is None and safe_entry(mesh, rules, "tp", 6) == "model"
    from torch.distributed.tensor import Replicate, Shard
    assert spec_placements(mesh, s1) == (Shard(0), Shard(1))
    assert spec_placements(mesh, s2) == (Replicate(), Replicate())


def test_pod_data_dim_is_sharded_on_both_mesh_dims():
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    rules = ShardingRules.for_mesh(mesh, fsdp_over_pod=True)
    assert rules.batch == rules.fsdp == ("pod", "data")
    from torch.distributed.tensor import Replicate, Shard
    spec = safe_spec(mesh, (None, "fsdp", "tp"), rules, (2, 8, 4))
    assert spec_placements(mesh, spec) == (Shard(1), Shard(1), Shard(2))
    assert spec_placements(mesh, safe_spec(mesh, ("batch",), rules, (6,))) == (Replicate(),) * 3


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_params_and_optimizer_state_are_made_in_their_shards(name):
    # a rank draws each parameter whole and keeps its shard, and makes only
    # its own shard of every moment: the same pieces as distributing the
    # whole values, which no rank holds at once
    out = _fake_mesh_script(4, """
        import torch
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import api
        from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
        from repro_torch.sharding.rules import ShardingRules, spec_tree_shardings
        cfg = get_config("qwen2-7b", smoke=True)
        mesh = make_local_mesh(2, 2, device_type="cpu")
        rules = ShardingRules.for_mesh(mesh)
        p_sh = api.param_shardings(cfg, mesh, rules)
        params = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                 shardings=p_sh)
        want = api.distribute(api.init_params(cfg, torch.Generator().manual_seed(0),
                                              device="cpu"), p_sh)
        for k, v in params.items():
            assert v.placements == want[k].placements, k
            assert torch.equal(v.to_local(), want[k].to_local()), k
        opt = make_optimizer(OptimizerConfig(name="%s", factored_min_dim=8))
        o_sh = spec_tree_shardings(opt.state_templates(api.get_model(cfg).param_templates()),
                                   mesh, rules)
        state = opt.init(params, o_sh)
        whole = opt.init({k: torch.zeros(v.shape, dtype=v.dtype) for k, v in params.items()})
        n = sharded = 0
        for part, leaves in state.items():
            if part == "step":
                continue
            assert set(leaves) == set(whole[part]), part
            for k, v in leaves.items():
                ref = o_sh[part][k].distribute(whole[part][k])
                assert isinstance(v, DTensor) and v.placements == ref.placements, (part, k)
                assert v.shape == ref.shape and v.dtype == ref.dtype, (part, k)
                assert v.to_local().shape == ref.to_local().shape, (part, k)
                assert not v.to_local().any(), (part, k)
                n += 1
                sharded += v.to_local().numel() < v.numel()
        print(n, sharded, len(state.get("vr", {})))
    """ % name)
    n, sharded, factored = map(int, out.split())
    assert n and sharded
    assert (factored > 0) == (name == "adafactor")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_shardings_cover_all_archs(arch):
    cfg = get_config(arch)
    jt = japi.get_model(jax_get_config(arch)).param_templates()
    mesh = _mesh((16, 16), ("data", "model"))
    for rules, jr in ((ShardingRules.for_mesh(mesh), jrules.ShardingRules()),
                      (ShardingRules(batch=("pod", "data"), fsdp=("pod", "data")),
                       jrules.ShardingRules(batch=("pod", "data"), fsdp=("pod", "data")))):
        for name, spec in api.get_model(cfg).param_templates().items():
            assert len(spec.axes) == len(spec.shape), (arch, name)
            if spec.stacked:
                assert spec.axes[0] is None, (arch, name)  # layer dim unsharded
            assert tuple(spec.spec(rules)) == tuple(jt[name].spec(jr)), (arch, name)
    assert spec.sds.device.type == "meta" and tuple(spec.sds.shape) == spec.shape


def test_production_mesh_constants_are_the_h100s():
    assert HW.PEAK_FLOPS_BF16 == 989e12 and HW.HBM_BW == 3.35e12 and HW.HBM_BYTES == 80e9
    assert HW.LINK_BW == 50e9


def test_ssm_and_whisper_refuse_a_mesh():
    """Once refused, now built: ``get_model`` builds all ten archs on a (1, 1)
    mesh (a one-rank gloo group in this process), every family keeping the
    mesh, and the SSM and Whisper families' prefill there gives the one-device
    logits bit for bit."""
    mesh = make_local_mesh(1, 1, device_type="cpu")
    rules = ShardingRules.for_mesh(mesh)
    for arch in ARCH_IDS:
        cfg = R._fp32(get_config(arch, smoke=True))
        model = api.get_model(cfg, attn="plain", mesh=mesh, rules=rules)
        assert model.mesh is mesh and model.rules == rules and model.sharded, arch
        if cfg.family not in ("ssm", "hybrid", "encdec"):
            continue
        params = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        batch = api.make_batch(cfg, ShapeCell("p", "prefill", 8, 2),
                               torch.Generator().manual_seed(1), device="cpu")
        want, _ = api.get_model(cfg, attn="plain").prefill(params, batch)
        got, cache = model.prefill(api.distribute(params, api.param_shardings(cfg, mesh, rules)),
                                   {k: api.distribute(v, api.input_shardings(
                                       cfg, ShapeCell("p", "prefill", 8, 2), mesh, rules)[k])
                                    for k, v in batch.items()})
        assert torch.equal(got.full_tensor(), want), arch


def test_mesh_needs_a_group_of_its_size_and_a_card_for_cuda():
    # (a one-rank group may be up in this process: a (1, 1) mesh starts one)
    with pytest.raises((RuntimeError, ValueError), match="4 ranks"):
        make_local_mesh(2, 2, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            make_local_mesh(1, 1)


# ---------------------------------------------------------------------------
# decode_attention_sp (tests/test_distributed.py:117-143)
# ---------------------------------------------------------------------------

def _jax_sp_window(q, kc, vc, t, window, tmp_path):
    """The reference's decode_attention_sp on a (2, 2) mesh of forced host
    devices (a subprocess: the device count is fixed at JAX's first use)."""
    np.savez(tmp_path / "sp_in.npz", q=q, kc=kc, vc=vc)
    script = textwrap.dedent(f"""
        import os; os.nice(10)
        import numpy as np, jax, jax.numpy as jnp
        from repro.launch.mesh import make_local_mesh
        from repro.models import layers as L
        z = np.load({str(tmp_path / 'sp_in.npz')!r})
        mesh = make_local_mesh(2, 2)
        out = jax.jit(lambda q, k, v: L.decode_attention_sp(
            q, k, v, jnp.int32({t}), mesh=mesh, sp_axis="model", batch_axes=("data",),
            window={window}))(z["q"], z["kc"], z["vc"])
        np.save({str(tmp_path / 'sp_out.npy')!r}, np.asarray(out))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=180, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return np.load(tmp_path / "sp_out.npy")


def test_decode_attention_sp_matches_dense_attention(tmp_path):
    B, H, Kv, D, S, t = 4, 8, 2, 16, 64, 37
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kc = rng.standard_normal((B, S, Kv, D), dtype=np.float32)
    vc = rng.standard_normal((B, S, Kv, D), dtype=np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kc, vc))
    window = 8
    res = R.spawn(R.decode_sp, 4, tmp_path, tq, tk, tv, t, (0, window), timeout=300)[0]
    got, got_w = res[0].numpy(), res[window].numpy()
    port = L.attention(tq[:, None], L.repeat_kv(tk, H), L.repeat_kv(tv, H), causal=True,
                       q_offset=t - 1)[:, 0].numpy()
    ref = np.asarray(jlayers.attention(jnp.asarray(q)[:, None],
                                       jlayers.repeat_kv(jnp.asarray(kc), H),
                                       jlayers.repeat_kv(jnp.asarray(vc), H),
                                       causal=True, q_offset=t - 1)[:, 0])
    np.testing.assert_allclose(got, port, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    # with a window the reference's sp path keeps keys in (t - window, t), its
    # dense path keys in (t - 1 - window, t): the port keeps the sp meaning,
    # which is the dense path's with a window one shorter
    np.testing.assert_allclose(got_w, _jax_sp_window(q, kc, vc, t, window, tmp_path),
                               rtol=2e-5, atol=2e-5)
    dense_w = L.attention(tq[:, None], L.repeat_kv(tk, H), L.repeat_kv(tv, H), causal=True,
                          q_offset=t - 1, window=window - 1)[:, 0].numpy()
    np.testing.assert_allclose(got_w, dense_w, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Sharded train step (tests/test_distributed.py:146-183)
# ---------------------------------------------------------------------------

def _jax_setup(arch, fp32, batch_rows=4, microbatches=2):
    jcfg = jax_get_config(arch, smoke=True)
    if fp32:
        import dataclasses
        jcfg = dataclasses.replace(jcfg, param_dtype="float32", act_dtype="float32")
    key = jax.random.PRNGKey(0)
    jp = japi.init_params(jcfg, key)
    jb = japi.make_batch(jcfg, JaxShapeCell("t", "train", 16, batch_rows,
                                            microbatches=microbatches), key)
    return jcfg, jp, jb


def _jax_step(jcfg, jp, jb, microbatches=2):
    opt = JAdamW(JOptimizerConfig(lr=1e-2, warmup_steps=0))
    step = jax.jit(jax_make_train_step(japi.get_model(jcfg), opt, microbatches=microbatches))
    p, _, m = step(jp, opt.init(jp), jb)
    return p, {"loss": float(m["loss"]), "gn": float(m["grad_norm"]),
               "w0": float(jnp.sum(jnp.abs(p["embed"].astype(jnp.float32))))}


def _port_step(cfg, params, batch, n_groups=None, microbatches=2):
    model = api.get_model(cfg, attn="plain")
    if n_groups is not None:
        model._dp_degree = lambda: n_groups
    opt = AdamW(OptimizerConfig(lr=1e-2, warmup_steps=0))
    params = {k: v.clone() for k, v in params.items()}
    p, _, m = make_train_step(model, opt, microbatches=microbatches)(params, opt.init(params),
                                                                     batch)
    return p, {"loss": float(m["loss"]), "gn": float(m["grad_norm"]),
               "w0": float(p["embed"].float().abs().sum())}


def _grads(cfg, params, batch):
    """The one-device gradient of the mean loss (float32)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = api.get_model(cfg, attn="plain").loss(leaves, batch)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _params_close(got, want, grads, lr=1e-2):
    """Every new parameter within 1e-5 of its tensor's max, except where the
    gradient is under 1e-6 of its tensor's max or under 1e-6 at all (a
    hundred times Adam's eps): there Adam's first step, lr·g/(|g| + eps),
    turns the rounding of a gradient that is zero but for rounding into a
    step of up to ±lr (bound 2·lr; ``tests/test_torch_train.py`` bounds the
    one-device step so too)."""
    for k, v in want.items():
        scale = max(float(v.abs().max()), 1e-30)
        g = grads[k].abs()
        tiny = g < max(1e-6 * float(g.max()), 1e-6)
        err = (got[k] - v).abs()
        assert float(torch.where(tiny, 0.0, err).max()) <= 1e-5 * scale, k
        assert float(torch.where(tiny, err, 0.0).max()) <= 2 * lr, k


def _close(got, want, what):
    assert abs(got["loss"] - want["loss"]) < 1e-2, what
    assert abs(got["gn"] - want["gn"]) / want["gn"] < 5e-2, what
    assert abs(got["w0"] - want["w0"]) / want["w0"] < 1e-2, what


def test_sharded_train_step_matches_single_device(tmp_path):
    import dataclasses
    paths, one, ref = {}, {}, {}
    for fp32 in (False, True):
        jcfg, jp, jb = _jax_setup("qwen2-7b", fp32)
        params = api.params_from_reference({k: np.asarray(v) for k, v in jp.items()}, "cpu")
        batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        paths[fp32] = str(tmp_path / f"params-{fp32}.pt")
        torch.save(params, paths[fp32])
        ref[fp32] = _jax_step(jcfg, jp, jb)[1]
        one[fp32] = _port_step(get_config("qwen2-7b", smoke=True) if not fp32 else
                               R._fp32(get_config("qwen2-7b", smoke=True)), params, batch)
    two_heads = {"n_heads": 2, "n_kv_heads": 1, "head_dim": 32}
    cfg2 = dataclasses.replace(R._fp32(get_config("qwen2-7b", smoke=True)), **two_heads)
    jcfg2 = dataclasses.replace(jax_get_config("qwen2-7b", smoke=True), param_dtype="float32",
                                act_dtype="float32", **two_heads)
    jp2 = japi.init_params(jcfg2, jax.random.PRNGKey(0))
    p2 = api.params_from_reference({k: np.asarray(v) for k, v in jp2.items()}, "cpu")
    paths["two_heads"] = str(tmp_path / "params-2h.pt")
    torch.save(p2, paths["two_heads"])
    one_2h = _port_step(cfg2, p2, batch)

    cases = [((2, 2), False, False, None), ((2, 2), False, True, None),
             ((1, 4), False, "two_heads", two_heads)]
    res = R.spawn(R.train_step, 4, tmp_path, "qwen2-7b", paths, batch,
                  [(s, o, f, kw) for s, o, f, kw in cases], timeout=300)
    bf, f32, rows = res[0]
    _close(bf, ref[False], "bf16 (2,2) vs JAX")
    _close(bf, one[False][1], "bf16 (2,2) vs port")
    cfg32 = R._fp32(get_config("qwen2-7b", smoke=True))
    for got, (pw, mw), g in ((f32, one[True], _grads(cfg32, torch.load(paths[True]), batch)),
                             (rows, one_2h, _grads(cfg2, p2, batch))):
        assert abs(got["loss"] - mw["loss"]) <= 1e-5 * abs(mw["loss"])
        assert abs(got["gn"] - mw["gn"]) <= 1e-5 * abs(mw["gn"])
        _params_close(got["params"], pw, g)
    _close(f32, ref[True], "f32 (2,2) vs JAX")
    assert all(r[0]["loss"] == bf["loss"] for r in res)  # every rank sees one loss
    # wq (L, d, H·hd): FSDP on data, TP on model, after the optimizer's update
    assert f32["placement"] == "(Shard(dim=1), Shard(dim=2))"


def test_mini_multipod_matches_single_device(tmp_path):
    jcfg, jp, jb = _jax_setup("mixtral-8x7b", False, batch_rows=8)
    params = api.params_from_reference({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    path = str(tmp_path / "params.pt")
    torch.save(params, path)
    cfg = get_config("mixtral-8x7b", smoke=True)
    # the mesh dispatches one MoE group per data shard: (pod 2 x data 2)
    _, want = _port_step(cfg, params, batch, n_groups=4)
    res = R.spawn(R.train_step, 8, tmp_path, "mixtral-8x7b", {False: path}, batch,
                  [((2, 2, 2), True, False, None)], timeout=360)
    got = res[0][0]
    assert np.isfinite(got["loss"])
    _close(got, want, "mixtral (2,2,2) vs port")
    _close(got, _jax_step(jcfg, jp, jb)[1], "mixtral (2,2,2) vs JAX")
