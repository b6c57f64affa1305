"""The SSM and Whisper families on the port's device mesh (falcon-mamba-7b,
zamba2-2.7b, whisper-medium: ``MambaLM``, ``Zamba2LM``, ``WhisperModel`` on
DTensors) and the repaired ``layers.decode_attention_sp``, against the
one-device port and the JAX package, on the CPU.

* ``decode_attention_sp`` over a cache whose length the model axis does not
  divide (S 17 and 161 on 2 ranks, S 5 on 4: DTensor gives the last ranks
  shorter chunks, or none) matches ``layers.attention`` within 2e-5, with the
  query inside the last shard and masked keys in both shards, with and
  without a window; ``ServeEngine`` on a (1, 2) mesh gives the one-device
  tokens, and decode logits within 1e-5, for a prompt of 12 and 5 new tokens
  (a grown cache of 17).
* One train step of each family's smoke model on a (2, 2) mesh against the
  port's one-device step and the JAX one-device step from the same numpy
  params and batch: the reference's tolerances in bfloat16 (loss 1e-2, grad
  norm 5e-2, Σ|embed| 1e-2 relative); in float32 loss and grad norm within
  1e-5 and every new parameter within 1e-5 of its tensor's max (where Adam's
  first step does not blow a gradient that is zero but for rounding up to
  ±lr: :func:`_params_close`); zamba2 also on (1, 4), its gated norm and
  SSD heads split four ways.
* Prefill and four decode steps of each family on a (2, 2) mesh, float32:
  the logits and every cache entry within 1e-5 of the one-device port; for
  zamba2 and Whisper also of the reference's own sharded ``prefill`` and
  ``decode_step`` on a (2, 2) mesh of 4 forced host devices.
* ``ServeEngine.from_store`` on a (1, 2) mesh gives the one-device engine's
  greedy tokens and decode logits (within 1e-5) for each family; ``Trainer(mesh_shape=(2, 2))`` of
  falcon-mamba and zamba2 saves, and ``restore_sharded`` onto (1, 4)
  restores every tensor bit-equal.

The dry run of these families is in ``tests/test_torch_dryrun_families.py``.
Ranks are spawned CPU processes joined through a ``FileStore`` in
``tmp_path`` (``_torch_ranks.spawn``), a few cases to a group.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_ranks as R
from repro.configs import get_config as jax_get_config
from repro.models import api as japi
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.core.bitx import TorchBackend
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.formats import safetensors as st
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.serve.engine import ServeEngine
from test_torch_mesh import _close, _jax_setup, _jax_step, _port_step

REPO = os.path.join(os.path.dirname(__file__), "..")
FAMILIES = ("falcon-mamba-7b", "zamba2-2.7b", "whisper-medium")
TOL = 1e-5


def _py(script, timeout=300, devices=0):
    """``script`` in a subprocess below the other tests' priority (JAX on
    ``devices`` forced host devices, when given)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    if devices:
        env.update(XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
                   JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", "import os; os.nice(10)\n" + textwrap.dedent(script)],
                       capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


def _params_close(got, want, grads, gnorm, lr=1e-2, clip=1.0):
    """Every new parameter within 1e-5 of its tensor's max, except where the
    gradient Adam receives (after the global-norm clip to ``clip``) is under
    1e-6 of its tensor's max or under 1e-6 at all (a hundred times Adam's
    eps): there Adam's first step, lr·g/(|g| + eps), turns the rounding of a
    gradient that is zero but for rounding into a step of up to ±lr (bound
    2·lr). ``tests/test_torch_mesh.py`` states the rule where no clip acts."""
    scale_g = min(1.0, clip / gnorm)
    for k, v in want.items():
        scale = max(float(v.abs().max()), 1e-30)
        g = grads[k].abs() * scale_g
        tiny = g < max(1e-6 * float(g.max()), 1e-6)
        err = (got[k] - v).abs()
        assert float(torch.where(tiny, 0.0, err).max()) <= 1e-5 * scale, k
        assert float(torch.where(tiny, err, 0.0).max()) <= 2 * lr, k


def _grads(cfg, params, batch):
    """The one-device gradient of the mean loss (float32)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = api.get_model(cfg, attn="plain").loss(leaves, batch)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _allclose(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# decode_attention_sp on uneven shards
# ---------------------------------------------------------------------------

def _sp_cases(rng, B, H, Kv, D, spec):
    cases = []
    for S, t, window in spec:
        q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32))
        kc = torch.from_numpy(rng.standard_normal((B, S, Kv, D), dtype=np.float32))
        vc = torch.from_numpy(rng.standard_normal((B, S, Kv, D), dtype=np.float32))
        cases.append((q, kc, vc, t, window))
    return cases


def _dense(q, kc, vc, t, window):
    """The dense attention of the query at t - 1 over keys < t (and, with a
    window, keys > t - window: the sp meaning, the dense path's window one
    shorter)."""
    H = q.shape[1]
    return L.attention(q[:, None], L.repeat_kv(kc, H), L.repeat_kv(vc, H), causal=True,
                       q_offset=t - 1, window=window - 1 if window else 0)[:, 0]


def test_decode_attention_sp_on_uneven_shards(tmp_path):
    rng = np.random.default_rng(1)
    B, H, Kv, D = 2, 4, 2, 8
    # on 2 ranks S 17 splits 9 / 8 and S 161 splits 81 / 80; every t lies in
    # the last shard, keys >= t masked there, keys <= t - window in the first
    two = _sp_cases(rng, B, H, Kv, D, [(17, 12, 0), (17, 12, 6), (17, 17, 0),
                                       (161, 130, 0), (161, 130, 40), (161, 100, 30)])
    # on 4 ranks S 5 splits 2 / 2 / 1 / 0: the last rank holds no position
    four = _sp_cases(rng, B, H, Kv, D, [(5, 4, 0), (5, 5, 3)])
    got2 = R.spawn(R.decode_sp_uneven, 2, tmp_path / "two", two, timeout=300)[0]
    got4 = R.spawn(R.decode_sp_uneven, 4, tmp_path / "four", four, timeout=300)[0]
    for got, case in zip(got2 + got4, two + four):
        q, kc, vc, t, window = case
        _allclose(got, _dense(*case), 2e-5, f"S {kc.shape[1]} t {t} window {window}")
        if not window:
            want = np.asarray(jlayers.attention(
                jnp.asarray(q.numpy())[:, None], jlayers.repeat_kv(jnp.asarray(kc.numpy()), H),
                jlayers.repeat_kv(jnp.asarray(vc.numpy()), H), causal=True,
                q_offset=t - 1)[:, 0])
            _allclose(got, want, 2e-5, f"S {kc.shape[1]} t {t} vs JAX")


# ---------------------------------------------------------------------------
# Train steps, prefill and decode against the port and JAX
# ---------------------------------------------------------------------------

def test_families_train_step_on_a_mesh_matches_single_device(tmp_path):
    cases, want = [], {}
    for arch in FAMILIES:
        for fp32 in (False, True):
            jcfg, jp, jb = _jax_setup(arch, fp32)
            params = api.params_from_reference({k: np.asarray(v) for k, v in jp.items()}, "cpu")
            # (whisper's bf16 frames cross as their bits)
            batch = api.params_from_reference({k: np.asarray(v) for k, v in jb.items()}, "cpu")
            path = str(tmp_path / f"{arch}-{fp32}.pt")
            torch.save(params, path)
            cfg = get_config(arch, smoke=True)
            cfg = R._fp32(cfg) if fp32 else cfg
            want[arch, fp32] = {"jax": _jax_step(jcfg, jp, jb)[1],
                                "port": _port_step(cfg, params, batch),
                                "grads": _grads(cfg, params, batch) if fp32 else None}
            cases.append((arch, path, batch, (2, 2), fp32))
            if fp32 and arch == "zamba2-2.7b":
                cases.append((arch, path, batch, (1, 4), fp32))
    res = R.spawn(R.family_train_steps, 4, tmp_path, cases, timeout=420)
    assert all(r[i]["loss"] == res[0][i]["loss"] for r in res for i in range(len(cases)))
    for (arch, _, _, shape, fp32), got in zip(cases, res[0]):
        w = want[arch, fp32]
        what = f"{arch} {shape} {'float32' if fp32 else 'bf16'}"
        _close(got, w["jax"], what + " vs JAX")
        _close(got, w["port"][1], what + " vs port")
        if fp32:
            pw, mw = w["port"]
            assert abs(got["loss"] - mw["loss"]) <= TOL * abs(mw["loss"]), what
            assert abs(got["gn"] - mw["gn"]) <= TOL * abs(mw["gn"]), what
            _params_close(got["params"], pw, w["grads"], mw["gn"])


def _one_device_decode(arch, params, batch, steps):
    eng = ServeEngine(R._fp32(get_config(arch, smoke=True)), params, device="cpu", attn="plain")
    logits, cache = eng.model.prefill(eng.params, batch)
    out = [(logits, dict(cache))]
    cache = eng._pad_cache(cache, steps.shape[1])
    for j in range(steps.shape[1]):
        logits, cache = eng.model.decode_step(eng.params, {"tokens": steps[:, j:j + 1]}, cache)
        out.append((logits, {k: v.clone() if torch.is_tensor(v) else v
                             for k, v in cache.items()}))
    return out


def _jax_sharded_decode(archs, tmp_path):
    """The reference's prefill and decode steps on a (2, 2) mesh of 4 forced
    host devices (a subprocess): logits and cache entries after each call,
    the growing caches padded as the port's engine pads them."""
    script = f"""
        import dataclasses, jax, jax.numpy as jnp, numpy as np
        from repro.configs import get_config
        from repro.launch.mesh import make_local_mesh
        from repro.models import api
        from repro.sharding.rules import ShardingRules
        GROW = {{"hybrid": ("attn_k", "attn_v"), "encdec": ("self_k", "self_v")}}
        mesh = make_local_mesh(2, 2)
        rules = ShardingRules.for_mesh(mesh)
        for arch in {list(archs)!r}:
            z = np.load({str(tmp_path)!r} + "/" + arch + ".npz")
            cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype="float32",
                                      act_dtype="float32")
            model = api.get_model(cfg, mesh, rules)
            sh = api.param_shardings(cfg, mesh, rules)
            params = {{k: jax.device_put(z["p." + k], s) for k, s in sh.items()}}
            batch = {{k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("b.")}}
            steps = z["steps"]
            out = {{}}
            logits, cache = jax.jit(model.prefill)(params, batch)
            def keep(j, logits, cache):
                out[f"{{j}}.logits"] = np.asarray(logits)
                for k, v in cache.items():
                    if k != "len":
                        out[f"{{j}}.{{k}}"] = np.asarray(v)
            keep(0, logits, cache)
            for k in GROW[cfg.family]:
                pad = [(0, 0)] * cache[k].ndim
                pad[2] = (0, steps.shape[1])
                cache[k] = jnp.pad(cache[k], pad)
            step = jax.jit(model.decode_step)
            for j in range(steps.shape[1]):
                logits, cache = step(params, {{"tokens": jnp.asarray(steps[:, j:j + 1])}}, cache)
                keep(j + 1, logits, cache)
            np.savez({str(tmp_path)!r} + "/" + arch + "-out.npz", **out)
    """
    _py(script, timeout=300, devices=4)
    return {a: np.load(tmp_path / f"{a}-out.npz") for a in archs}


def test_families_prefill_and_decode_on_a_mesh(tmp_path):
    cases, one = [], {}
    rng = np.random.default_rng(2)
    for arch in FAMILIES:
        cfg = R._fp32(get_config(arch, smoke=True))
        jp = japi.init_params(R._fp32(jax_get_config(arch, smoke=True)), jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in jp.items()}
        params = api.params_from_reference(flat, "cpu")
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32)}
        if cfg.family == "encdec":
            batch["frames"] = (rng.standard_normal((4, 16, cfg.d_model)) * 0.02).astype(np.float32)
        steps = rng.integers(0, cfg.vocab, (4, 4)).astype(np.int32)
        np.savez(tmp_path / f"{arch}.npz", steps=steps, **{f"p.{k}": v for k, v in flat.items()},
                 **{f"b.{k}": v for k, v in batch.items()})
        path = str(tmp_path / f"{arch}.pt")
        torch.save(params, path)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        cases.append((arch, (2, 2), path, tb, torch.from_numpy(steps)))
        one[arch] = _one_device_decode(arch, params, tb, torch.from_numpy(steps))
    got = R.spawn(R.family_decode, 4, tmp_path, cases, timeout=300)[0]
    ref = _jax_sharded_decode(("zamba2-2.7b", "whisper-medium"), tmp_path)
    for (arch, *_), calls in zip(cases, got):
        assert len(calls) == 5
        for j, ((lg, cache), (lw, cw)) in enumerate(zip(calls, one[arch])):
            what = f"{arch} call {j}"
            _allclose(lg, lw, TOL, what + " logits")
            assert cache.keys() == cw.keys(), what
            for k in cw:
                if k != "len":
                    _allclose(cache[k], cw[k], TOL, f"{what} {k}")
            if arch in ref:
                _allclose(lg, ref[arch][f"{j}.logits"], TOL, what + " logits vs JAX")
                for k in cw:
                    if k != "len":
                        _allclose(cache[k], ref[arch][f"{j}.{k}"], TOL, f"{what} {k} vs JAX")


# ---------------------------------------------------------------------------
# The engine from the store, the trainer's checkpoints across meshes
# ---------------------------------------------------------------------------

def test_sharded_engines_give_the_one_device_tokens(tmp_path):
    """Each family's fine-tune served from the store on a (1, 2) mesh; and
    qwen2-7b with a prompt of 12 and 5 new tokens, whose grown cache of 17
    the model axis of 2 splits unevenly."""
    root = str(tmp_path / "store")
    store = ZLLMStore(root, backend=TorchBackend(device="cpu"))
    rng = np.random.default_rng(4)
    cases, want = [], []
    try:
        for arch in FAMILIES + ("qwen2-7b",):
            cfg = R._fp32(get_config(arch, smoke=True))
            params = api.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
            repo = f"user/{arch}"
            os.makedirs(tmp_path / arch)
            st.save_file({f"params/{k}": v.numpy() for k, v in params.items()},
                         str(tmp_path / arch / "model.safetensors"))
            store.ingest_file(str(tmp_path / arch / "model.safetensors"), repo,
                              "model.safetensors")
            S, n_new = (12, 5) if arch == "qwen2-7b" else (8, 6)
            prompts = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
            extra = None
            if cfg.family == "encdec":
                extra = {"frames": (rng.standard_normal((2, 12, cfg.d_model)) * 0.02)
                         .astype(np.float32)}
            eng = ServeEngine.from_store(store, repo, "model.safetensors", cfg, device="cpu")
            steps = R.record_decode_logits(eng)
            want.append((eng.generate(prompts, n_new, extra).tokens, steps))
            cases.append((arch, repo, prompts, n_new, extra))
        store.save_index()
    finally:
        store.close()
    res = R.spawn(R.engine_tokens, 2, tmp_path, root, None, None, cases, timeout=300)
    for r in res:
        for (arch, *_), got, (tokens, steps) in zip(cases, r, want):
            np.testing.assert_array_equal(got["tokens"], tokens, err_msg=arch)
            # the decode logits too: a wrong key in the softmax need not move a
            # greedy pick at this size
            assert len(got["decode_logits"]) == len(steps), arch
            for j, (lg, lw) in enumerate(zip(got["decode_logits"], steps)):
                _allclose(lg, lw, TOL, f"{arch} decode step {j}")
    placed = [g["placed"] for g in res[0]]
    # out_proj (L, DI, d): d on the one-rank data axis, DI on the model axis of 2
    assert placed[0] == placed[1] == "(Shard(dim=2), Shard(dim=1))"
    assert placed[2] == placed[3] == "(Shard(dim=1), Shard(dim=2))"


def test_ssm_trainers_on_a_mesh_restore_bit_equal_across_meshes(tmp_path):
    archs = ("falcon-mamba-7b", "zamba2-2.7b")
    res = R.spawn(R.family_restores, 4, tmp_path, str(tmp_path / "runs"), archs,
                  [(2, 2), (1, 4)], timeout=420)
    for arch in archs:
        got = res[0][arch][(1, 4)]
        assert got["step"] == 2 and got["opt_step"] == 2, arch
        assert got["params_equal"] and got["m_equal"], arch
        # out_proj (L, DI, d): DI over the model axis of 4, d on the one-rank data axis
        assert got["placed"] == "(Shard(dim=2), Shard(dim=1))", arch
        assert all(r[arch][(1, 4)]["params_equal"] for r in res), arch
