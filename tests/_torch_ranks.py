"""Multi-process helpers for the port's mesh tests: a group of CPU ranks
(gloo) joined through a ``FileStore`` in the test's ``tmp_path``, and the
bodies each rank runs. Each rank writes what it found to ``rank<r>.pt`` in
the output directory; :func:`spawn` returns those, or raises when a rank
failed or the group outlived its timeout. Imports torch and the port only
(children start from a fresh interpreter)."""

from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(target, rank, world, store, out, args):
    # one thread, and below the other tests' priority: a group of ranks must
    # not starve the timing-sensitive tests that run beside it
    os.nice(10)
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        result = target(rank, world, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(target, world: int, tmp, *args, timeout: float = 120.0):
    """Run ``target(rank, world, *args)`` on ``world`` spawned CPU ranks;
    their results, by rank."""
    out = os.path.join(str(tmp), f"ranks-{target.__name__}")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, store, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join()
    errs = [open(os.path.join(out, f)).read() for f in sorted(os.listdir(out)) if f.endswith(".err")]
    if late or errs or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{target.__name__}: {len(late)} ranks past {timeout} s, exit codes "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(errs))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def decode_sp(rank, world, q, kc, vc, t, windows):
    """decode_attention_sp on a (2, 2) mesh; the whole output per window."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.sharding.rules import PartitionSpec, spec_placements

    mesh = make_local_mesh(2, 2, device_type="cpu")
    qd = distribute_tensor(q, mesh, spec_placements(mesh, PartitionSpec("data", None, None)),
                           src_data_rank=None)
    c_pl = spec_placements(mesh, PartitionSpec("data", "model", None, None))
    kd = distribute_tensor(kc, mesh, c_pl, src_data_rank=None)
    vd = distribute_tensor(vc, mesh, c_pl, src_data_rank=None)
    return {w: L.decode_attention_sp(qd, kd, vd, t, mesh=mesh, sp_axis="model",
                                     batch_axes=("data",), window=w).full_tensor()
            for w in windows}


def train_step(rank, world, arch, flat_path, batch, cases):
    """One train step per (mesh shape, fsdp_over_pod, dtype, n_heads) case on
    this group's ranks: loss, grad norm, Σ|embed| and the new params whole."""
    return [_one_step(rank, arch, flat_path[fp32], batch, shape, over_pod, fp32, cfg_kw)
            for shape, over_pod, fp32, cfg_kw in cases]


def family_train_steps(rank, world, cases):
    """:func:`train_step` per (arch, params path, batch, mesh shape, float32)
    case, the families mixed in one group of ranks."""
    return [_one_step(rank, arch, path, batch, shape, False, fp32, None)
            for arch, path, batch, shape, fp32 in cases]


def _one_step(rank, arch, flat_path, batch, shape, over_pod, fp32, cfg_kw):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.optim.optimizers import AdamW, OptimizerConfig
    from repro_torch.sharding.rules import (ShardingRules, named_sharding,
                                            spec_tree_shardings)
    from repro_torch.train.step import make_train_step

    cfg = get_config(arch, smoke=True)
    if fp32:
        cfg = _fp32(cfg)
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    flat = torch.load(flat_path, weights_only=False)
    mesh = make_local_mesh(*shape[-2:], pod=shape[0] if len(shape) == 3 else 0,
                           device_type="cpu")
    rules = ShardingRules.for_mesh(mesh, fsdp_over_pod=over_pod)
    model = api.get_model(cfg, attn="plain", mesh=mesh, rules=rules)
    opt = AdamW(OptimizerConfig(lr=1e-2, warmup_steps=0))
    params = api.distribute(flat, api.param_shardings(cfg, mesh, rules))
    state = opt.init(params)
    osh = spec_tree_shardings(opt.state_templates(model.param_templates()), mesh, rules)
    for k in ("m", "v"):
        assert all(state[k][n].placements == osh[k][n].placements for n in state[k])
    b = {k: named_sharding(mesh, ("batch",) + (None,) * (v.dim() - 1), rules,
                           v.shape).distribute(v) for k, v in batch.items()}
    step = make_train_step(model, opt, microbatches=2)
    p, s, m = step(params, state, b)
    whole = {k: v.full_tensor() for k, v in p.items()}
    return {"loss": float(m["loss"]), "gn": float(m["grad_norm"]),
            "w0": float(whole["embed"].float().abs().sum()),
            "params": whole if rank == 0 else None,
            "placement": str(p["blocks.wq"].placements) if "blocks.wq" in p else None}


def trainer_crash_resume(rank, world, run_dir, store_root, steps, fail_at):
    """Trainer on a (world, 1) mesh: crash at ``fail_at``, then resume."""
    from repro_torch.configs import get_config
    from repro_torch.core.bitx import TorchBackend
    from repro_torch.core.pipeline import ZLLMStore
    from repro_torch.train.trainer import FailureInjector, SimulatedFailure, TrainConfig, Trainer

    cfg = TrainConfig(arch=_fp32(get_config("qwen2-7b", smoke=True)), seq_len=16,
                      global_batch=4, steps=steps, ckpt_every=2, run_dir=run_dir,
                      mesh_shape=(world, 1), device="cpu")
    store = ZLLMStore(store_root, backend=TorchBackend(device="cpu"))
    try:
        t1 = Trainer(cfg, store=store, run_id="mesh", failure=FailureInjector(fail_at))
        m_placed = str(t1.opt_state["m"]["blocks.w_up"].placements)
        try:
            t1.run()
            crashed = False
        except SimulatedFailure:
            crashed = True
        t2 = Trainer(cfg, store=store, run_id="mesh")
        hist = t2.run()
        placed = str(t2.params["blocks.w_up"].placements)
        results = [(r.base_source, r.n_bitx) for r in store.results]
    finally:
        store.close()
    return {"crashed": crashed, "resumed": t2.resumed_from, "first": t1.history,
            "second": hist, "placed": placed, "m_placed": m_placed, "ingested": results}


def restore_across_meshes(rank, world, run_dir, shapes, live_path, store_root=None,
                          arch="qwen2-7b"):
    """Train 2 steps of ``arch``'s smoke model on the first mesh and save;
    then restore the checkpoint onto each mesh of ``shapes`` and compare
    every tensor with the live ones (or, with ``live_path``, with those saved
    there). With ``store_root`` the checkpoint is kept in that store alone."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.sharding.rules import ShardingRules, spec_tree_shardings
    from repro_torch.train.trainer import TrainConfig, Trainer

    name, arch = arch, get_config(arch, smoke=True)
    if live_path is None:
        cfg = TrainConfig(arch=arch, seq_len=16, global_batch=4, steps=2, ckpt_every=2,
                          run_dir=run_dir, mesh_shape=shapes[0], device="cpu",
                          async_checkpoint=False, keep_plain_ckpt=store_root is None)
        store = None
        if store_root is not None:
            from repro_torch.core.bitx import TorchBackend
            from repro_torch.core.pipeline import ZLLMStore

            store = ZLLMStore(store_root, backend=TorchBackend(device="cpu"))
        t = Trainer(cfg, store=store, run_id="x")
        t.run()
        live = {k: v.full_tensor() for k, v in t.params.items()}
        live_m = {k: v.full_tensor() for k, v in t.opt_state["m"].items()}
        mgr, opt, model = t.ckpt, t.optimizer, t.model
    else:
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.optim.optimizers import AdamW, OptimizerConfig

        live, live_m = torch.load(live_path, weights_only=False)
        mgr, opt, model = CheckpointManager(run_dir, run_id="x"), AdamW(OptimizerConfig()), \
            api.get_model(arch)
    out = {"live": (live, live_m) if rank == 0 else None}
    tmpl = opt.state_templates(model.param_templates())
    for shape in shapes[1:] if live_path is None else shapes:
        mesh = make_local_mesh(*shape, device_type="cpu")
        rules = ShardingRules.for_mesh(mesh)
        step, p, o = mgr.restore_sharded(
            mesh, opt_template=tmpl, shardings=api.param_shardings(arch, mesh, rules),
            opt_shardings=spec_tree_shardings(tmpl, mesh, rules))
        out[shape] = {
            "step": step,
            "params_equal": all(torch.equal(p[k].full_tensor(), v) for k, v in live.items()),
            "m_equal": all(torch.equal(o["m"][k].full_tensor(), v) for k, v in live_m.items()),
            "placed": str(p["blocks.wq" if "blocks.wq" in p else "blocks.out_proj"].placements),
            "opt_step": int(o["step"])}
    out["files"] = sorted(os.listdir(run_dir))
    return out


def family_restores(rank, world, root, archs, shapes):
    """:func:`restore_across_meshes` for each of ``archs`` in one group, each
    in a run directory of its own under ``root``."""
    return {a: restore_across_meshes(rank, world, os.path.join(root, a), shapes, None, arch=a)
            for a in archs}


def engine_tokens(rank, world, store_root, prompts, n_new, cases=None):
    """Greedy tokens of ``ServeEngine.from_store`` on a (1, world) mesh: the
    qwen2-7b fine-tune ``user/ft``, or per (arch, repo, prompts, n_new,
    extra inputs) case of ``cases``, each float32 smoke model."""
    from repro_torch.configs import get_config
    from repro_torch.core.bitx import TorchBackend
    from repro_torch.core.pipeline import ZLLMStore
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.rules import ShardingRules

    mesh = make_local_mesh(1, world, device_type="cpu")
    one = cases is None
    if one:
        cases = [("qwen2-7b", "user/ft", prompts, n_new, None)]
    store = ZLLMStore(store_root, backend=TorchBackend(device="cpu"))
    out = []
    try:
        store.load_index()
        for arch, repo, prompts, n_new, extra in cases:
            eng = ServeEngine.from_store(store, repo, "model.safetensors",
                                         _fp32(get_config(arch, smoke=True)), device="cpu",
                                         mesh=mesh, rules=ShardingRules.for_mesh(mesh))
            w = next(k for k in ("blocks.wq", "blocks.out_proj", "dec.self_wq") if k in eng.params)
            steps = record_decode_logits(eng)
            out.append({"tokens": eng.generate(prompts, n_new, extra).tokens,
                        "placed": str(eng.params[w].placements), "decode_logits": steps})
    finally:
        store.close()
    return out[0] if one else out


def record_decode_logits(engine):
    """The whole logits of each decode step ``engine`` runs from now on, in
    the list returned."""
    from repro_torch.sharding.rules import whole

    steps, step = [], engine.model.decode_step

    def decode_step(params, batch, cache):
        logits, cache = step(params, batch, cache)
        steps.append(whole(logits))
        return logits, cache

    engine.model.decode_step = decode_step
    return steps


def decode_sp_uneven(rank, world, cases):
    """decode_attention_sp on a (1, world) mesh, the cache sequence-sharded
    however DTensor splits it: per (q, k, v, t, window) case the whole output."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.sharding.rules import PartitionSpec, spec_placements

    mesh = make_local_mesh(1, world, device_type="cpu")
    out = []
    for q, kc, vc, t, window in cases:
        qd = distribute_tensor(q, mesh, spec_placements(mesh, PartitionSpec(None, None, None)),
                               src_data_rank=None)
        c_pl = spec_placements(mesh, PartitionSpec(None, "model", None, None))
        kd = distribute_tensor(kc, mesh, c_pl, src_data_rank=None)
        vd = distribute_tensor(vc, mesh, c_pl, src_data_rank=None)
        out.append(L.decode_attention_sp(qd, kd, vd, t, mesh=mesh, sp_axis="model",
                                         window=window).full_tensor())
    return out


def family_decode(rank, world, cases):
    """Per (arch, mesh shape, params path, prefill batch, decode tokens)
    case: the float32 smoke model's prefill on that mesh, its cache grown as
    the engine grows it, then one decode step per column of the tokens; the
    logits and every cache entry whole after each call."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.rules import ShardingRules, whole

    out = []
    for arch, shape, flat_path, batch, steps in cases:
        cfg = _fp32(get_config(arch, smoke=True))
        mesh = make_local_mesh(*shape, device_type="cpu")
        eng = ServeEngine(cfg, torch.load(flat_path, weights_only=False), device="cpu",
                          attn="plain", mesh=mesh, rules=ShardingRules.for_mesh(mesh))
        logits, cache = eng.model.prefill(eng.params, {k: eng._place(v) for k, v in batch.items()})
        got = [(whole(logits), {k: whole(v) for k, v in cache.items()})]
        cache = eng._pad_cache(cache, steps.shape[1])
        for j in range(steps.shape[1]):
            logits, cache = eng.model.decode_step(eng.params,
                                                  {"tokens": eng._place(steps[:, j:j + 1])}, cache)
            got.append((whole(logits), {k: whole(v) for k, v in cache.items()}))
        out.append(got if rank == 0 else None)
    return out
