# Port of src/repro/launch/dryrun.py: rewritten for DTensor on a fake process group.
"""Dry run: one step of every (arch × shape × mesh) cell, on no hardware.

The proof that the distribution config is coherent on the production meshes
without the devices: the step of :func:`build_step` runs once on ``meta``
tensors (shapes and dtypes, no storage) as rank 0 of a fake process group of
256 (single pod, 16 × 16) or 512 (multi pod, 2 × 16 × 16) ranks, whose
collectives move nothing. The parameters, optimizer state, batch and cache
are DTensors laid out by the reference's rules; every redistribute, every
``local_map`` and every op of the step runs as it would on rank 0 of a real
mesh. :class:`repro_torch.launch.op_cost.OpCost` counts what rank 0 does:
per-device FLOPs, HBM bytes, collective bytes by kind, peak live bytes. The
mesh is typed ``cuda``, so DTensor issues the collectives an NCCL mesh would
(an all-to-all where a CPU mesh falls back to all-gather + chunk).

What changes from the reference: there is no compiler, so no ``lower_s`` /
``compile_s`` (``wall_s`` is the step's seconds on the host) and no HLO
(``op_census`` counts aten ops); the models run ``attn="plain"``, the
reference models' own attention (the flash kernel runs on real cards only).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--force]
    python -m repro_torch.launch.dryrun --arch ... --variant remat=dots,grad=bfloat16

``--all`` drives one subprocess per cell of every family (resumable: cells
with a JSON record are skipped unless --force). Records land in
experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<variant>].json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
VARIANT_KEYS = ("remat", "grad", "attn", "cq", "ck", "mb")


def _cell_fname(arch: str, shape: str, mesh: str, variant: str = "") -> str:
    base = f"{arch}__{shape}__{mesh}"
    if variant:
        base += "__" + variant.replace("=", "-").replace(",", "_")
    return base + ".json"


def parse_variant(variant: str) -> dict:
    opts = dict(kv.split("=") for kv in variant.split(",") if kv)
    unknown = set(opts) - set(VARIANT_KEYS)
    if unknown:
        raise ValueError(f"unknown variant keys {sorted(unknown)}; known: {VARIANT_KEYS}")
    return opts


# ---------------------------------------------------------------------------
# Single-cell execution (runs inside the subprocess)
# ---------------------------------------------------------------------------

def fake_world(n: int) -> None:
    """This process as rank 0 of a fake process group of ``n`` ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up; "
                               f"the dry run needs {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def build_step(cfg, cell, mesh, rules, *, remat_policy="nothing", grad_dtype="float32"):
    """(fn, args, model): ``fn(*args)`` is the cell's step on meta DTensors laid
    out by the rules: the train step with the optimizer, or ``prefill`` /
    ``decode_step``."""
    import torch

    from repro_torch.models.api import (abstract_cache, abstract_inputs, abstract_params,
                                        cache_shardings, distribute, get_model,
                                        input_shardings, param_shardings)
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
    from repro_torch.sharding.rules import spec_tree_sds, spec_tree_shardings
    from repro_torch.train.step import make_train_step

    model = get_model(cfg, attn="plain", remat_policy=remat_policy, mesh=mesh, rules=rules)
    params = distribute(abstract_params(cfg), param_shardings(cfg, mesh, rules))
    batch = distribute(abstract_inputs(cfg, cell), input_shardings(cfg, cell, mesh, rules))

    if cell.kind == "train":
        opt = make_optimizer(OptimizerConfig(name=cfg.optimizer))
        tmpl = opt.state_templates(model.param_templates())
        sds, sh = spec_tree_sds(tmpl), spec_tree_shardings(tmpl, mesh, rules)
        state = {k: (torch.zeros((), dtype=torch.int32) if k == "step"
                     else distribute(v, sh[k])) for k, v in sds.items()}
        step = make_train_step(model, opt, microbatches=cell.microbatches, grad_dtype=grad_dtype)
        return step, (params, state, batch), model

    if cell.kind == "prefill":
        return model.prefill, (params, batch), model

    if cell.kind == "decode":
        cache = abstract_cache(cfg, cell.global_batch, cell.seq_len)
        shard = cache_shardings(cfg, cell.global_batch, cell.seq_len, mesh, rules)
        cache = {k: distribute(v, shard[k]) for k, v in cache.items() if k != "len"}
        cache["len"] = cell.seq_len - 1   # the last position: attends over the whole cache
        return model.decode_step, (params, batch, cache), model

    raise ValueError(cell.kind)


def cell_setup(arch: str, shape: str, mesh_kind: str, variant: str = "", *,
               smoke: bool = False, mesh_shape=None):
    """(cfg, cell, mesh, rules, opts) of one cell, on a fake group of the
    mesh's size: the production mesh of ``mesh_kind``, or a (data, model) /
    (pod, data, model) ``mesh_shape`` (with ``smoke``'s reduced config, for
    tests)."""
    import math

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.sharding.rules import ShardingRules

    opts = parse_variant(variant)
    cfg = get_config(arch, smoke=smoke)
    if "attn" in opts:
        cfg = dataclasses.replace(cfg, attn_score_dtype=opts["attn"])
    if "cq" in opts:
        cfg = dataclasses.replace(cfg, attn_chunk_q=int(opts["cq"]))
    if "ck" in opts:
        cfg = dataclasses.replace(cfg, attn_chunk_kv=int(opts["ck"]))
    cell = SHAPES_BY_NAME[shape]
    if "mb" in opts:
        cell = cell.with_microbatches(int(opts["mb"]))
    if mesh_shape is not None:
        fake_world(math.prod(mesh_shape))
        pod = mesh_shape[0] if len(mesh_shape) == 3 else 0
        mesh = make_local_mesh(*mesh_shape[-2:], pod=pod, device_type="cuda")
    else:
        multi = mesh_kind == "multi"
        fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device_type="cuda")
    rules = ShardingRules.for_mesh(mesh, fsdp_over_pod=cfg.fsdp_over_pod)
    return cfg, cell, mesh, rules, opts


def count_step(fn, args, *, attribute: bool = False):
    """Run ``fn(*args)`` once under :class:`OpCost`; (cost, seconds)."""
    from repro_torch.launch.op_cost import OpCost

    cost = OpCost(attribute=attribute)
    cost.arguments(args)
    t0 = time.perf_counter()
    with cost:
        fn(*args)
    return cost, time.perf_counter() - t0


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: Path, variant: str = "", *,
             smoke: bool = False, mesh_shape=None) -> dict:
    cfg, cell, mesh, rules, opts = cell_setup(arch, shape, mesh_kind, variant, smoke=smoke,
                                              mesh_shape=mesh_shape)
    fn, args, model = build_step(cfg, cell, mesh, rules,
                                 remat_policy=opts.get("remat", "nothing"),
                                 grad_dtype=opts.get("grad", "float32"))
    cost, wall = count_step(fn, args)
    c = cost.total

    N, Na = model.param_count(), model.active_param_count()
    tokens = cell.global_batch * (cell.seq_len if cell.kind in ("train", "prefill") else 1)
    model_flops = (6 if cell.kind == "train" else 2) * Na * tokens
    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_kind,
        "variant": variant,
        "chips": mesh.size(),
        "param_count": int(N),
        "active_param_count": int(Na),
        "tokens_per_step": int(tokens),
        "model_flops_global": float(model_flops),
        # per-device counts of the ops rank 0 ran (local shards)
        "flops_per_device": c.flops,
        "dot_flops_per_device": c.dot_flops,
        "bytes_per_device": c.bytes,
        "memory_analysis": {"argument_size_in_bytes": int(cost.argument_bytes),
                            "temp_size_in_bytes": int(cost.peak_bytes),
                            "peak_size_in_bytes": int(cost.argument_bytes + cost.peak_bytes)},
        "collectives": cost.summary(),
        "collective_backend": "nccl (a cuda-typed mesh over a fake process group)",
        "op_census": dict(sorted(cost.census.items())),
        "wall_s": wall,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / _cell_fname(arch, shape, mesh_kind, variant)
    out_path.write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] OK {arch} {shape} {mesh_kind} {variant or '-'} | wall {wall:.1f}s | "
          f"flops/dev {c.flops:.3e} | dot/dev {c.dot_flops:.3e} | bytes/dev {c.bytes:.3e} | "
          f"coll {c.collective_total:.3e}B {dict(c.coll_bytes)} | peak "
          f"{rec['memory_analysis']['peak_size_in_bytes'] / 2**30:.2f}GiB", flush=True)
    return rec


# ---------------------------------------------------------------------------
# The sweep (one subprocess per cell)
# ---------------------------------------------------------------------------

def all_cells(mesh_kind: str):
    from repro_torch.configs import ARCH_IDS, cells_for, get_config

    meshes = ["single", "multi"] if mesh_kind == "both" else [mesh_kind]
    for arch in ARCH_IDS:
        for cell in cells_for(get_config(arch)):
            for mk in meshes:
                yield arch, cell.name, mk


def drive_all(mesh_kind: str, out_dir: Path, force: bool, variant: str = "",
              timeout: int = 3600) -> int:
    todo = list(all_cells(mesh_kind))
    failed = []
    for i, (arch, shape, mk) in enumerate(todo):
        out_path = out_dir / _cell_fname(arch, shape, mk, variant)
        if out_path.exists() and not force:
            print(f"[dryrun] skip {arch} {shape} {mk} (cached)")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--mesh", mk, "--out", str(out_dir)]
        if variant:
            cmd += ["--variant", variant]
        print(f"[dryrun] ({i+1}/{len(todo)}) {' '.join(cmd[3:])}", flush=True)
        r = subprocess.run(cmd, timeout=timeout)
        if r.returncode != 0:
            failed.append((arch, shape, mk))
            print(f"[dryrun] FAIL {arch} {shape} {mk}", flush=True)
    if failed:
        print(f"[dryrun] {len(failed)} FAILURES: {failed}")
        return 1
    print(f"[dryrun] sweep complete: {len(todo)} cells")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="", help="e.g. remat=dots,grad=bfloat16")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.all:
        sys.exit(drive_all(args.mesh, out_dir, args.force, args.variant))
    if not (args.arch and args.shape) or args.mesh == "both":
        ap.error("one cell needs --arch, --shape and --mesh single or multi (or --all)")
    run_cell(args.arch, args.shape, args.mesh, out_dir, args.variant)


if __name__ == "__main__":
    main()
