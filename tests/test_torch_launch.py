"""The port's launch tooling and the mesh's trainer, launcher, checkpoints and
engine, on the CPU.

* ``Trainer(mesh_shape=(2, 1))`` crashes and resumes through the store on two
  gloo ranks, with the one-device trainer's losses; a checkpoint written on a
  (2, 2) mesh restores bit-equal onto (1, 4) and onto (1, 1).
* ``python -m repro_torch.launch.train --mesh 2,2 --device cpu`` exits 0.
* ``ServeEngine.from_store`` on a (1, 2) mesh gives the one-device engine's
  greedy tokens.
* ``op_cost``: a matmul on a fake (1, 4) TP mesh counts exactly 1/4 of the
  global FLOPs (the counterpart of the reference's per-device HLO shapes); 6
  row-parallel steps give 6 all-reduces (``test_hlo_cost_counts_looped_
  collectives``); a smoke train step's dot FLOPs equal their closed form;
  bytes are the operands' and outputs' on a hand-built case.
* ``dryrun`` writes the reference's record keys for a smoke cell on a fake
  (2, 2) mesh; ``roofline`` renders a hand-made record with the H100's
  constants; each level of ``hotspots`` adds up to its total.

Ranks are spawned CPU processes joined through a ``FileStore`` in
``tmp_path`` (``_torch_ranks.spawn``), each group with its own timeout; the
fake process groups run in subprocesses of their own.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core.bitx import TorchBackend
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.formats import safetensors as st
from repro_torch.launch import hotspots, roofline
from repro_torch.launch.mesh import HW
from repro_torch.launch.op_cost import OpCost, train_dot_flops
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.optim.optimizers import AdamW, OptimizerConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import TrainConfig, Trainer

REPO = os.path.join(os.path.dirname(__file__), "..")


def _py(script, timeout=300):
    """``script`` in a subprocess below the other tests' priority."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", "import os; os.nice(10)\n" + textwrap.dedent(script)],
                       capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


_FAKE = """
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.op_cost import OpCost
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = make_local_mesh(1, 4, device_type="cuda")
    def dt(shape, placement):
        # laid out as ``placement`` on the model axis (4 ranks), whole on data (1)
        local = list(shape)
        if isinstance(placement, Shard):
            local[placement.dim] //= 4
        return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                  [Replicate(), placement], run_check=False)
"""


# ---------------------------------------------------------------------------
# Trainer, checkpoints, launcher, engine on a mesh
# ---------------------------------------------------------------------------

def test_trainer_on_a_mesh_crashes_and_resumes_through_the_store(tmp_path):
    res = R.spawn(R.trainer_crash_resume, 2, tmp_path, str(tmp_path / "run"),
                  str(tmp_path / "store"), 6, 3, timeout=300)
    r = res[0]
    assert r["crashed"] and r["resumed"] == 2
    assert [h["step"] for h in r["second"]] == [3, 4, 5, 6]
    assert r["placed"] == "(Shard(dim=1), Shard(dim=2))"  # FSDP on data, TP on model
    assert r["m_placed"] == r["placed"]     # the fresh run's moments, made in their shards
    # rank 0 alone ingested; its later checkpoints chained to the first (BitX)
    assert [s for s, _ in r["ingested"]][1:] and all(
        s == "declared" and n > 0 for s, n in r["ingested"][1:])
    assert res[1]["ingested"] == []
    # the one-device trainer's losses, step for step
    cfg = TrainConfig(arch=R._fp32(get_config("qwen2-7b", smoke=True)), seq_len=16,
                      global_batch=4, steps=6, ckpt_every=2, run_dir=str(tmp_path / "one"),
                      device="cpu")
    want = [h["loss"] for h in Trainer(cfg, run_id="one").run()]
    got = [h["loss"] for h in r["first"]] [:2] + [h["loss"] for h in r["second"]]
    np.testing.assert_allclose(got, want[:2] + want[2:], rtol=1e-5)


def test_checkpoint_restores_bit_equal_across_meshes(tmp_path):
    run = str(tmp_path / "run")
    res = R.spawn(R.restore_across_meshes, 4, tmp_path / "a", run, [(2, 2), (1, 4)], None,
                  timeout=300)
    got = res[0][(1, 4)]
    assert got["step"] == 2 and got["opt_step"] == 2
    assert got["params_equal"] and got["m_equal"]
    # wq (L, d, H·hd) on (1, 4): d on the one-rank data axis, H·hd over 4
    assert got["placed"] == "(Shard(dim=1), Shard(dim=2))"
    live = str(tmp_path / "live.pt")
    torch.save(res[0]["live"], live)
    one = R.spawn(R.restore_across_meshes, 1, tmp_path / "b", run, [(1, 1)], live,
                  timeout=300)[0][(1, 1)]
    assert one["step"] == 2 and one["params_equal"] and one["m_equal"]


def test_checkpoint_in_the_store_alone_restores_bit_equal_across_meshes(tmp_path):
    # no plain file: rank 0 rebuilds it from the store once, every rank maps it
    run = str(tmp_path / "run")
    res = R.spawn(R.restore_across_meshes, 2, tmp_path, run, [(2, 1), (1, 2)], None,
                  str(tmp_path / "store"), timeout=300)
    got = res[0][(1, 2)]
    assert got["step"] == 2 and got["opt_step"] == 2
    assert got["params_equal"] and got["m_equal"] and res[1][(1, 2)]["params_equal"]
    assert got["placed"] == "(Shard(dim=1), Shard(dim=2))"   # d on the one-rank data axis
    assert not [f for f in res[0]["files"] if f.endswith((".safetensors", ".restore", ".tmp"))]


def test_launcher_trains_on_a_cpu_mesh(tmp_path):
    # below the other tests' priority (its ranks inherit it)
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    cmd = [*nice, sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-7b", "--smoke",
           "--steps", "4", "--ckpt-every", "2", "--seq", "16", "--global-batch", "4",
           "--mesh", "2,2", "--device", "cpu", "--run-dir", str(tmp_path / "run"),
           "--store", str(tmp_path / "store")]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    out = r.stdout
    assert "mesh 2,2" in out and "[train] done: 4 steps" in out
    assert out.count("[train] checkpoint ") == 2       # rank 0 alone ingests and prints
    assert not [f for f in os.listdir(tmp_path / "run") if f.startswith("rendezvous")]


def test_sharded_engine_gives_the_one_device_tokens(tmp_path):
    cfg = R._fp32(get_config("qwen2-7b", smoke=True))
    params = api.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    os.makedirs(tmp_path / "ft")
    st.save_file({f"params/{k}": v.numpy() for k, v in params.items()},
                 str(tmp_path / "ft" / "model.safetensors"))
    root = str(tmp_path / "store")
    store = ZLLMStore(root, backend=TorchBackend(device="cpu"))
    try:
        store.ingest_file(str(tmp_path / "ft" / "model.safetensors"), "user/ft",
                          "model.safetensors")
        store.save_index()
        want = ServeEngine.from_store(store, "user/ft", "model.safetensors", cfg,
                                      device="cpu")
    finally:
        store.close()
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    want = want.generate(prompts, 6).tokens
    res = R.spawn(R.engine_tokens, 2, tmp_path, root, prompts, 6, timeout=300)
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)
    assert res[0]["placed"] == "(Shard(dim=1), Shard(dim=2))"


# ---------------------------------------------------------------------------
# op_cost (the counterpart of tests/test_distributed.py:67-114)
# ---------------------------------------------------------------------------

def test_op_cost_counts_the_local_shard_of_a_tp_matmul():
    out = _py(_FAKE + """
    x = dt((64, 512), Replicate())
    w = dt((512, 1024), Shard(1))
    with OpCost() as c:
        y = x @ w
    print(c.total.dot_flops, dict(c.census), y.placements)
    """)
    flops = float(out.split()[0])
    assert flops == 2 * 64 * 512 * 1024 / 4          # the local shard's matmul only
    assert "Shard(dim=1)" in out


def test_op_cost_counts_looped_collectives():
    out = _py(_FAKE + """
    import json
    x = dt((32, 64), Shard(1))
    w = dt((64, 64), Shard(0))
    with OpCost() as c:
        h = x
        for _ in range(6):   # row-parallel: each step's partial sum is all-reduced
            h = torch.tanh(h.redistribute(mesh, [Replicate(), Shard(1)]) @ w)
    print(json.dumps({"counts": dict(c.total.coll_count), "bytes": dict(c.total.coll_bytes)}))
    """)
    got = json.loads(out.strip().splitlines()[-1])
    assert got["counts"] == {"all-reduce": 6}
    assert got["bytes"]["all-reduce"] == 6 * 32 * 64 * 4   # each (32, 64) float32 operand


def test_op_cost_train_step_dot_flops_equal_the_closed_form():
    cfg = get_config("qwen2-7b", smoke=True)
    B, S = 4, 32
    params = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_batch(cfg, ShapeCell("t", "train", S, B), torch.Generator().manual_seed(1),
                           device="cpu")
    opt = AdamW(OptimizerConfig())
    step = make_train_step(api.get_model(cfg, attn="plain"), opt, microbatches=2)
    state = opt.init(params)
    with OpCost() as c:
        step(params, state, batch)
    assert c.total.dot_flops == train_dot_flops(cfg, B, S)
    assert c.total.flops > c.total.dot_flops and not c.total.coll_bytes


def test_op_cost_bytes_are_operands_and_outputs():
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    with OpCost() as c:
        y = (a @ b).relu()
        y.t()                                            # a view: free
    assert c.total.bytes == (32 + 24 + 12) * 4 + (12 + 12) * 4
    assert c.total.dot_flops == 2 * 4 * 8 * 3 and c.total.flops == 2 * 4 * 8 * 3 + 12
    assert c.peak_bytes == 2 * 12 * 4                     # the product and the relu


# ---------------------------------------------------------------------------
# dryrun, roofline, hotspots
# ---------------------------------------------------------------------------

def test_dryrun_writes_the_reference_record_for_a_smoke_cell(tmp_path):
    _py(f"""
    from pathlib import Path
    from repro_torch.launch import dryrun
    for shape in ("train_4k", "decode_32k"):
        dryrun.run_cell("mixtral-8x7b", shape, "single", Path({str(tmp_path)!r}),
                        smoke=True, mesh_shape=(2, 2))
    """, timeout=360)
    for shape in ("train_4k", "decode_32k"):
        rec = json.loads((tmp_path / f"mixtral-8x7b__{shape}__single.json").read_text())
        for key in ("arch", "shape", "mesh", "variant", "chips", "param_count",
                    "active_param_count", "tokens_per_step", "model_flops_global",
                    "flops_per_device", "dot_flops_per_device", "bytes_per_device",
                    "memory_analysis", "collectives", "op_census", "wall_s"):
            assert key in rec, key
        assert rec["chips"] == 4 and rec["dot_flops_per_device"] > 0
        assert set(rec["collectives"]) == {"collective_total_bytes", "by_op", "counts"}
        assert rec["memory_analysis"]["peak_size_in_bytes"] > 0
        row = roofline.roofline_row(rec)
        assert row["dominant"] in ("compute", "memory", "collective")
    train = json.loads((tmp_path / "mixtral-8x7b__train_4k__single.json").read_text())
    assert train["collectives"]["counts"]["reduce-scatter"] > 0   # FSDP gradients


def test_dryrun_refuses_the_families_of_the_next_slice():
    """Once refused, now built: ``all_cells("both")`` yields all 66 cells of
    the ten archs, and ``build_step`` builds a falcon-mamba decode on a fake
    (1, 2) mesh."""
    out = _py("""
    from repro_torch.launch import dryrun
    cfg, cell, mesh, rules, _ = dryrun.cell_setup("falcon-mamba-7b", "decode_32k", "single",
                                                  smoke=True, mesh_shape=(1, 2))
    fn, args, model = dryrun.build_step(cfg, cell, mesh, rules)
    print("built:", type(model).__name__, model.mesh is mesh, sorted(args[2]))
    """)
    assert "built: MambaLM True ['conv', 'len', 'ssm']" in out
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.dryrun import all_cells
    cells = list(all_cells("both"))
    assert len(cells) == len(set(cells)) == 66
    assert {a for a, _, _ in cells} == set(ARCH_IDS)
    # long_500k only for the sub-quadratic archs, on both meshes
    assert sorted(a for a, s, m in cells if s == "long_500k" and m == "single") == [
        "falcon-mamba-7b", "mixtral-8x7b", "zamba2-2.7b"]


def test_roofline_renders_a_record_with_h100_constants():
    rec = {"arch": "a", "shape": "train_4k", "mesh": "single", "chips": 256,
           "model_flops_global": 256 * 989e12 * 0.5, "flops_per_device": 989e12,
           "dot_flops_per_device": 989e12, "bytes_per_device": 3.35e12 * 0.25,
           "collectives": {"collective_total_bytes": 50e9 * 0.75},
           "memory_analysis": {"temp_size_in_bytes": 2**31}, "wall_s": 1.5}
    row = roofline.roofline_row(rec)
    assert row["compute_s"] == pytest.approx(1.0) and row["memory_s"] == pytest.approx(0.25)
    assert row["collective_s"] == pytest.approx(0.75) and row["dominant"] == "compute"
    assert row["roofline_fraction"] == pytest.approx(0.5) and row["temp_GiB"] == 2.0
    table = roofline.render_table([row])
    assert "| a | train_4k | single | 1.000 | 0.250 | 0.750 | **compute** | 0.50 |" in table
    assert HW.PEAK_FLOPS_BF16 == 989e12


def test_op_cost_charges_every_layer_of_the_loop_in_each_phase():
    cfg = get_config("qwen2-7b", smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_batch(cfg, ShapeCell("t", "train", 16, 2), torch.Generator().manual_seed(1),
                           device="cpu")
    opt = AdamW(OptimizerConfig())
    step = make_train_step(api.get_model(cfg, attn="plain"), opt)
    with OpCost() as c:
        step(params, opt.init(params), batch)
    for phase in ("forward", "recompute", "backward"):
        layers = {layer for ph, layer, _ in c.by_key if ph == phase}
        assert set(range(cfg.n_layers)) <= layers, (phase, layers)
    assert L.LAYER.get() is None       # the loop let go of its index


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "whisper-medium"])
def test_op_cost_charges_the_layers_of_the_other_families(arch):
    cfg = get_config(arch, smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_batch(cfg, ShapeCell("p", "prefill", 16, 2),
                           torch.Generator().manual_seed(1), device="cpu")
    with OpCost() as c:
        api.get_model(cfg, attn="plain").prefill(params, batch)
    assert {layer for _, layer, _ in c.by_key} >= set(range(cfg.n_layers))


@pytest.mark.parametrize("metric", ["flops", "bytes", "coll"])
def test_hotspot_levels_add_up(metric):
    cfg = get_config("mixtral-8x7b", smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_batch(cfg, ShapeCell("t", "train", 16, 2), torch.Generator().manual_seed(1),
                           device="cpu")
    opt = AdamW(OptimizerConfig())
    step = make_train_step(api.get_model(cfg, attn="plain"), opt)
    state = opt.init(params)
    with OpCost() as c:
        step(params, state, batch)
    lv = hotspots.levels(c, metric)
    total = hotspots.metric_of(c.total, metric)
    assert lv[0][1] == pytest.approx(total)
    for title, level_total, rows in lv:
        assert sum(v for _, v in rows) == pytest.approx(level_total)
    if metric == "flops":
        assert len(lv) == 2 and lv[0][2][0][0] == f"{hotspots.LOOP} × {cfg.n_layers}"
        assert any(name.startswith("layers._moe_groups") for name, _ in lv[1][2])
        assert any(name.endswith("(backward)") for name, _ in lv[1][2])
    text = hotspots.hotspots(c, metric, 3)
    assert text.splitlines()[0].startswith("step:")
