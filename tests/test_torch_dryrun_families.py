"""The dry run of the SSM and Whisper families (``launch/dryrun.py`` with
falcon-mamba-7b, zamba2-2.7b and whisper-medium), on the CPU, each in a
subprocess as rank 0 of a fake process group.

* Smoke configs on fake (2, 2) and (2, 2, 2) meshes: a train, a prefill, a
  decode and a ``long_500k`` cell across the three families (each family's
  train step on a real (2, 2) group is in ``test_torch_mesh_families.py``);
  each record exists and shows collectives of the expected kinds
  (reduce-scatter in train, the packed projections' all-to-all,
  all-reduce in sequence-parallel decode).
* Mamba-1's scan FLOPs on a (1, 4) mesh are the (1, 1) figure / 4 within 1%:
  no model rank repeats another's channels. zamba2's SSD terms split the
  same way but its C·Bᵀ, which every model rank computes whole, as in the
  reference.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.configs import get_config

REPO = os.path.join(os.path.dirname(__file__), "..")


def _py(script, timeout=420):
    """``script`` in a subprocess below the other tests' priority."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", "import os; os.nice(10)\n" + textwrap.dedent(script)],
                       capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


_DRY = """
    import json, dataclasses
    from pathlib import Path
    from repro_torch import configs
    from repro_torch.launch import dryrun
    # the smoke SSMs' scan chunk raised to 512: the cells' 4096-token
    # sequences then loop 8 chunks, not 512
    for a in ("falcon-mamba-7b", "zamba2-2.7b"):
        c = configs.SMOKES[a]
        configs.SMOKES[a] = dataclasses.replace(c, ssm=dataclasses.replace(c.ssm, chunk=512))
    for arch, shape in %r:
        rec = dryrun.run_cell(arch, shape, "single", Path(%r), smoke=True, mesh_shape=%r)
        print(json.dumps({"arch": arch, "shape": shape, "counts": rec["collectives"]["counts"],
                          "chips": rec["chips"], "dot": rec["dot_flops_per_device"]}))
"""


@pytest.mark.parametrize("mesh,cells", [
    ((2, 2), [("falcon-mamba-7b", "train_4k"), ("zamba2-2.7b", "decode_32k"),
              ("whisper-medium", "decode_32k")]),
    ((2, 2, 2), [("falcon-mamba-7b", "prefill_32k"), ("zamba2-2.7b", "long_500k"),
                 ("whisper-medium", "decode_32k")]),
])
def test_dryrun_cells_of_the_new_families(tmp_path, mesh, cells):
    out = _py(_DRY % (cells, str(tmp_path), mesh), timeout=420)
    recs = [json.loads(line) for line in out.strip().splitlines() if line.startswith("{")]
    assert [(r["arch"], r["shape"]) for r in recs] == cells
    for r in recs:
        assert (tmp_path / f"{r['arch']}__{r['shape']}__single.json").exists()
        assert r["chips"] == int(np.prod(mesh)) and r["dot"] > 0
        counts = r["counts"]
        if r["shape"] == "train_4k":
            assert counts.get("reduce-scatter", 0) > 0, r     # FSDP gradients
            assert counts.get("all-to-all", 0) > 0 or r["arch"] == "whisper-medium", r
        if r["shape"] == "prefill_32k":
            assert counts.get("all-to-all", 0) > 0, r       # the packed projection
        if r["shape"] in ("decode_32k", "long_500k") and r["arch"] != "falcon-mamba-7b":
            # flash-decoding over the sequence-sharded cache: one max, two sums a call
            assert counts.get("all-reduce", 0) >= 3, r


_SCAN_FLOPS = """
    import dataclasses, json
    from repro_torch import configs
    from repro_torch.launch import dryrun
    out = {}
    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        cfg, cell, mesh, rules, _ = dryrun.cell_setup(arch, "prefill_32k", "single", smoke=True,
                                                      mesh_shape=%r)
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=64))
        cell = dataclasses.replace(cell, seq_len=256, global_batch=4)
        fn, args, _ = dryrun.build_step(cfg, cell, mesh, rules)
        cost, _ = dryrun.count_step(fn, args, attribute=True)
        sites = {}
        for (_, _, site), c in cost.by_key.items():
            sites[site] = sites.get(site, 0.0) + c.flops
        out[arch] = sites
    print(json.dumps(out))
"""


def test_ssm_scan_flops_split_by_the_model_axis():
    one, four = (json.loads(_py(_SCAN_FLOPS % (shape,)).strip().splitlines()[-1])
                 for shape in ((1, 1), (1, 4)))
    scan = ("ssm._selective_scan", "ssm.chunk_body", "ssm._affine_scan")
    f1 = sum(v for k, v in one["falcon-mamba-7b"].items() if k in scan)
    f4 = sum(v for k, v in four["falcon-mamba-7b"].items() if k in scan)
    assert f1 > 0 and f4 == pytest.approx(f1 / 4, rel=1e-2)
    # zamba2's SSD chunk body: its head-indexed terms split four ways, the
    # (c x c) C·Bᵀ of each chunk (2·c·c·N a batch row) stays whole on each rank
    cfg = get_config("zamba2-2.7b", smoke=True)
    B, S, c, N = 4, 256, 64, cfg.ssm.d_state
    cb = 2.0 * B * (S // c) * c * c * N * cfg.n_layers
    z1, z4 = one["zamba2-2.7b"]["ssm.chunk_body"], four["zamba2-2.7b"]["ssm.chunk_body"]
    assert z4 == pytest.approx(cb + (z1 - cb) / 4, rel=1e-2)
