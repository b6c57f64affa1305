# Port of src/repro/launch/hlo_hotspots.py: the same descent, over counted aten ops.
"""Hotspot descent over one counted step — the dry run's "profiler".

:class:`repro_torch.launch.op_cost.OpCost` charges every op to the innermost
``repro_torch`` frame that issued it, to the index of the model's layer loop
(the python loop that replaces ``lax.scan``) and to its phase (forward,
recompute, backward; a backward op to the frame of the forward op it
differentiates). This tool prints the top contributors at the step's level,
where the whole layer loop is one row, and descends into the loop when it
dominates, as the reference descends into the dominant ``while``: each level's
rows add up to its total.

Usage:
    python -m repro_torch.launch.hotspots --arch qwen2-7b --shape train_4k \\
        [--mesh single] [--metric bytes|flops|coll] [--top 5] [--variant ...]
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Dict, List, Tuple

__all__ = ["levels", "hotspots", "metric_of"]

LOOP = "layer loop"


def metric_of(c, name: str) -> float:
    """One metric of a :class:`CostSummary`: ``bytes``, ``flops`` or ``coll``."""
    if name == "coll":
        return c.collective_total
    return getattr(c, name)


def levels(cost, metric: str = "bytes") -> List[Tuple[str, float, List[Tuple[str, float]]]]:
    """``[(title, total, rows)]``: the step's level (every site outside the
    layer loop, and the loop as one row), then, when the loop is the largest
    row, the loop's level (its sites by phase, over all layers). Rows are
    sorted, largest first, and add up to the level's total."""
    step: Dict[str, float] = defaultdict(float)
    loop: Dict[str, float] = defaultdict(float)
    layers = set()
    for (phase, layer, site), c in cost.by_key.items():
        v = metric_of(c, metric)
        if layer is None:
            step[f"{site} ({phase})"] += v
        else:
            layers.add(layer)
            loop[f"{site} ({phase})"] += v
    if loop:
        step[f"{LOOP} × {len(layers)}"] = sum(loop.values())
    out = [("step", sum(step.values()), sorted(step.items(), key=lambda r: -r[1]))]
    rows = out[0][2]
    if rows and rows[0][0].startswith(LOOP):
        out.append((f"--> {rows[0][0]}", rows[0][1], sorted(loop.items(), key=lambda r: -r[1])))
    return out


def hotspots(cost, metric: str = "bytes", top: int = 5) -> str:
    lines = []
    for depth, (title, total, rows) in enumerate(levels(cost, metric)):
        pad = "  " * depth
        lines.append(f"{pad}{title}: {total:.3e} {metric}")
        for name, v in rows[:top]:
            share = v / total if total else 0.0
            lines.append(f"{pad}  {v:.3e} {metric} {share:6.1%}  {name}")
    return "\n".join(lines)


def main(argv=None):
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--metric", default="bytes", choices=["bytes", "flops", "coll"])
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--variant", default="")
    args = ap.parse_args(argv)

    cfg, cell, mesh, rules, opts = dryrun.cell_setup(args.arch, args.shape, args.mesh,
                                                     args.variant)
    fn, fargs, _ = dryrun.build_step(cfg, cell, mesh, rules,
                                     remat_policy=opts.get("remat", "nothing"),
                                     grad_dtype=opts.get("grad", "float32"))
    cost, _ = dryrun.count_step(fn, fargs, attribute=True)
    print(hotspots(cost, args.metric, args.top))


if __name__ == "__main__":
    main()
