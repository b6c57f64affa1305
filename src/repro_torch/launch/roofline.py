# Port of src/repro/launch/roofline.py: the same rows, with the H100's peaks.
"""Roofline over the dry-run records, with one H100's datasheet peaks.

Reads experiments/dryrun_torch/*.json (written by ``repro_torch.launch.dryrun``)
and derives, per (arch × shape × mesh):

    compute term    = dot_FLOPs_per_device / 989 TFLOP/s        (bf16 tensor cores)
    memory term     = HBM_bytes_per_device / 3.35 TB/s
    collective term = collective_bytes_per_device / 50 GB/s     (one 400 Gb/s NIC)

plus: the dominant term, MODEL_FLOPS = 6·N_active·tokens (train) or
2·N_active·tokens (prefill/decode), the usefulness ratio
MODEL_FLOPS / (FLOPs·chips), and a roofline fraction

    RF = [MODEL_FLOPS / (chips · peak)] / max(terms)

— the fraction of the step's resource-bound lower-bound time that is useful
model compute. All numerators are per device (the counts are of rank 0's
local shards); collective bytes assume one link per device (the slowest a
16-wide axis crosses: ``launch.mesh.HW``). The memory term counts every
operand and output of every eager op, so it is an upper bound on what a
fused program moves.

Usage: python -m repro_torch.launch.roofline [--dir experiments/dryrun_torch] [--md out.md]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

from repro_torch.launch.mesh import HW

__all__ = ["load_records", "roofline_row", "render_table"]

DEFAULT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

LONG_SKIPS = {
    "qwen2-vl-7b": "full attention (M-RoPE), quadratic",
    "granite-20b": "full attention, quadratic",
    "phi4-mini-3.8b": "full attention, quadratic",
    "deepseek-coder-33b": "full attention, quadratic",
    "qwen2-7b": "full attention, quadratic",
    "grok-1-314b": "full attention, quadratic",
}


def load_records(d: Path, variant: str = "") -> List[Dict]:
    out = []
    for p in sorted(d.glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("variant", "") == variant:
            out.append(rec)
    return out


def roofline_row(rec: Dict) -> Dict:
    chips = rec["chips"]
    compute_s = rec.get("dot_flops_per_device", rec["flops_per_device"]) / HW.PEAK_FLOPS_BF16
    memory_s = rec["bytes_per_device"] / HW.HBM_BW
    coll_s = rec["collectives"]["collective_total_bytes"] / HW.LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    t_model = rec["model_flops_global"] / (chips * HW.PEAK_FLOPS_BF16)
    rf = t_model / bound if bound > 0 else 0.0
    rf_compute = t_model / compute_s if compute_s > 0 else 0.0
    useful = rec["model_flops_global"] / max(rec["flops_per_device"] * chips, 1e-9)
    mxu_useful = rec["model_flops_global"] / max(
        rec.get("dot_flops_per_device", 0.0) * chips, 1e-9)
    temp_gib = rec.get("memory_analysis", {}).get("temp_size_in_bytes", 0) / 2**30
    recommend = {
        "compute": "cut recomputation (remat policy) / reduce non-model FLOPs",
        "memory": "raise arithmetic intensity: larger microbatch, fuse, avoid fp32 spills",
        "collective": "overlap or shrink collectives: bf16 grads, better layout, fewer reshards",
    }[dominant]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": rec["model_flops_global"],
        "useful_ratio": useful,          # MODEL_FLOPS / total FLOPs (all devices)
        "mxu_useful_ratio": mxu_useful,  # MODEL_FLOPS / dot FLOPs only
        "roofline_fraction": rf,
        "rf_compute": rf_compute,        # useful / total tensor-core time
        "temp_GiB": temp_gib,
        "recommend": recommend,
        "wall_s": rec.get("wall_s"),
    }


def render_table(rows: List[Dict], title: str = "Roofline (H100 SXM peaks)") -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | dominant "
           "| RF | RFc | 6ND/FLOPs | temp GiB | dry-run wall s | next lever |")
    sep = "|" + "---|" * 13
    lines = [f"### {title}", "", hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['compute_s']:.3f} "
            f"| {r['memory_s']:.3f} | {r['collective_s']:.3f} | **{r['dominant']}** "
            f"| {r['roofline_fraction']:.2f} | {r['rf_compute']:.2f} | {r['useful_ratio']:.2f} "
            f"| {r['temp_GiB']:.1f} | {r['wall_s'] or 0:.1f} | {r['recommend']} |")
    lines.append("")
    lines.append("Skipped long_500k cells (quadratic attention):")
    for a, why in LONG_SKIPS.items():
        lines.append(f"- {a}: {why}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(DEFAULT_DIR))
    ap.add_argument("--variant", default="")
    ap.add_argument("--md", default=None)
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    args = ap.parse_args(argv)
    recs = load_records(Path(args.dir), args.variant)
    if args.mesh:
        recs = [r for r in recs if r["mesh"] == args.mesh]
    rows = [roofline_row(r) for r in recs]
    rows.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    table = render_table(rows)
    print(table)
    if args.md:
        Path(args.md).write_text(table)


if __name__ == "__main__":
    main()
