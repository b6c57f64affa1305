"""Hub-at-scale simulation on the PyTorch/CUDA port (paper §5.2, Figure 8
dynamics): continuous uploads to a model hub, with the reduction-ratio
trajectory printed as models arrive — the "zLLM keeps improving as families
grow" effect — beside what whole-file dedup alone would save.

Each family is a dense bf16 base, its fine-tunes (some declare the base in
their model card, the rest are found by bit distance) and one exact
re-upload; the families' uploads arrive interleaved. The store's BitX and
byte-plane transforms run on its ``TorchBackend``: the hand-written CUDA
kernels on the card, or their plain PyTorch versions with ``--device cpu``.
Every file is then retrieved and held to its upload, byte for byte.

    PYTHONPATH=src python examples/torch_hub_simulation.py [--families 3] [--per-family 8] [--device cpu]
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.bitx import TorchBackend  # noqa: E402
from repro_torch.core.dedup import FileDedup  # noqa: E402
from repro_torch.core.pipeline import ZLLMStore  # noqa: E402
from repro_torch.corpus import CorpusSpec, make_base_tensors, make_finetune, write_repo  # noqa: E402

SPEC = CorpusSpec(n_layers=3, d_model=160, d_ff=384, vocab=1024)
METADATA_PROB = 0.4       # chance a fine-tune declares its base in its model card
UNDECLARED_SIGMA = 0.001  # a low-band delta, so bit distance finds the base


def bar(x: float, width: int = 36) -> str:
    return "#" * int(x * width)


def make_hub(hub: str, families: int, per_family: int, gen: torch.Generator) -> list:
    """Write the hub; returns (repo id, kind) in arrival order."""
    queues = []
    for f in range(families):
        base_id = f"org{f}/base"
        base = make_base_tensors(SPEC, gen)
        write_repo(hub, base_id, base)
        q = [(base_id, "base")]
        for i in range(per_family):
            rid = f"user{f}-{i}/ft"
            if float(torch.rand((), generator=gen, device=gen.device)) < METADATA_PROB:
                write_repo(hub, rid, make_finetune(base, SPEC, gen), base_model=base_id)
                q.append((rid, "finetune"))
            else:
                write_repo(hub, rid, make_finetune(base, SPEC, gen, UNDECLARED_SIGMA))
                q.append((rid, "finetune-undecl"))
        shutil.copytree(os.path.join(hub, q[-1][0]), os.path.join(hub, f"mirror{f}/ft"))
        q.append((f"mirror{f}/ft", "reupload"))
        queues.append(q)
    # every base first, then the families' uploads interleaved
    return [q[i] for i in range(max(map(len, queues))) for q in queues if i < len(q)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", type=int, default=3)
    ap.add_argument("--per-family", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the store's kernels run: cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    backend = TorchBackend(device=args.device)  # raises without a card unless --device cpu
    gen = torch.Generator(device=backend.device).manual_seed(args.seed)
    tmp = tempfile.mkdtemp(prefix="zllm-torch-hub-")
    try:
        hub = os.path.join(tmp, "hub")
        manifest = make_hub(hub, args.families, args.per_family, gen)
        zllm = ZLLMStore(os.path.join(tmp, "zllm"), workers=2, backend=backend)
        filededup = FileDedup()
        try:
            print(f"{'#':>3} {'kind':<15} {'zLLM reduction trajectory':<40} {'file-dedup'}")
            for i, (rid, kind) in enumerate(manifest):
                zllm.ingest_repo(os.path.join(hub, rid), rid)
                filededup.scan_file(os.path.join(hub, rid, "model.safetensors"), rid)
                z = zllm.stats.reduction_ratio
                f = filededup.stats.reduction_ratio
                print(f"{i + 1:>3} {kind:<15} {bar(z):<40} {z:6.1%} | {f:6.1%}")
            for rid, _ in manifest:
                with open(os.path.join(hub, rid, "model.safetensors"), "rb") as fh:
                    if zllm.retrieve_file(rid, "model.safetensors") != fh.read():
                        raise RuntimeError(f"{rid} did not reconstruct bit-exactly")
            print("\nevery file reconstructs bit-exactly")
            s = zllm.summary()
        finally:
            zllm.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"final: zLLM saves {s['reduction_ratio']:.1%} "
          f"({s['raw_bytes'] / 2**20:.1f} MB -> {s['stored_bytes'] / 2**20:.1f} MB) "
          f"across {s['n_files']} files")
    print(f"tensor pool: {s['tensor_dedup']['unique_hashes']} unique tensors; "
          f"{s['bitdistance_comparisons']} bit-distance comparisons; "
          f"{s['file_dedup_hits']} exact re-uploads")
    print(f"device: {backend.device}; store kernels: {s['backend_counters']['kernel_calls']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
