"""Quickstart for the PyTorch/CUDA port: the zLLM storage pipeline end to end,
including the remote-write -> range-read serving loop.

Part 1 builds a tiny synthetic hub of dense bf16 families (a base, a
fine-tune that declares its base, one that does not, an exact re-upload and
a second family), ingests it through the port's pipeline (FileDedup ->
TensorDedup -> family matching by metadata and bit distance -> BitX / ZipNN
byte planes -> zstd) and reconstructs every file bit-exactly. The BitX and
byte-plane transforms run on the store's ``TorchBackend``: the hand-written
CUDA kernels on the card, or their plain PyTorch versions with
``--device cpu``.

Part 2 runs the store as a hub node: the HTTP server in-process
(``ServerThread``), a new fine-tune remote-written with ``PUT`` (spooled,
ingested by a job polled through ``/admin/jobs``), then a tensor slice
fetched with an HTTP ``Range`` request and compared with the same slice of a
direct ``retrieve_tensor``. See docs/HTTP_API.md for every route.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import http.client
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.bitx import TorchBackend  # noqa: E402
from repro_torch.core.pipeline import ZLLMStore  # noqa: E402
from repro_torch.corpus import CorpusSpec, make_base_tensors, make_finetune, write_repo  # noqa: E402
from repro_torch.serve.store_server import ServerThread  # noqa: E402

SPEC = CorpusSpec(n_layers=3, d_model=128, d_ff=256, vocab=512)


def make_hub(hub: str, gen: torch.Generator) -> list:
    """Write the hub; returns (repo id, kind) in upload order."""
    base = make_base_tensors(SPEC, gen)
    write_repo(hub, "qwen/base", base)
    write_repo(hub, "alice/ft", make_finetune(base, SPEC, gen), base_model="qwen/base")
    # a low-band delta, so bit distance finds the base without metadata
    write_repo(hub, "bob/ft-undeclared", make_finetune(base, SPEC, gen, sigma_delta=0.001))
    shutil.copytree(os.path.join(hub, "alice/ft"), os.path.join(hub, "mirror/ft"))
    other = make_base_tensors(SPEC, gen)
    write_repo(hub, "llama/base", other)
    write_repo(hub, "carol/ft", make_finetune(other, SPEC, gen), base_model="llama/base")
    return [("qwen/base", "base"), ("alice/ft", "finetune"), ("bob/ft-undeclared", "finetune"),
            ("mirror/ft", "reupload"), ("llama/base", "base"), ("carol/ft", "finetune")]


def ingest_hub(store, hub, manifest) -> None:
    print(f"{'kind':<10} {'repo':<20} {'reduction':>9}  base (source)")
    for rid, kind in manifest:
        for r in store.ingest_repo(os.path.join(hub, rid), rid):
            base = f"{r.base_id} ({r.base_source})" if r.base_id else "-"
            if r.file_dedup_hit:
                base = "exact duplicate (FileDedup)"
            print(f"{kind:<10} {rid:<20} {r.reduction:>8.1%}  {base}")


def remote_write_then_range_read(store, gen: torch.Generator, tmp: str) -> None:
    """PUT a new fine-tune over HTTP, then range-read a tensor slice."""
    base = make_base_tensors(SPEC, torch.Generator(device=gen.device).manual_seed(0))
    write_repo(os.path.join(tmp, "up"), "demo/remote-ft", make_finetune(base, SPEC, gen))
    with open(os.path.join(tmp, "up", "demo/remote-ft", "model.safetensors"), "rb") as f:
        body = f.read()

    with ServerThread(store, max_concurrency=4) as srv:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        # remote write: 202 + job id; the spooled upload goes through the same
        # pipelined ingest engine as a local call
        conn.request("PUT", "/repo/demo/remote-ft/file/model.safetensors?base=qwen/base",
                     body=body)
        resp = conn.getresponse()
        job = json.loads(resp.read())
        print(f"\nPUT -> {resp.status}: job {job['job_id']} on root {job['root']} "
              f"({job['bytes']} bytes spooled)")
        while True:
            conn.request("GET", f"/admin/jobs?job={job['job_id']}")
            j = json.loads(conn.getresponse().read())
            if j["state"] in ("done", "failed"):
                break
            time.sleep(0.05)
        if j["state"] != "done":
            raise RuntimeError(f"ingest job failed: {j}")
        res = j["results"][0]
        print(f"ingest job {j['state']}: base={res['base_id']} ({res['n_bitx']} BitX tensors, "
              f"{1 - res['stored_bytes'] / res['raw_bytes']:.1%} reduction)")

        # range read: one tensor slice over keep-alive HTTP, compared with the
        # same slice of a direct store read
        name = "model.embed_tokens.weight"
        direct, _ = store.retrieve_tensor("demo/remote-ft", "model.safetensors", name)
        lo, hi = 256, 4096
        conn.request("GET", f"/repo/demo/remote-ft/tensor/{name}",
                     headers={"Range": f"bytes={lo}-{hi - 1}"})
        resp = conn.getresponse()
        part = resp.read()
        if resp.status != 206 or part != direct[lo:hi]:
            raise RuntimeError(f"ranged GET gave {resp.status}, not the direct read's bytes")
        print(f"ranged GET {name}[{lo}:{hi}] -> 206 ({resp.getheader('content-range')}, "
              f"codec={resp.getheader('x-tensor-codec')}): equal to the direct read")
        conn.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the store's kernels run: cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    backend = TorchBackend(device=args.device)  # raises without a card unless --device cpu
    gen = torch.Generator(device=backend.device).manual_seed(args.seed)
    tmp = tempfile.mkdtemp(prefix="zllm-torch-quickstart-")
    try:
        hub = os.path.join(tmp, "hub")
        manifest = make_hub(hub, gen)
        print(f"synthetic hub: {len(manifest)} repos under {hub}\n")
        store = ZLLMStore(os.path.join(tmp, "store"), workers=2, backend=backend)
        try:
            ingest_hub(store, hub, manifest)
            print("\nverifying bit-exact retrieval of every file...")
            for rid, _ in manifest:
                with open(os.path.join(hub, rid, "model.safetensors"), "rb") as f:
                    if store.retrieve_file(rid, "model.safetensors") != f.read():
                        raise RuntimeError(f"{rid} did not reconstruct bit-exactly")
            print("all files reconstruct bit-exactly")
            remote_write_then_range_read(store, gen, tmp)
            print("\nstorage report:")
            for k, v in store.summary().items():
                print(f"  {k}: {v}")
        finally:
            store.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
