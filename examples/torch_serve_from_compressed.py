"""Serving cold start from the compressed store (paper §4.4.4) on the
PyTorch/CUDA port, two ways:

1. **In-process**: ingest a base and fine-tune pair, cold-start the
   FINE-TUNE (stored as a BitX delta against its base: decoded, verified,
   loaded to the device) and serve a batch of generation requests through
   the static batcher.
2. **Over HTTP**: start the store server in-process (``ServerThread``) and
   replay the loop a cold-starting loader would use: ``PUT`` the fine-tune
   to the server (spooled, ingested by a job), then fetch one tensor's byte
   range with ``Range: bytes=`` and compare it with the in-process
   reconstruction. See docs/HTTP_API.md for every route.

The store's kernels and the model run on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_from_compressed.py [--device cpu]
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.bitx import TorchBackend  # noqa: E402
from repro_torch.core.pipeline import ZLLMStore  # noqa: E402
from repro_torch.corpus import CorpusSpec, make_finetune, write_repo  # noqa: E402
from repro_torch.models.api import init_params  # noqa: E402
from repro_torch.serve.engine import RequestBatcher, ServeEngine  # noqa: E402
from repro_torch.serve.store_server import ServerThread  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the store's kernels and the model run: cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    backend = TorchBackend(device=args.device)  # raises without a card unless --device cpu
    device = backend.device
    arch = get_config("qwen2-7b", smoke=True)
    tmp = tempfile.mkdtemp(prefix="zllm-torch-serve-")
    try:
        # a base and fine-tune pair of this architecture on the "hub"
        gen = torch.Generator(device=device).manual_seed(args.seed)
        base = init_params(arch, gen)
        ft = make_finetune(base, CorpusSpec(untouched_prob=0.0), gen)
        hub = os.path.join(tmp, "hub")
        write_repo(hub, "org/base", {f"params/{k}": v for k, v in base.items()})
        write_repo(hub, "user/ft", {f"params/{k}": v for k, v in ft.items()},
                   base_model="org/base")

        store = ZLLMStore(os.path.join(tmp, "store"), workers=2, backend=backend)
        try:
            store.ingest_repo(os.path.join(hub, "org/base"), "org/base")
            r = store.ingest_repo(os.path.join(hub, "user/ft"), "user/ft")[0]
            print(f"fine-tune stored at {r.reduction:.1%} reduction (base={r.base_id}, "
                  f"source={r.base_source}, bitx tensors={r.n_bitx})")

            # cold start, in-process: BitX-decode against the base, verify, serve
            eng = ServeEngine.from_store(store, "user/ft", "model.safetensors", arch,
                                         device=device)
            for name, t in ft.items():
                if not torch.equal(eng.params[name].view(torch.int16), t.view(torch.int16)):
                    raise RuntimeError(f"cold-started {name} differs from the source")
            print(f"fine-tune reconstructed, verified and loaded to {device}: "
                  f"{len(eng.params)} params bit-equal to the source")

            rng = np.random.default_rng(args.seed)
            batcher = RequestBatcher(eng, batch_size=4, n_new=6)
            reqs = [batcher.submit(rng.integers(1, arch.vocab, n).astype(np.int32))
                    for n in (3, 5, 4, 2, 6, 3)]
            served = []
            while len(served) < len(reqs):
                served += batcher.run_once()
            for rid in reqs:
                print(f"  request {rid}: -> {batcher.result(rid).tolist()}")
            print("batched serving done")

            # cold start, over HTTP: remote-write a copy of the fine-tune, then
            # range-read one tensor slice (the network loader's path)
            ft_file = os.path.join(hub, "user/ft", "model.safetensors")
            with open(ft_file, "rb") as f:
                body = f.read()
            with ServerThread(store, max_concurrency=4) as srv:
                conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
                conn.request("PUT", "/repo/user/ft-remote/file/model.safetensors"
                                    "?base=org/base&sync=1", body=body)
                resp = conn.getresponse()
                job = json.loads(resp.read())["job"]
                if resp.status != 200 or job["state"] != "done":
                    raise RuntimeError(f"remote write failed: {job}")
                res = job["results"][0]
                if res["file_dedup_hit"]:
                    print("remote write ingested: exact duplicate of user/ft "
                          "(FileDedup hit, no new bytes stored)")
                else:
                    print(f"remote write ingested: {res['n_tensors']} tensors, "
                          f"dedup={res['n_dedup']} bitx={res['n_bitx']}")

                name = "params/embed"
                direct, _ = store.retrieve_tensor("user/ft-remote", "model.safetensors", name)
                lo, hi = 0, min(len(direct), 65536)
                t0 = time.perf_counter()
                conn.request("GET", f"/repo/user/ft-remote/tensor/{name}",
                             headers={"Range": f"bytes={lo}-{hi - 1}"})
                resp = conn.getresponse()
                part = resp.read()
                dt = time.perf_counter() - t0
                if resp.status != 206 or part != direct[lo:hi]:
                    raise RuntimeError(f"ranged GET gave {resp.status}, not the direct read's "
                                       f"bytes")
                print(f"ranged GET {name}[{lo}:{hi}] over HTTP in {dt * 1e3:.1f} ms "
                      f"(codec={resp.getheader('x-tensor-codec')}): equal to the in-process "
                      f"reconstruction")
                conn.close()
            print(f"store kernels: {store.summary()['backend_counters']['kernel_calls']}")
        finally:
            store.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
