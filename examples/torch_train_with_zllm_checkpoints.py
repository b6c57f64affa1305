"""End-to-end example on the PyTorch/CUDA port: train a ~100M-param
qwen2-family model with fault-tolerant, zLLM-compressed checkpointing, resume
after a simulated crash, then serve the final weights from the compressed
store.

    PYTHONPATH=src python examples/torch_train_with_zllm_checkpoints.py \\
        [--steps 300] [--tiny] [--device cpu]

``--tiny`` shrinks the model (CI-speed); the default is a 16-layer d=512
GQA transformer (~95M params with its 32k-vocab embeddings). The model, the
optimizer and the store's kernels run on the card unless ``--device cpu``.
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.bitx import TorchBackend  # noqa: E402
from repro_torch.core.pipeline import ZLLMStore  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim.optimizers import OptimizerConfig  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.trainer import (FailureInjector, SimulatedFailure,  # noqa: E402
                                       TrainConfig, Trainer)


def model_100m(tiny: bool) -> ArchConfig:
    if tiny:
        return ArchConfig(name="qwen2-tiny", family="dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                          vocab=512, qkv_bias=True, rope_theta=1e6)
    return ArchConfig(name="qwen2-100m", family="dense", n_layers=16,
                      d_model=512, n_heads=8, n_kv_heads=2, d_ff=1792,
                      vocab=32768, qkv_bias=True, rope_theta=1e6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the model, the optimizer and the store's kernels run: "
                         "cuda (default) or cpu")
    args = ap.parse_args(argv)

    backend = TorchBackend(device=args.device)  # raises without a card unless --device cpu
    root = tempfile.mkdtemp(prefix="zllm-torch-train-")
    try:
        arch = model_100m(args.tiny)
        store = ZLLMStore(os.path.join(root, "store"), zstd_level=3, backend=backend)
        crash_at = args.steps // 2
        cfg = TrainConfig(
            arch=arch, seq_len=args.seq, global_batch=args.batch, microbatches=2,
            steps=args.steps, ckpt_every=max(args.steps // 6, 1),
            run_dir=os.path.join(root, "run"),
            optimizer=OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
            device=str(backend.device.type),
        )
        print(f"run dir: {cfg.run_dir}")
        print(f"model: {arch.name}, device: {backend.device}")
        print(f"params: {get_model(arch).param_count()/1e6:.1f}M\n")

        print(f"--- phase 1: train with a crash injected at step {crash_at} ---")
        t1 = Trainer(cfg, store=store, run_id="example-run",
                     failure=FailureInjector(fail_at_step=crash_at))
        try:
            t1.run()
        except SimulatedFailure as e:
            print(f"!! {e}")
        print(f"progressed to step {t1.history[-1]['step']}, "
              f"loss {t1.history[-1]['loss']:.3f}")

        print("\n--- phase 2: resume from the latest committed checkpoint ---")
        t2 = Trainer(cfg, store=store, run_id="example-run")
        print(f"resumed from step {t2.resumed_from}")
        hist = t2.run()
        first, last = t2.history[0], hist[-1]
        print(f"finished at step {last['step']}: loss {first['loss']:.3f} -> {last['loss']:.3f}")

        print("\n--- checkpoint storage through zLLM ---")
        for r in store.results:
            print(f"  {r.filename}: reduction {r.reduction:.1%} "
                  f"(bitx={r.n_bitx} dedup={r.n_dedup} zipnn={r.n_zipnn}) "
                  f"base={r.base_id or '-'}")
        print(f"  chain total: {store.stats.reduction_ratio:.1%} of "
              f"{store.stats.raw_bytes/2**20:.1f} MB saved")
        print(f"  store kernels: {backend.counters()['kernel_calls']}")

        print("\n--- phase 3: cold-start serving from the compressed store ---")
        final = f"checkpoint-{args.steps:08d}.safetensors"
        eng = ServeEngine.from_store(store, "example-run", final, arch, device=backend.device)
        same = all(torch.equal(eng.params[k], v) for k, v in t2.params.items())
        print(f"served params bit-equal to the trained ones: {same}")
        prompts = np.array([[5, 17, 42, 7]], np.int32)
        res = eng.generate(prompts, n_new=8)
        print(f"prompt {prompts[0].tolist()} -> generated {res.tokens[0, 4:].tolist()}")
        store.close()
        if not same:
            return 1
        print("\ndone")
        return 0
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
