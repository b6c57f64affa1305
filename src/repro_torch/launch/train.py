# Port of src/repro/launch/train.py: rewritten for the PyTorch trainer, flags kept.
"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --smoke \\
        --steps 50 --seq 128 --global-batch 8 \\
        [--store /path/to/run-store] [--fail-at 25] [--device cuda]

Runs the fault-tolerant trainer on one device: the card by default, the CPU
with ``--device cpu``; without a card and without ``--device cpu`` it exits
non-zero. ``--smoke`` selects the reduced config of the same family; full
configs are for the card. Checkpoints go through the port's zLLM store when
``--store`` is given; its kernels run on the same device. ``--mesh`` takes
only a one-device shape (``1,1``): the device mesh waits for the launch slice.

Without ``--run-dir`` each run writes into a fresh directory under the
temporary directory (``TMPDIR``) and prints its path; a run resumes only from
a ``--run-dir`` it is given. ``--fail-at`` crashes a run that starts from
scratch, which then exits 42; the same command again, with the same
``--run-dir``, resumes from its latest checkpoint and runs to the end (the
injected crash is not injected again into the restart, where the reference's
launcher would crash the restart at the same step); a run that finds its last
step already done trains 0 steps and exits 0. The store's index is loaded when the run starts and
saved when it ends (also when it fails), so a restarted run finds its first
checkpoint in the store and its later checkpoints keep BitX-chaining to it;
the reference's launcher leaves the index unsaved. Besides the reference's
``[train]`` lines the launcher names its device and prints one line per
checkpoint the store ingested in this run (lane counts and base).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--run-dir", default=None,
                    help="checkpoints and manifest (default: a fresh temporary directory)")
    ap.add_argument("--store", default=None, help="zLLM store root for checkpoints")
    ap.add_argument("--mesh", default=None, help="data,model (one device: 1,1)")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--remat", default="nothing", choices=["nothing", "dots", "none"])
    ap.add_argument("--grad-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated crash at this step (fault-tolerance demo)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.bitx import TorchBackend
    from repro_torch.core.pipeline import ZLLMStore
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.trainer import (FailureInjector, SimulatedFailure,
                                           TrainConfig, Trainer, train_device)

    device = train_device(args.device)
    run_dir = args.run_dir or tempfile.mkdtemp(prefix="repro-train-run-")
    arch = get_config(args.arch, smoke=args.smoke)
    mesh_shape = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None
    store = None
    if args.store:
        store = ZLLMStore(args.store, backend=TorchBackend(device=device.type))
        store.load_index()

    cfg = TrainConfig(
        arch=arch, seq_len=args.seq, global_batch=args.global_batch,
        microbatches=args.microbatches, steps=args.steps,
        ckpt_every=args.ckpt_every, run_dir=run_dir,
        resume=not args.no_resume, grad_dtype=args.grad_dtype,
        remat_policy=args.remat, mesh_shape=mesh_shape,
        optimizer=OptimizerConfig(name=arch.optimizer, lr=args.lr,
                                  total_steps=args.steps),
        device=device.type,
    )
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    print(f"[train] device {device} ({name}), arch {arch.name}, run dir {run_dir}")
    summary = None
    try:
        trainer = Trainer(cfg, store=store, run_id=f"{arch.name}-run",
                          failure=FailureInjector(fail_at_step=args.fail_at))
        if trainer.resumed_from is not None:
            print(f"[train] resumed from step {trainer.resumed_from}")
            # this run is the restart after the injected crash: it runs to the end
            trainer.failure = FailureInjector()
        try:
            hist = trainer.run()
        except SimulatedFailure as e:
            print(f"[train] {e} — restart with --run-dir {run_dir} to resume")
            sys.exit(42)
    finally:
        if store is not None:
            store.save_index()
            for r in store.results:
                print(f"[train] checkpoint {r.filename}: base {r.base_id or '-'} "
                      f"({r.base_source or 'none'}), {r.n_bitx} BitX / {r.n_zipnn} ZipNN / "
                      f"{r.n_dedup} dedup / {r.n_raw} raw of {r.n_tensors} tensors, "
                      f"{r.stored_bytes}/{r.raw_bytes} B")
            summary = store.summary()
            store.close()
    for h in hist[:: max(1, len(hist) // 10)]:
        print(f"[train] step {h['step']:>6} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f} {h['sec']*1e3:.0f} ms")
    if hist:
        print(f"[train] done: {len(hist)} steps, final loss {hist[-1]['loss']:.4f}")
    else:
        print(f"[train] done: 0 steps (step {cfg.steps} was already reached)")
    if summary is not None:
        print(f"[train] store: {json.dumps(summary)}")


if __name__ == "__main__":
    main()
