"""Training launcher: the fault-tolerant loop over a train step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
        [--steps 20] [--batch 8] [--seq 128] [--ckpt-dir DIR] \\
        [--save-every 10] [--compress-grads] [--device cuda]

The reference's flags, plus `--device` (default `cuda`; asking for CUDA
where there is none raises, it never runs on the CPU instead). As in the
reference, `--smoke` is on and cannot be turned off: the launcher trains
the architecture's reduced smoke config (the full-width run on the card
is `chip_smoke.py`'s `train` phase). The step is AdamW on a cosine
schedule with `TrainConfig(microbatches=2, remat=True)`, driven by a
`FaultTolerantTrainer` that checkpoints to `--ckpt-dir/<arch>` (default
under the temp directory) every `--save-every` steps, resumes from the
latest checkpoint there, and saves on SIGTERM. Weights are random,
drawn from a `torch.Generator` seeded 0; batches are random tokens from
numpy seeded 0, the targets the tokens shifted by one, and for the stub
frontends the embeddings the reference draws after them from the same
generator (f32 N(0, 1): whisper's `enc_seq_len` frames, llava's
`num_patches` patches).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (always on)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.ft import FaultTolerantTrainer
    from repro_torch.launch.serve import resolve_device, stub_len
    from repro_torch.models.model import Batch, Model
    from repro_torch.train import optim as O
    from repro_torch.train.step import TrainConfig, build_train_step

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = O.AdamW(lr=O.cosine_schedule(3e-4, 10, args.steps))
    tc = TrainConfig(microbatches=2, remat=True,
                     compress_grads=args.compress_grads)
    step = build_train_step(model, opt, tc)
    mgr = CheckpointManager(os.path.join(args.ckpt_dir, args.arch), keep=2)
    trainer = FaultTolerantTrainer(step, mgr, save_every=args.save_every,
                                   install_signal_handler=True)
    state = trainer.resume_or_init(params, opt.init(params))

    def batches():
        rng = np.random.default_rng(0)
        while True:
            t = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (args.batch, args.seq))).to(dev)
            n = stub_len(cfg)
            extra = None if n is None else torch.from_numpy(rng.normal(
                size=(args.batch, n, cfg.d_model)).astype(np.float32)).to(dev)
            yield Batch(t, torch.roll(t, -1, 1), extra)

    def on_metrics(i, m):
        if i % 5 == 0:
            print(f"step {i:4d} loss {m['loss']:.4f} "
                  f"{m['step_seconds']*1e3:6.0f} ms")

    out = trainer.run(state, batches(), max_steps=args.steps,
                      on_metrics=on_metrics)
    print(f"finished at step {out['step']}; "
          f"checkpoints in {mgr.dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
