"""Training driver:
``python -m repro_torch.launch.train --arch phi3-medium-14b [--smoke]
[--device cpu] [...]``.

Runs the training loop (synthetic or file corpus) on one device, the GPU
unless ``--device`` names another, with checkpoint/restart, preemption
handling and the straggler watchdog wired in.  ``--smoke`` takes the
reduced config (CPU-sized).  The flags are the reference's
(``repro/launch/train.py``) plus ``--device``; its default arch,
qwen2-72b, is not ported, so the default here is phi3-medium-14b.  A
``--model-parallel`` other than 1 raises: the mesh trainer is ROADMAP
Queue 1 item 18.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import make_source
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-medium-14b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when omitted")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--per-device-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "shampoo"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    args = ap.parse_args(argv)

    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel: the mesh trainer is not ported yet "
            "(ROADMAP Queue 1 item 18)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    if args.data == "synthetic":
        source = make_source("synthetic", vocab_size=cfg.vocab_size,
                             seq_len=args.seq_len)
    else:
        source = make_source("file", path=args.data_path,
                             vocab_size=cfg.vocab_size, seq_len=args.seq_len)

    tc = TrainerConfig(
        steps=args.steps,
        per_device_batch=args.per_device_batch,
        microbatches=args.microbatches,
        optimizer=args.optimizer,
        compression=args.compression,
        peak_lr=args.lr,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    trainer = Trainer(cfg, tc, source, device=args.device)
    print(f"training {cfg.name}: {cfg.param_count():,} params on "
          f"{trainer.device}")
    return trainer.run()


if __name__ == "__main__":
    main()
