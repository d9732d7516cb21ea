"""Command line of the port: train VGG-11 on CIFAR-10 with the ``single``
strategy on one GPU, with the reference training script's print schedule.

    python -m cs744_ddp_tpu_torch.cli --strategy single
    python -m cs744_ddp_tpu_torch.cli --limit-train-batches 40

Without ``cifar-10-batches-py`` under ``--data-dir`` the deterministic
synthetic stand-in is used.  ``--device cpu`` runs on the CPU (slow: the
CUDA kernels' plain versions replace them there).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .ops.sgd import SGDConfig
from .train.loop import GLOBAL_BATCH, STRATEGIES, Trainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m cs744_ddp_tpu_torch.cli",
        description="Train VGG-11 on CIFAR-10 (PyTorch/CUDA port).")
    p.add_argument("--strategy", default="single",
                   help=f"gradient-sync strategy; ported so far: {STRATEGIES}")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=GLOBAL_BATCH,
                   help="global batch size")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--no-augment", action="store_true",
                   help="normalize only: no random crop/flip")
    p.add_argument("--limit-train-batches", type=int, default=None)
    p.add_argument("--limit-eval-batches", type=int, default=None)
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    trainer = Trainer(
        "vgg11", args.strategy, global_batch=args.batch_size,
        data_dir=args.data_dir, device=args.device,
        augment=not args.no_augment,
        sgd_cfg=SGDConfig(lr=args.lr, momentum=args.momentum,
                          weight_decay=args.weight_decay),
        limit_train_batches=args.limit_train_batches,
        limit_eval_batches=args.limit_eval_batches)
    trainer.run(args.epochs)


if __name__ == "__main__":
    main()
