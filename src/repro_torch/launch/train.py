"""Training launcher.

Port of `repro/launch/train.py`:

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        [--reduced] [--steps 100] [--ckpt-dir DIR] [--batch 8] [--seq 128] \
        [--torch-device cuda|cpu]

Trains the config (the family-preserving reduced one with --reduced)
through `train.trainer.Trainer` on one device, fp32, and prints each logged
row.  The fault-tolerance knobs (checkpoint cadence, recovery) ride on the
trainer.  `--dry-run` and `--multi-pod` (the reference's lowering on a
production mesh) wait for sharding and raise.
"""
import argparse

import torch

NOT_PORTED = ("{flag}: the dry-run and the multi-pod mesh are not ported yet "
              "(ROADMAP queue 1 item 11.5)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="run the family-preserving reduced config")
    ap.add_argument("--dry-run", action="store_true",
                    help="lower the full config on the production mesh (not ported)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    for flag in ("dry_run", "multi_pod"):
        if getattr(args, flag):
            raise NotImplementedError(NOT_PORTED.format(flag="--" + flag.replace("_", "-")))

    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    tr = Trainer(
        cfg,
        opt.OptConfig(lr=3e-4, warmup_steps=min(20, args.steps // 5 + 1),
                      total_steps=args.steps),
        TrainerConfig(steps=args.steps, ckpt_every=max(args.steps // 4, 10),
                      ckpt_dir=args.ckpt_dir, log_every=10,
                      param_dtype=torch.float32),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
        device=args.torch_device,
    )
    for h in tr.run_with_recovery():
        print(h)


if __name__ == "__main__":
    main()
