"""Training launcher.

Port of `repro/launch/train.py`:

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        [--reduced] [--steps 100] [--ckpt-dir DIR] [--batch 8] [--seq 128] \
        [--torch-device cuda|cpu] [--dry-run [--multi-pod]]

Trains the config (the family-preserving reduced one with --reduced)
through `train.trainer.Trainer` on one device, fp32, and prints each logged
row.  The fault-tolerance knobs (checkpoint cadence, recovery) ride on the
trainer.  `--dry-run` traces the full config's train_4k step on the 16x16
production mesh (2x16x16 with `--multi-pod`) through `launch.dryrun`, in a
fresh interpreter: its fake process group is process-global.
"""
import argparse
import subprocess

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="run the family-preserving reduced config")
    ap.add_argument("--dry-run", action="store_true",
                    help="trace the full config's train step on the 16x16 mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.multi_pod and not args.dry_run:
        ap.error("--multi-pod applies to --dry-run")
    if args.dry_run:
        from repro_torch.launch import dryrun
        cmd, env = dryrun.command(args.arch, "train_4k", args.multi_pod,
                                  device=args.torch_device)
        raise SystemExit(subprocess.run(cmd, env=env).returncode)

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
