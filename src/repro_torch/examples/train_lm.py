"""End-to-end example: train a ~100M-parameter LM for a few hundred steps.

Port of `examples/train_lm.py`:

    PYTHONPATH=src python -m repro_torch.examples.train_lm            # ~100M, 300 steps
    PYTHONPATH=src python -m repro_torch.examples.train_lm --quick    # tiny variant
        [--inject STEP] [--ckpt-dir DIR] [--torch-device cpu]

Exercises the whole training path: the synthetic pipeline, fp32 params
with the fp32 AdamW master, the rematerialised train step (flash
attention's kernel on the card), async atomic checkpoints, failure
injection and recovery (--inject), the loss printed every 10 steps.
Checkpoints go to --ckpt-dir (default: `repro_torch_train_lm` under the
temporary directory); a run finding one there resumes from it.
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, TrainerConfig


def model_100m():
    """~100M-param llama-style config (yi family, scaled down)."""
    return dataclasses.replace(
        get_arch("yi-6b"), name="yi-100m",
        n_layers=8, d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
        d_ff=2048, vocab=8192)


def model_tiny():
    return dataclasses.replace(
        model_100m(), name="yi-tiny", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=256, vocab=512)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--inject", type=int, default=None,
                    help="simulate a failure at this step, then recover")
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = model_tiny() if args.quick else model_100m()
    steps = args.steps or (30 if args.quick else 300)
    batch = args.batch or (4 if args.quick else 8)
    seq = args.seq or (64 if args.quick else 256)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"steps={steps} batch={batch} seq={seq}")

    tr = Trainer(
        cfg,
        opt.OptConfig(lr=1e-3, warmup_steps=20, total_steps=steps),
        TrainerConfig(steps=steps, ckpt_every=max(steps // 4, 10),
                      ckpt_dir=args.ckpt_dir, log_every=10,
                      inject_failure_at=args.inject,
                      param_dtype=torch.float32),
        DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch),
        device=args.torch_device,
    )
    hist = tr.run_with_recovery()
    print("\nstep  loss     lr        grad_norm  s/step")
    for h in hist:
        print(f"{h['step']:5d} {h['loss']:8.4f} {h['lr']:.2e} "
              f"{h['grad_norm']:9.3f} {h['sec_per_step']:.2f}")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'OK: learning' if last < first else 'WARN: not learning'})")
    return hist


if __name__ == "__main__":
    main()
