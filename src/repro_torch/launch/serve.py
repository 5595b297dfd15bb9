"""Serve an LM with the PyTorch port: slot-batched prefill + decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b [--reduced]
        [--requests 4] [--max-new 16] [--torch-device cuda|cpu]

The LM branch of `repro/launch/serve.py`: builds `--arch` (full width, or
its reduced smoke-test variant) in fp32 with weights drawn from seed 0,
serves `--requests` random prompts of 4-10 tokens (numpy `default_rng(0)`)
through an `Engine` with max(2, requests // 2) slots and max_len 96, and
prints one `reqN:` line of generated tokens per request.  It runs on the
CUDA card unless `--torch-device cpu` is given, and raises when there is
no card.  The placement service (`--placement`) and the dry-run
(`--dry-run`) are not ported yet.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_arch, get_reduced
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--placement", action="store_true",
                    help="not ported yet (ROADMAP queue 1 item 9)")
    ap.add_argument("--dry-run", action="store_true",
                    help="not ported yet (ROADMAP queue 1 item 11)")
    args = ap.parse_args(argv)

    if args.placement:
        raise NotImplementedError("--placement: the placement service is not "
                                  "ported yet (ROADMAP queue 1 item 9)")
    if args.dry_run:
        raise NotImplementedError("--dry-run: the dry-run is not ported yet "
                                  "(ROADMAP queue 1 item 11)")
    if args.arch is None:
        ap.error("--arch is required")

    dev = resolve_device(args.torch_device)
    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    model = Transformer(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, n_slots=max(2, args.requests // 2), max_len=96, eos_id=-1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 10)).astype(np.int32)
               for _ in range(args.requests)]
    for i, toks in eng.generate(prompts, max_new=args.max_new).items():
        print(f"req{i}: {toks}")


if __name__ == "__main__":
    main()
