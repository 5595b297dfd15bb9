"""Batched serving demo: slot-based continuous batching with KV caches.

Port of `examples/serve_lm.py`:

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch yi-6b] [--torch-device cpu]

Builds the reduced config of the chosen arch (any of the ten; weights
from seed 0), admits a mixed batch of prompts through a 4-slot engine,
and reports per-request outputs plus decode throughput.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    tdev = resolve_device(args.torch_device)

    cfg = get_reduced(args.arch)
    model = Transformer(cfg, device=tdev, dtype=torch.float32,
                        generator=torch.Generator(device=tdev).manual_seed(0))
    eng = Engine(model, n_slots=4, max_len=64, eos_id=-1)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(3, 9))
               .astype(np.int32) for _ in range(args.requests)]

    t0 = time.time()
    results = eng.generate(prompts, max_new=args.max_new)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in results.values())
    print(f"arch={cfg.name} slots=4 requests={len(prompts)}")
    for i in sorted(results):
        print(f"  req{i}: prompt{list(prompts[i])} -> {results[i]}")
    print(f"\n{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s batched decode on {tdev.type})")


if __name__ == "__main__":
    main()
