"""Serving launcher CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        [--reduced] [--requests 6] [--max-new 8] [--device cuda]

Random parameters from ``--seed`` (a ``torch.Generator`` on the device),
served by `ServeEngine` in bf16: any family that decodes (vlm text-only);
for the encoder (hubert-xlarge) the CLI exits with the engine's error.  ``--device`` defaults to the CUDA card;
``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    device = torch.device(args.device)
    params = lm.init_params(cfg, args.seed, device=device)
    try:
        eng = ServeEngine(cfg, params, batch_slots=args.slots,
                          max_len=args.max_len, device=device)
    except ValueError as e:   # the encoder has no decode
        raise SystemExit(f"serve: {e}") from None
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              size=int(rng.integers(3, 8))).astype(np.int32)
        eng.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))
    t0 = time.time()
    done = eng.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
          f"({toks/max(dt,1e-9):.1f} tok/s) on {device}")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.prompt.tolist()} -> {r.out}")


if __name__ == "__main__":
    main()
