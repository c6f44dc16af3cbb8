"""Device time of the two LM kernels on the card, for one or more source
trees in turns, so that two versions compare within one call on one card.

    python tools/lm_kernel_times.py [TREE ...] [--reps 20]

Each TREE is the root of a checkout (default: this one); its ``src/`` goes
first on the path of a child process, which builds that tree's kernels
(into its own ``build/``), times `flash_attention_bhsd` and `ssd_scan_grid`
at the shapes below and prints one JSON line per shape (the SSD's also
with each of its four stages' device microseconds, by torch.profiler:
`chip_smoke.ssd_stage_us`), after one line per kernel function it built
with ptxas's registers and spilled bytes.  The trees run in the order
given and then in reverse (A B B A).  A shape the tree's kernel refuses
reads "refused".  Times are device milliseconds a launch, CUDA events
around ``--reps`` launches behind a spin kernel
(`chip_smoke.Smoke.device_ms`); the card's name and power limit are
printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (name, (B, H, S, D), causal): the present rows of PERF.md's kernel table,
# then gemma-7b's attention (hf:google/gemma-7b: 16 heads of 256)
FLASH = (("zamba2-2.7b", (2, 32, 2048, 80), True),
         ("qwen2-moe-a2.7b", (2, 16, 2048, 128), True),
         ("hubert-xlarge", (2, 16, 2048, 80), False),
         ("pixtral-12b", (2, 32, 2048, 160), True),
         ("gemma-7b", (2, 16, 2048, 256), True))
# (name, (B, H, nc, L, p), n): zamba2-2.7b's and mamba2-2.7b's prefill at
# chunk 128, and mamba2-2.7b at Mamba2's own chunk of 256
SSD = (("zamba2-2.7b", (2, 80, 16, 128, 64), 64),
       ("mamba2-2.7b", (2, 80, 16, 128, 64), 128),
       ("mamba2-2.7b chunk 256", (2, 80, 8, 256, 64), 128))


def child(reps: int) -> None:
    """Time every shape with the kernels found first on the path."""
    import importlib.util

    import re

    import torch
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd

    src = str(Path(fa.__file__).resolve().parents[3])
    _build.build(["flash_attention", "ssd_scan"])
    for log in _build.BUILD_LOG.values():
        for fn, spill, regs in re.findall(
                r"Compiling entry function '(\S+)'.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers", log, re.S):
            name = re.search(r"(flash_(bf16|f32)(_wide)?|ssd_(cb|states|"
                             r"carry|out))(I\w+?E)?", fn).group(0)
            print(f"ptxas {src} {name}: {regs} registers, {spill} bytes "
                  f"spilled", flush=True)

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smoke = cs.Smoke()

    def emit(kernel, name, shape, dtype, call):
        rec = {"tree": src, "kernel": kernel, "name": name, "shape": shape,
               "dtype": dtype}
        try:
            rec["ms"] = smoke.device_ms(call, reps=reps)
            if kernel == "ssd_scan":
                rec["stage_us"] = cs.ssd_stage_us(smoke, call)[0]
        except (ValueError, RuntimeError) as e:
            rec["ms"] = f"refused: {str(e).splitlines()[0]}"
        print(json.dumps(rec), flush=True)

    for name, (B, H, S, D), causal in FLASH:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (smoke.randn((B, H, S, D), 300 + j, dtype)
                       for j in range(3))
            emit("flash_attention", name, [B, H, S, D], str(dtype)[6:],
                 lambda: fa.flash_attention_bhsd(q, k, v, causal=causal))
            del q, k, v
    for name, (b, h, nc, L, p), n in SSD:
        x = smoke.randn((b, h, nc, L, p), 311)
        dt = torch.nn.functional.softplus(smoke.randn((b, h, nc, L), 312))
        dA = dt * -torch.exp(smoke.randn((1, h, 1, 1), 313, scale=0.3))
        Bm = smoke.randn((b, nc, L, n), 314, scale=0.3)
        Cm = smoke.randn((b, nc, L, n), 315, scale=0.3)
        emit("ssd_scan", name, [b, h, nc, L, p, n], "float32",
             lambda: ssd.ssd_scan_grid(x, dt, dA, Bm, Cm))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.reps)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = [Path(t).resolve() for t in args.trees]
    for tree in trees + trees[::-1]:
        env = {**os.environ, "PYTHONPATH": str(tree / "src")}
        rc = subprocess.run([sys.executable, __file__, "--child", "--reps",
                             str(args.reps)], env=env).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
