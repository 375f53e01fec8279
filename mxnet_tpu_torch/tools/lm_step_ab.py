"""The bench LM's bf16 training step of this checkout against another
checkout's, on one card, in turns.

    python3 -m mxnet_tpu_torch.tools.lm_step_ab --other DIR

``DIR`` is the root of another checkout (for example a ``git archive`` of
the parent commit under ``build/``).  The tool runs ``chip_smoke.py``'s
phase 6 drive (``run_training``: the bench LM, 12 layers, batch 8, T 2048,
bf16, one warm-up and five timed steps, then one profiled step) from each
checkout's root, each run in a process of its own, in the order other,
this, this, other, and prints each run's p50 step and its bf16 flash
kernels' device time in the profiled step, then each checkout's mean.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

__all__ = ["main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DRIVE = """
import torch, chip_smoke as cs
cs.run_training(torch.device("cuda", 0), dict(cs.CFG, dtype="bfloat16"), cs.card_line())
"""


def _drive(root):
    """One drive from ``root``: ``(p50 step ms, {kernel: ms in the profiled
    step})``."""
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=root, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError("the drive failed in %s:\n%s" % (root, proc.stdout[-3000:]
                                                            + proc.stderr[-3000:]))
    p50 = float(re.search(r"step ms p50 ([\d.]+)", proc.stdout).group(1))
    kernels = {name: float(ms) for name, ms in re.findall(
        r"(flash_\w+_kernel)<\d+>\S*\s+([\d.]+) ms\s+\d+ launches", proc.stdout)}
    return p50, kernels


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, help="root of another checkout")
    args = parser.parse_args(argv)
    runs = {"this": [], "other": []}
    for label in ("other", "this", "this", "other"):
        p50, kernels = _drive(_ROOT if label == "this" else args.other)
        runs[label].append(p50)
        print("  [%s] bf16 LM step p50 %.1f ms; flash kernels in the profiled step: %s"
              % (label, p50, ", ".join("%s %.2f ms" % kv for kv in sorted(kernels.items()))))
    print("  bf16 LM step, mean of two p50s: this %.2f ms, other %.2f ms"
          % (sum(runs["this"]) / 2, sum(runs["other"]) / 2))


if __name__ == "__main__":
    main()
