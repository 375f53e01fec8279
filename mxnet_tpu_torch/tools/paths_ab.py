"""The generation lane and the ResNet-50 training step of this checkout
against another checkout's, on one card, in turns.

    python3 -m mxnet_tpu_torch.tools.paths_ab --other DIR

``DIR`` is the root of another checkout (for example a ``git archive`` of
the parent commit under ``build/``).  The tool runs ``chip_smoke.py``'s
phase 4 drive (``run_slice``: the bench LM's generation lane, 8 streamed
requests, then one full decode step timed on the host and on the card) and
its phase 8 drive (``run_resnet_training``: the bench ResNet-50, b128,
bf16, under ``MXTPU_CONV1X1=pallas`` and unset) from each checkout's root,
each run in a process of its own that builds or loads its checkout's
kernels first, in the order other, this, this, other.  It prints each
run's readings, then each checkout's mean.  The host-clock readings move
with the host's load; in turns, the two checkouts share it.
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
from mxnet_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev, card = torch.device("cuda", 0), cs.card_line()
_build.build_all()
cs.run_slice(dev, cs.CFG, cs.PROMPTS, cs.NEW_TOKENS, cs.NUM_BLOCKS, cs.PREFILL_BUCKETS,
             cs.DECODE_BUCKETS, cs.CHECKED, card)
for mode in ("pallas", ""):
    cs.run_resnet_training(dev, card, mode)
"""
# reading -> the pattern of its number in the drive's output
_READINGS = {
    "lane tokens/s": r"\] tokens/s ([\d.]+)",
    "inter-token ms p50": r"inter-token ms p50 ([\d.]+)",
    "decode step host wall ms": r"decode step \(B=\d+, \d+ layers\): ([\d.]+) ms host wall",
    "decode step card ms": r"ms host wall, ([\d.]+) ms on the card",
    "ResNet step ms p50 (pallas)": r"MXTPU_CONV1X1=pallas: step ms p50 ([\d.]+)",
    "ResNet step ms p50 (unset)": r"MXTPU_CONV1X1=unset: step ms p50 ([\d.]+)",
}


def _drive(root):
    """One drive from ``root``: ``{reading: value}``."""
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=root, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError("the drive failed in %s:\n%s" % (root, proc.stdout[-3000:]
                                                            + proc.stderr[-3000:]))
    out = {}
    for name, pattern in _READINGS.items():
        found = re.search(pattern, proc.stdout)
        if not found:
            raise RuntimeError("no %r in the drive's output from %s:\n%s"
                               % (name, root, proc.stdout[-3000:]))
        out[name] = float(found.group(1))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, help="root of another checkout")
    args = parser.parse_args(argv)
    runs = {"this": [], "other": []}
    for label in ("other", "this", "this", "other"):
        got = _drive(_ROOT if label == "this" else os.path.abspath(args.other))
        runs[label].append(got)
        print("  [%s] %s" % (label, ", ".join("%s %s" % kv for kv in got.items())))
    for name in _READINGS:
        print("  %s, mean of two runs: this %.3f, other %.3f"
              % (name, sum(r[name] for r in runs["this"]) / 2,
                 sum(r[name] for r in runs["other"]) / 2))


if __name__ == "__main__":
    main()
