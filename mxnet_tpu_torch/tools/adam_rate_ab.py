"""``Module.update`` with Adam over the bench LM, with ``adam_rate``'s memo
(the bias-corrected rate made once a step) against the rate made anew for
every parameter, in turns, on one card.

    python3 -m mxnet_tpu_torch.tools.adam_rate_ab [--rounds 5]

The tool builds the port's kernels, trains ``chip_smoke.py``'s phase 11
Module (the bench LM, 12 layers, d1024, T 2048, batch 8, bf16, Adam lr
1e-4, phase 6's seed-0 weights) for one batch, then times
``Module.update`` on that batch's gradients: host wall and the card's span
between two events, in the order on, off, off, on for each round.  It
prints each setting's medians and every reading.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

__all__ = ["main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Forgetful(dict):
    """A memo that keeps nothing: ``adam_rate`` makes the rate anew for
    every parameter."""

    def __setitem__(self, key, value):
        pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    sys.path.insert(0, _ROOT)
    import chip_smoke as cs

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import tensor as ops_tensor

    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    print("built in %.1f s" % _build.build_all())
    dev = torch.device("cuda", 0)
    cfg = dict(cs.CFG, dtype="bfloat16")
    b = cs.TRAIN_BATCH
    host = cs._host_batch(cfg, b, cs.SEED)
    tr = cs._trainer(cfg, b, dev, rescale_grad=1.0 / b, optimizer="adam",
                     learning_rate=cs.MODULE_OPTIMIZERS["adam"]["learning_rate"])
    params = tr.init(seed=cs.SEED)[0]
    del tr
    mod, _ = cs._module_fit(cfg, mx.gpu(dev.index), params, host["data"],
                            host["softmax_label"], b, (), "adam")
    del params

    memo = ops_tensor._rates
    times = {True: ([], []), False: ([], [])}
    try:
        for kept in (True, False, False, True) * args.rounds:
            ops_tensor._rates = memo if kept else _Forgetful()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            mod.update()
            e1.record()
            torch.cuda.synchronize()
            times[kept][0].append((time.perf_counter() - t0) * 1e3)
            times[kept][1].append(e0.elapsed_time(e1))
    finally:
        ops_tensor._rates = memo
    for kept, label in ((True, "rate made once a step (memo on)"),
                        (False, "rate made once a parameter (memo off)")):
        wall, span = times[kept]
        print("[%s] Module.update, %s: host wall %.3f ms, card span %.3f ms "
              "(medians of %d; wall %s)"
              % (card, label, float(np.median(wall)), float(np.median(span)),
                 len(wall), ", ".join("%.1f" % x for x in wall)))


if __name__ == "__main__":
    main()
