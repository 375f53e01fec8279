"""Global random state (the JAX package's ``random.py``, ``mx.random``).

:func:`seed` seeds one ``torch.Generator`` per device, made on first use;
draws on a device (``SGLD``'s noise) take that device's generator, so a
seed gives the same draws again.  The JAX package splits threefry keys off
a root key instead: the two packages' draws agree in distribution, not in
bits.
"""

from __future__ import annotations

import torch

__all__ = ["generator", "seed"]

_STATE = {"seed": 0, "generators": {}}


def seed(seed_state):
    """Seed every device's generator with ``seed_state``."""
    _STATE["seed"] = int(seed_state)
    for gen in _STATE["generators"].values():
        gen.manual_seed(_STATE["seed"])


def generator(device):
    """The seeded generator of ``device`` (a ``torch.device`` or its name)."""
    device = torch.device(device)
    gens = _STATE["generators"]
    if device not in gens:
        gens[device] = torch.Generator(device=device)
        gens[device].manual_seed(_STATE["seed"])
    return gens[device]
