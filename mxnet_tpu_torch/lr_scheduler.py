"""Learning-rate schedules (the JAX package's ``lr_scheduler.py``).

Schedules are closed-form functions of the update count, as in the JAX
package: ``scheduler(num_update) -> lr`` on the host, and
``scheduler.traced(t)`` the same values for ``t`` a tensor on the device,
for a step that reads its counter there.
"""

from __future__ import annotations

import bisect
import logging

import torch

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler"]


class LRScheduler(object):
    """Maps the update count to a learning rate."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._last_logged = None

    def __call__(self, num_update):
        raise NotImplementedError("must override this")

    def traced(self, num_update):
        """The schedule of a ``num_update`` tensor, in torch ops.
        Subclasses keep it next to ``__call__``, so the two forms compute
        the same values."""
        raise NotImplementedError(
            "%s has no traced form; override traced() with torch ops"
            % type(self).__name__)

    def _log_if_changed(self, num_update, lr):
        if lr != self._last_logged:
            if self._last_logged is not None:
                logging.info("Update[%d]: learning rate is now %0.5e",
                             num_update, lr)
            self._last_logged = lr


class FactorScheduler(LRScheduler):
    """``lr = base_lr * factor^k`` where k grows by one every ``step``
    updates, floored at ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the rate decays")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        n_decays = max(0, (int(num_update) - 1) // self.step)
        lr = max(self.base_lr * (self.factor ** n_decays),
                 self.stop_factor_lr)
        self._log_if_changed(num_update, lr)
        return lr

    def traced(self, num_update):
        n = torch.clamp((num_update - 1) // self.step, min=0)
        return torch.clamp(self.base_lr * self.factor ** n,
                           min=self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """``lr *= factor`` each time ``num_update`` passes one of ``step``
    (a strictly increasing list of update counts)."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty increasing list")
        if any(s < 1 for s in step) or any(
                b <= a for a, b in zip(step, step[1:])):
            raise ValueError("step must be a strictly increasing list of "
                             "counts >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the rate decays")
        self.step = list(step)
        self.factor = factor

    def __call__(self, num_update):
        # count boundaries strictly below num_update (the reference's
        # counter walk advances on num_update > step[i])
        n_decays = bisect.bisect_left(self.step, int(num_update))
        lr = self.base_lr * (self.factor ** n_decays)
        self._log_if_changed(num_update, lr)
        return lr

    def traced(self, num_update):
        # == bisect_left(step, num_update): count of boundaries < t
        n = (torch.tensor(self.step, device=num_update.device)
             < num_update).sum()
        return self.base_lr * self.factor ** n


class PolyScheduler(LRScheduler):
    """Polynomial decay from ``base_lr`` to ``final_lr`` over
    ``max_update`` steps."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update >= self.max_update:
            return self.final_lr
        frac = 1.0 - num_update / self.max_update
        return self.final_lr + (self.base_lr - self.final_lr) * \
            frac ** self.power

    def traced(self, num_update):
        frac = torch.clamp(1.0 - num_update / self.max_update, 0.0, 1.0)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            frac ** self.power
