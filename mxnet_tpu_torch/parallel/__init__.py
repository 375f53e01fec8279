"""Training of the port: :class:`~.trainer.ShardedTrainer` on one device."""

from . import trainer
from .trainer import ShardedTrainer, trainer_state_from_jax

__all__ = ["ShardedTrainer", "trainer", "trainer_state_from_jax"]
