"""Errors shared across the port (the JAX package's ``base.py``).

Only what the serving slice needs: the framework's one error type, which
every typed serving and cache error derives from.
"""

from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: ``base.py:MXNetError``)."""
