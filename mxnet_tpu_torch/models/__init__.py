"""Models of the port: the transformer LM's functional serving path."""

from . import transformer

__all__ = ["transformer"]
