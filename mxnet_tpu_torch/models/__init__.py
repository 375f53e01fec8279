"""Models of the port: the transformer LM (training symbol and functional
serving path) and ResNet (training symbol)."""

from . import resnet, transformer

__all__ = ["resnet", "transformer"]
