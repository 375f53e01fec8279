"""Automatic symbol naming (the JAX package's ``name.py``)."""

from __future__ import annotations

__all__ = ["NameManager"]


class NameManager:
    """Gives anonymous symbols ``{op}{count}`` names."""

    current = None

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return "%s%d" % (hint, count)


NameManager.current = NameManager()
