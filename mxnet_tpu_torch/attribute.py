"""Attribute scoping (the JAX package's ``attribute.py``): string
attributes set by ``with AttrScope(...)`` land on every symbol made inside
it."""

from __future__ import annotations

__all__ = ["AttrScope"]


class AttrScope:
    """Attribute manager for scoping; attrs apply to symbols created within."""

    current = None

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be a string")
        self._attr = kwargs

    def get(self, attr):
        """Scope attrs merged with the caller's (the caller's win)."""
        ret = dict(self._attr)
        ret.update(attr or {})
        return ret

    def __enter__(self):
        self._old_scope = AttrScope.current
        attr = dict(AttrScope.current._attr)
        attr.update(self._attr)
        self._attr = attr
        AttrScope.current = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope.current = self._old_scope


AttrScope.current = AttrScope()
