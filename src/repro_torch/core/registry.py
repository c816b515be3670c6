"""The shared name->value registry behind the pluggable axes.

``similarity=``, ``transform=``, ``regularizer=`` and ``optimizer=`` share one
API shape: a small closed set of built-in options addressed by name, values
that canonicalise back to their name, and a ``ValueError`` listing the valid
names when a caller typos one.

* ``register(name, value)`` / ``@register(name)`` adds an entry;
* ``get(name)`` looks one up, raising ``ValueError`` on a miss;
* ``resolve(obj)`` maps a registered name to ``(name, value)``, a registered
  value back to its name, and lets unregistered objects through when the
  ``passthrough`` predicate accepts them (similarity takes loss callables).
"""

from __future__ import annotations

__all__ = ["Registry"]


class Registry:
    """A named table of pluggable options with uniform lookup semantics."""

    def __init__(self, kind, *, passthrough=None, hint=None):
        """``kind`` names the axis in error messages (e.g. ``"similarity"``).

        ``passthrough``: optional predicate; unregistered objects it accepts
        resolve to themselves.  ``hint``: optional suffix of the unknown-name
        error (e.g. ``"or pass a callable"``).
        """
        self.kind = str(kind)
        self._entries: dict = {}
        self._passthrough = passthrough
        self._hint = hint

    def register(self, name, value=None):
        """Register ``value`` under ``name`` (also usable as a decorator)."""
        if value is None:
            return lambda v: self.register(name, v)
        self._entries[str(name)] = value
        return value

    def names(self) -> list:
        """Sorted names of the registered entries."""
        return sorted(self._entries)

    def __contains__(self, name) -> bool:
        return str(name) in self._entries

    def items(self):
        return self._entries.items()

    def _unknown(self, obj):
        hint = f" {self._hint}" if self._hint else ""
        return ValueError(
            f"unknown {self.kind} {obj!r}; choose from {self.names()}{hint}"
        )

    def get(self, name):
        """The value registered under ``name`` (``ValueError`` on a miss)."""
        try:
            return self._entries[str(name)]
        except KeyError:
            raise self._unknown(name) from None

    def resolve(self, obj):
        """Resolve a name-or-value to a stable ``(key, value)`` pair."""
        if isinstance(obj, str):
            return str(obj), self.get(obj)
        for name, value in self._entries.items():
            # identity for callables; equality so frozen specs canonicalise
            if value is obj or (type(value) is type(obj) and value == obj):
                return name, value
        if self._passthrough is not None and self._passthrough(obj):
            return obj, obj
        raise self._unknown(obj)
