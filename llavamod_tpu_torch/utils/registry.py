"""Explicit name->factory registries.

The reference dispatches model/trainer classes on checkpoint-path substrings
(train/train.py:49-250, model/builder.py:77-554).  We replace that with
explicit registries; substring inference exists only as a thin compatibility
shim on top (`Registry.match_substring`).

The port's own copy of llavamod_tpu/utils/registry.py.
"""

from __future__ import annotations

from typing import Dict, Generic, Iterator, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}
        self._aliases: Dict[str, str] = {}

    def register(self, name: str, value: Optional[T] = None, *, aliases: Tuple[str, ...] = ()):
        """Register directly or use as a decorator."""

        def _do(v: T) -> T:
            key = name.lower()
            if key in self._entries:
                raise KeyError(f"{self.kind} '{name}' already registered")
            self._entries[key] = v
            for a in aliases:
                self._aliases[a.lower()] = key
            return v

        if value is None:
            return _do
        return _do(value)

    def get(self, name: str) -> T:
        key = name.lower()
        key = self._aliases.get(key, key)
        if key not in self._entries:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def __contains__(self, name: str) -> bool:
        key = name.lower()
        return key in self._entries or key in self._aliases

    def names(self) -> List[str]:
        return sorted(self._entries)

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def match_substring(self, haystack: str) -> Optional[str]:
        """Return the registered name whose key occurs in `haystack`
        (longest match wins), or None."""
        hay = haystack.lower()
        candidates = [k for k in list(self._entries) + list(self._aliases) if k in hay]
        if not candidates:
            return None
        best = max(candidates, key=len)
        return self._aliases.get(best, best)
