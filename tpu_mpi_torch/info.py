"""Info: key-value hint objects.

Reference: MPI.jl src/info.jl — ``Info <: AbstractDict{Symbol,String}``
(:28), create/free (:32-48), set with ASCII+length validation (:50-58),
``infoval`` conversion of Bool/Int/lists (:67-71), get via the valuelen
two-step (:82-108), delete/length/iterate (:110-156).

TPU mapping (SURVEY.md §2.2): a plain dict of string hints passed to ops and
plumbed into compile options / donate hints. The C-side valuelen dance
disappears; validation (ASCII keys, bounded lengths) is kept so programs port
without surprises. INFO_NULL is the absent-hints sentinel.
"""

from __future__ import annotations

from collections.abc import MutableMapping
from typing import Any, Iterator, Optional

from . import error as _ec
from .error import MPIError

MAX_INFO_KEY = 255
MAX_INFO_VAL = 1024


def infoval(x: Any) -> str:
    """Normalize a value to its string form (src/info.jl:67-71):
    bools → "true"/"false", numbers → decimal, sequences → comma-joined."""
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, (int, float)):
        return str(x)
    if isinstance(x, str):
        return x
    if isinstance(x, (list, tuple)):
        return ", ".join(infoval(v) for v in x)
    raise MPIError(f"cannot convert {type(x).__name__} to an info value")


class Info(MutableMapping):
    """A dictionary of string hints with MPI-style validation."""

    def __init__(self, *args, **kwargs):
        self._d: dict[str, str] = {}
        self._freed = False
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def _check(self) -> None:
        if self._freed:
            raise MPIError("operation on a freed Info", code=_ec.ERR_INFO)

    def __setitem__(self, key: Any, value: Any) -> None:
        self._check()
        key = str(key)
        if not key.isascii():
            raise MPIError("info keys must be ASCII", code=_ec.ERR_INFO_KEY)
        if len(key) > MAX_INFO_KEY:
            raise MPIError(f"info key longer than {MAX_INFO_KEY}",
                           code=_ec.ERR_INFO_KEY)
        val = infoval(value)
        if len(val) > MAX_INFO_VAL:
            raise MPIError(f"info value longer than {MAX_INFO_VAL}",
                           code=_ec.ERR_INFO_VALUE)
        self._d[key] = val

    def __getitem__(self, key: Any) -> str:
        self._check()
        return self._d[str(key)]

    def __delitem__(self, key: Any) -> None:
        self._check()
        del self._d[str(key)]

    def __iter__(self) -> Iterator[str]:
        self._check()
        return iter(self._d)

    def __len__(self) -> int:
        self._check()
        return len(self._d)

    def free(self) -> None:
        self._d.clear()
        self._freed = True

    def __repr__(self) -> str:
        return f"Info({self._d!r})"


INFO_NULL: Optional[Info] = None
