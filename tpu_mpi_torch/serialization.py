"""Extended object serialization: functions and classes travel by value.

Reference parity: MPI.jl ships arbitrary Julia objects — including closures
— between OS processes via Julia's ``Serialization`` stdlib
(``MPI.jl src/MPI.jl:9-18``; ``test/test_bcast.jl:38-55``
broadcasts a *function* under ``mpiexec``). CPython's ``pickle`` refuses
any function that is not importable by qualified name, so the procs tier
needs its own codec: this module subclasses :class:`pickle.Pickler` with a
by-value path for lambdas, closures, nested functions, ``__main__``-level
definitions, and locally-defined classes.

Design (no third-party cloudpickle):

* the ``__code__`` object travels via :mod:`marshal`;
* closure cells, defaults, ``__dict__`` and *referenced globals* (found by
  scanning ``LOAD_GLOBAL``/``STORE_GLOBAL`` bytecode, recursing into nested
  code constants) travel through the same pickler, so a closure over
  another closure — or a recursive function — round-trips;
* reconstruction is two-phase (skeleton, then state via a pickle
  ``state_setter``) so self-referential functions hit the memo;
* modules serialize by import name; everything plain pickle already
  handles is left to plain pickle, so the wire format stays standard
  pickle bytecode and :func:`loads` is just ``pickle.loads``.

Trust model: identical to pickle — ``loads`` executes arbitrary code.
Only feed it frames produced by peer ranks of the same job (the launcher's
transport already assumes this for pickle itself).
"""
from __future__ import annotations

import builtins
import dis
import importlib
import importlib.util
import io
import marshal
import pickle
import sys
import types
from typing import Any, Callable, Optional

from .error import ERR_TYPE, MPIError

__all__ = ["dumps", "loads", "Pickler", "dumps_oob"]


_GLOBAL_OPS = frozenset(("LOAD_GLOBAL", "STORE_GLOBAL", "DELETE_GLOBAL"))


# -- marshal'd bytecode, tagged with the interpreter's magic -----------------
# marshal's format is only stable within ONE CPython bytecode version; a
# mixed-interpreter job would otherwise die in marshal.loads with a cryptic
# "bad marshal data". The pyc magic number identifies the bytecode version
# exactly, so prepending it turns that crash into a diagnosable error.

_MAGIC = importlib.util.MAGIC_NUMBER


def _dump_code(code: types.CodeType) -> bytes:
    return _MAGIC + marshal.dumps(code)


def _load_code(blob: bytes) -> types.CodeType:
    n = len(_MAGIC)
    if bytes(blob[:n]) != _MAGIC:
        raise MPIError(
            "by-value function was marshalled by a different interpreter "
            f"(bytecode magic {bytes(blob[:n])!r}, this interpreter "
            f"{_MAGIC!r}, Python {sys.version.split()[0]}): marshal'd "
            "bytecode only round-trips between identical CPython versions — "
            "run every rank of the job with the same interpreter",
            code=ERR_TYPE)
    return marshal.loads(blob[n:])


def _global_names(code: types.CodeType) -> set:
    """Names a code object (or any nested code constant) reads/writes as
    globals. Precise per-opcode scan — ``co_names`` alone would also pull
    attribute names."""
    names: set = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for ins in dis.get_instructions(co):
            if ins.opname in _GLOBAL_OPS:
                names.add(ins.argval)
        for const in co.co_consts:
            if isinstance(const, types.CodeType):
                stack.append(const)
    return names


def _lookup_qualname(obj: Any) -> Any:
    """Resolve obj's (module, qualname) back to an object, or None."""
    mod = sys.modules.get(getattr(obj, "__module__", None) or "")
    if mod is None:
        return None
    found: Any = mod
    for part in obj.__qualname__.split("."):
        if part == "<locals>":
            return None
        found = getattr(found, part, None)
        if found is None:
            return None
    return found


def _by_value(obj: Any) -> bool:
    """Ship by value when by-reference pickling cannot work: local /
    lambda / deleted definitions, and anything from ``__main__`` (peer
    processes run a different ``__main__`` under the launcher)."""
    if getattr(obj, "__module__", None) == "__main__":
        return True
    return _lookup_qualname(obj) is not obj


# -- closure cells (first-class, two-phase) ----------------------------------
# Cells pickle as objects so the memo preserves IDENTITY: two functions
# sharing one cell (a `nonlocal` writer + a reader) re-knit to one shared
# cell on the peer. Two-phase (empty cell, then contents) lets a cell
# contain its own function (recursive defs) — the memo breaks the cycle.

def _make_cell() -> types.CellType:
    return types.CellType()


def _set_cell_state(cell: types.CellType, st) -> None:
    if st["has"]:
        cell.cell_contents = st["contents"]


def _reduce_cell(cell: types.CellType):
    try:
        st = {"has": True, "contents": cell.cell_contents}
    except ValueError:              # declared but never filled
        st = {"has": False, "contents": None}
    return (_make_cell, (), st, None, None, _set_cell_state)


# -- function reconstruction -------------------------------------------------

def _make_function(code_bytes: bytes, name: str,
                   cells: Optional[tuple], fglobals: Optional[dict] = None):
    code = _load_code(code_bytes)
    # ``fglobals`` is the per-source-module namespace dict the Pickler
    # threaded through every function from that module — pickle's memo makes
    # all of them reconstruct to the SAME dict, so a global one function
    # writes is visible to its siblings, like functions sharing a module.
    if fglobals is None:
        fglobals = {}
    fglobals.setdefault("__builtins__", builtins)
    return types.FunctionType(code, fglobals, name, None, cells or None)


def _set_function_state(fn, st) -> None:
    fn.__globals__.update(st["globals"])
    fn.__defaults__ = st["defaults"]
    fn.__kwdefaults__ = st["kwdefaults"]
    if st["dict"]:
        fn.__dict__.update(st["dict"])
    fn.__qualname__ = st["qualname"]
    fn.__module__ = st["module"]
    fn.__doc__ = st["doc"]
    if st["annotations"]:
        fn.__annotations__ = st["annotations"]


def _reduce_function(fn: types.FunctionType, shared_globals: dict):
    code = fn.__code__
    fglobals = fn.__globals__
    globs = {name: fglobals[name]
             for name in _global_names(code) if name in fglobals}
    st = {
        "globals": globs,
        "defaults": fn.__defaults__,
        "kwdefaults": fn.__kwdefaults__,
        "dict": dict(fn.__dict__),
        "qualname": fn.__qualname__,
        "module": fn.__module__,
        "doc": fn.__doc__,
        "annotations": dict(getattr(fn, "__annotations__", None) or {}),
    }
    return (_make_function,
            (_dump_code(code), fn.__name__, fn.__closure__, shared_globals),
            st, None, None, _set_function_state)


# -- class reconstruction ----------------------------------------------------
# Skeleton + state (two-phase, so methods may reference the class), but the
# skeleton is built through ``mcls.__prepare__`` with the creation-critical
# namespace entries in place: ``__slots__`` (so slot descriptors exist) and
# enum members (EnumMeta's invariants only hold for members present at class
# creation — the functional-API path). Everything else lands via setattr,
# with ``__set_name__`` re-fired for descriptors that define it.

_CLASS_DICT_SKIP = frozenset((
    "__dict__", "__weakref__", "__module__", "__qualname__", "__doc__",
))

# enum internals recreated by class creation itself — never state-set
_ENUM_INTERNAL = frozenset((
    "_member_names_", "_member_map_", "_value2member_map_", "_member_type_",
    "_value_repr_", "_new_member_", "_use_args_", "_unhashable_values_",
    "_hashable_values_", "_singletons_", "_sort_order_", "__new__",
    "_generate_next_value_",
))

_SLOT_DESCRIPTOR_TYPES = (types.MemberDescriptorType,
                          types.GetSetDescriptorType)


def _make_class(mcls: type, name: str, bases: tuple,
                slots, enum_members):
    ns = mcls.__prepare__(name, bases)
    if slots is not None:
        ns["__slots__"] = slots
    if enum_members is not None:
        for k, v in enum_members.items():
            ns[k] = v
    return mcls(name, bases, ns)


def _set_class_state(cls: type, st) -> None:
    for k, v in st["dict"].items():
        try:
            setattr(cls, k, v)
        except (AttributeError, TypeError):
            continue                # read-only descriptor slots
        set_name = getattr(type(v), "__set_name__", None)
        if set_name is not None:
            set_name(v, cls, k)
    cls.__qualname__ = st["qualname"]
    cls.__module__ = st["module"]
    if st["doc"] is not None:
        try:
            cls.__doc__ = st["doc"]
        except (AttributeError, TypeError):
            pass


def _reduce_class(cls: type):
    import enum as _enum
    mcls = type(cls)
    skip = set(_CLASS_DICT_SKIP)
    enum_members = None
    if isinstance(cls, _enum.EnumMeta):
        enum_members = {n: cls._member_map_[n]._value_
                        for n in cls._member_names_}
        skip |= _ENUM_INTERNAL | set(enum_members)
    slots = vars(cls).get("__slots__")
    if slots is not None:
        skip.add("__slots__")
        skip |= {slots} if isinstance(slots, str) else set(slots)
    d = {k: v for k, v in vars(cls).items()
         if k not in skip and not isinstance(v, _SLOT_DESCRIPTOR_TYPES)}
    st = {
        "dict": d,
        "qualname": cls.__qualname__,
        "module": cls.__module__,
        "doc": cls.__doc__,
    }
    return (_make_class,
            (mcls, cls.__name__, cls.__bases__, slots, enum_members),
            st, None, None, _set_class_state)


# -- descriptor / helper reducers (needed once classes go by value) ----------

def _make_mappingproxy(d: dict):
    return types.MappingProxyType(d)

def _reduce_property(p: property):
    return (property, (p.fget, p.fset, p.fdel, p.__doc__))


def _reduce_staticmethod(sm):
    return (staticmethod, (sm.__func__,))


def _reduce_classmethod(cm):
    return (classmethod, (cm.__func__,))


class Pickler(pickle.Pickler):
    """Pickler with a by-value fallback for functions, classes and modules.

    Standard pickle behavior is preserved for everything importable —
    the hook returns ``NotImplemented`` and the default machinery runs —
    so frames decode with plain :func:`pickle.loads` on the peer.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # module name -> the placeholder dict every by-value function from
        # that module reconstructs its __globals__ into. Pickling the SAME
        # dict object for each of them lets the memo share it, so two
        # siblings from one module see each other's globals on the peer
        # (one dict per source module per payload, fresh per payload).
        self._shared_globals: dict = {}

    def _globals_anchor(self, fn: types.FunctionType) -> dict:
        # Keyed by source MODULE NAME, not globals-dict identity: two
        # by-value functions from one module re-knit to one shared
        # namespace on the peer even when their ``__globals__`` dicts
        # differ by identity (module reload; exec-built namespaces that
        # set ``__name__``). Functions without a module fall back to
        # identity keying so unrelated anonymous namespaces stay separate.
        # The registry lives on the Pickler — one per payload — so
        # separate payloads still reconstruct disjoint namespaces.
        key = (getattr(fn, "__module__", None)
               or f"<anonymous:{id(fn.__globals__)}>")
        anchor = self._shared_globals.get(key)
        if anchor is None:
            anchor = self._shared_globals[key] = {}
        return anchor

    def reducer_override(self, obj: Any):
        if isinstance(obj, types.FunctionType):
            if _by_value(obj):
                return _reduce_function(obj, self._globals_anchor(obj))
            return NotImplemented
        if isinstance(obj, type):
            if _by_value(obj) and obj.__module__ != "builtins":
                return _reduce_class(obj)
            return NotImplemented
        if isinstance(obj, types.CodeType):
            return (_load_code, (_dump_code(obj),))
        if isinstance(obj, types.ModuleType):
            return (importlib.import_module, (obj.__name__,))
        if isinstance(obj, property):
            return _reduce_property(obj)
        if isinstance(obj, staticmethod):
            return _reduce_staticmethod(obj)
        if isinstance(obj, classmethod):
            return _reduce_classmethod(obj)
        if isinstance(obj, types.MappingProxyType):
            return (_make_mappingproxy, (dict(obj),))
        if isinstance(obj, types.CellType):
            return _reduce_cell(obj)
        return NotImplemented


def dumps(obj: Any, protocol: int = pickle.DEFAULT_PROTOCOL) -> bytes:
    """Like :func:`pickle.dumps`, but closures/lambdas/local classes work."""
    buf = io.BytesIO()
    Pickler(buf, protocol=protocol).dump(obj)
    return buf.getvalue()


def dumps_oob(obj: Any, buffer_callback: Callable) -> bytes:
    """Protocol-5 out-of-band dump (the procs wire codec's skeleton lane,
    :func:`tpu_mpi_torch.backend.dumps_oob_parts`) with the extended reducers."""
    buf = io.BytesIO()
    Pickler(buf, protocol=5, buffer_callback=buffer_callback).dump(obj)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    """Alias of :func:`pickle.loads` — the wire format is standard pickle;
    by-value objects reconstruct through this module's importable helpers."""
    return pickle.loads(data)
