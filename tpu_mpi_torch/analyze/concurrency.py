"""Static concurrency lint: the lock-acquisition graph of a thread fabric.

``python -m tpu_mpi_torch.analyze locks file.py dir/ …`` builds the
lock-acquisition graph of the analyzed tree — which locks are taken while
which are held, from ``with self._lock:`` blocks, ``lock.acquire()`` /
``lock.release()`` statements, and intra-class / intra-module call
propagation — and flags the defect classes that are cheap to prove from
source alone:

- **L112** lock-order cycle: two acquisition paths establish inverted
  order (potential deadlock); both paths are reported as file:line
  chains.
- **L113** blocking call — socket ``accept``/``recv``, ``queue.get``,
  ``Condition.wait`` on a *different* lock's condition, ``Event.wait``,
  or a collective entry (``MPI.X`` / ``collective.X``) — while holding a
  dispatch/pool lock (a lock whose field name contains ``dispatch`` or
  ends in ``_pool_lock``, or one annotated ``# lock: dispatch``).
- **L114** a shared mutable field assigned on two or more threads
  (threads mapped from ``Thread(target=self.method)`` roots and their
  intra-class call closures) with no common lock guarding every write.
- **L115** a lock acquired via ``.acquire()`` whose matching
  ``.release()`` is not protected by a ``try/finally`` — an exception
  between the two leaks the lock (release on a different path than the
  acquire).

A small ``# lock:`` annotation grammar covers what the AST cannot see
(docs/analysis.md):

- ``# lock: acquires NAME`` / ``# lock: releases NAME`` — the statement
  on this line takes/drops lock ``NAME`` dynamically.
- ``# lock: blocking`` — the call on this line may block.
- ``# lock: guard NAME`` — the field write on this line is guarded by
  ``NAME`` at runtime (suppresses L114 for that write).
- ``# lock: dispatch`` — the lock constructed on this line is a
  dispatch/pool lock for L113 purposes.
- ``# lock: ignore`` — suppress concurrency diagnostics on this line.

Like the communication lint, this pass is deliberately conservative: it
only trusts receivers it can resolve (``self.X`` fields constructed as
``threading.Lock/RLock/Condition``, ``queue.Queue``, ``threading.Event``,
or the :mod:`tpu_mpi_torch.locksmith` factories; locals assigned the same) and
stays silent otherwise. Zero diagnostics on the whole ``tpu_mpi_torch`` tree is
part of the CI contract.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Any, Dict, List, Optional, Set, Tuple

from .diagnostics import Diagnostic

Site = Tuple[str, int]                       # (file, line)

_LOCK_CTORS = {"Lock": "lock", "RLock": "lock", "make_lock": "lock",
               "make_rlock": "lock"}
_COND_CTORS = {"Condition", "make_condition"}
_QUEUE_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}
_EVENT_CTORS = {"Event"}

# receivers we cannot type still block on these names (sockets / wire)
_BLOCKING_ATTRS = {"accept", "recv_into"}
_BLOCKING_FUNCS = {"recv_frame"}
# blocking collective entries, matched only as attributes of these bases
_COLL_BASES = {"MPI", "mpi", "tpu_mpi_torch", "collective", "coll"}
_COLL_NAMES = {"Barrier", "Bcast", "Reduce", "Allreduce", "Allgather",
               "Allgatherv", "Alltoall", "Alltoallv", "Gather", "Gatherv",
               "Scatter", "Scatterv", "Scan", "Exscan", "Reduce_scatter",
               "Send", "Ssend", "Recv", "Sendrecv", "Wait", "Waitall",
               "Comm_agree", "Comm_shrink", "Comm_spawn", "Intercomm_merge"}

_ANN_RE = re.compile(
    r"#\s*lock:\s*(acquires|releases|blocking|guard|dispatch|ignore)"
    r"(?:\s+([A-Za-z_][\w.]*))?")


def _fmt(site: Site) -> str:
    return f"{site[0]}:{site[1]}"


def _ctor_of(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


class _Scope:
    """Lock/queue/event fields of one class (or of the module itself)."""

    def __init__(self, name: str):
        self.name = name                     # "Cls" or module basename
        self.locks: Dict[str, str] = {}      # attr -> lock id
        self.cond_lock: Dict[str, str] = {}  # cond attr -> underlying lock id
        self.queues: Set[str] = set()
        self.events: Set[str] = set()
        self.dispatch: Set[str] = set()      # lock ids that gate L113
        self.methods: Dict[str, ast.AST] = {}
        self.thread_roots: Set[str] = set()  # Thread(target=self.X) methods

    def lock_id(self, attr: str) -> Optional[str]:
        if attr in self.locks:
            return self.locks[attr]
        return self.cond_lock.get(attr)


class _Summary:
    """What one function/method does, lock-wise."""

    def __init__(self, qual: str):
        self.qual = qual
        self.acquired: Dict[str, Site] = {}        # lock id -> first site
        self.blocking: List[Tuple[Site, str]] = []  # (site, description)
        self.calls: List[Tuple[tuple, str, Site]] = []  # (held, callee, site)
        self.writes: List[Tuple[str, Site, tuple]] = []  # (field, site, held)


class _Analysis:
    """Per-file facts: scopes, summaries, edges, and file-local diags."""

    def __init__(self, path: str, tree: ast.Module, src: str):
        self.path = path
        self.tree = tree
        self.mod = os.path.splitext(os.path.basename(path))[0]
        self.ann: Dict[int, List[Tuple[str, Optional[str]]]] = {}
        for lineno, text in enumerate(src.splitlines(), 1):
            for m in _ANN_RE.finditer(text):
                self.ann.setdefault(lineno, []).append((m.group(1),
                                                        m.group(2)))
        self.scopes: Dict[str, _Scope] = {}
        self.summaries: Dict[str, _Summary] = {}
        # edges[(outer, inner)] = (outer site, inner site), first observation
        self.edges: Dict[Tuple[str, str], Tuple[Site, Site]] = {}
        self.diags: List[Diagnostic] = []
        self.ignored: Set[int] = {ln for ln, anns in self.ann.items()
                                  if any(k == "ignore" for k, _ in anns)}

    # -- helpers -------------------------------------------------------------
    def diag(self, code: str, message: str, line: int, context: str = "",
             related: tuple = ()) -> None:
        if line in self.ignored:
            return
        self.diags.append(Diagnostic(code, message, file=self.path,
                                     line=line, context=context,
                                     related=related))

    def edge(self, outer: str, outer_site: Site, inner: str,
             inner_site: Site) -> None:
        if outer == inner:
            return
        self.edges.setdefault((outer, inner), (outer_site, inner_site))

    # -- pass 1: scopes ------------------------------------------------------
    def collect(self) -> None:
        mod_scope = _Scope(self.mod)
        self.scopes[""] = mod_scope
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self.scopes[node.name] = self._collect_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mod_scope.methods[node.name] = node
            elif isinstance(node, ast.Assign):
                self._field_ctor(mod_scope, None, node)
        # module-level thread roots: Thread(target=fn) over module functions
        for call in ast.walk(self.tree):
            if isinstance(call, ast.Call) and _ctor_of(call) == "Thread":
                for kw in call.keywords:
                    if kw.arg == "target" and isinstance(kw.value, ast.Name) \
                            and kw.value.id in mod_scope.methods:
                        mod_scope.thread_roots.add(kw.value.id)

    def _collect_class(self, cls: ast.ClassDef) -> _Scope:
        scope = _Scope(cls.name)
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope.methods[node.name] = node
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                self._field_ctor(scope, "self", node)
            elif isinstance(node, ast.Call) and _ctor_of(node) == "Thread":
                for kw in node.keywords:
                    if (kw.arg == "target"
                            and isinstance(kw.value, ast.Attribute)
                            and isinstance(kw.value.value, ast.Name)
                            and kw.value.value.id == "self"
                            and kw.value.attr in scope.methods):
                        scope.thread_roots.add(kw.value.attr)
        return scope

    def _field_ctor(self, scope: _Scope, base: Optional[str],
                    node: ast.Assign) -> None:
        """Record ``self.X = threading.Lock()``-style constructions (or the
        module-level ``X = …`` form when ``base`` is None)."""
        if not isinstance(node.value, ast.Call):
            return
        name = None
        for tgt in node.targets:
            if base is None and isinstance(tgt, ast.Name):
                name = tgt.id
            elif (base is not None and isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == base):
                name = tgt.attr
        if name is None:
            return
        ctor = _ctor_of(node.value)
        lid = f"{scope.name}.{name}"
        anns = [k for k, _ in self.ann.get(node.lineno, ())]
        if ctor in _LOCK_CTORS:
            scope.locks[name] = lid
            if ("dispatch" in name or name.endswith("_pool_lock")
                    or "dispatch" in anns):
                scope.dispatch.add(lid)
        elif ctor in _COND_CTORS:
            args = node.value.args
            tied_ix = 1 if ctor == "make_condition" else 0
            tied = None
            if len(args) > tied_ix:
                a = args[tied_ix]
                if (isinstance(a, ast.Attribute)
                        and isinstance(a.value, ast.Name)
                        and a.value.id == "self"):
                    tied = scope.locks.get(a.attr)
            scope.cond_lock[name] = tied if tied is not None else lid
        elif ctor in _QUEUE_CTORS:
            scope.queues.add(name)
        elif ctor in _EVENT_CTORS:
            scope.events.add(name)

    # -- pass 2: summaries ---------------------------------------------------
    def summarize(self) -> None:
        for sname, scope in self.scopes.items():
            for mname, fn in scope.methods.items():
                qual = f"{scope.name}.{mname}" if sname else mname
                summ = _Summary(qual)
                self.summaries[qual] = summ
                _FuncWalker(self, scope, summ).run(fn)
        # module-level statements run on the importing thread
        mod = self.scopes[""]
        summ = _Summary("<module>")
        self.summaries["<module>"] = summ
        walker = _FuncWalker(self, mod, summ)
        walker.walk_body([st for st in self.tree.body
                          if not isinstance(st, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef,
                                                 ast.ClassDef))])
        walker.finish()

    # -- pass 3: call propagation + per-file rules ---------------------------
    def propagate(self) -> None:
        # transitive may-acquire / may-block sets per function (fixpoint)
        acq: Dict[str, Dict[str, Site]] = {
            q: dict(s.acquired) for q, s in self.summaries.items()}
        blk: Dict[str, List[Tuple[Site, str]]] = {
            q: list(s.blocking) for q, s in self.summaries.items()}
        changed = True
        while changed:
            changed = False
            for q, s in self.summaries.items():
                for _held, callee, _site in s.calls:
                    if callee not in self.summaries:
                        continue
                    for lid, site in acq[callee].items():
                        if lid not in acq[q]:
                            acq[q][lid] = site
                            changed = True
                    for b in blk[callee]:
                        if b not in blk[q]:
                            blk[q].append(b)
                            changed = True
        # cross-method edges and held-while-blocking through calls
        for q, s in self.summaries.items():
            for held, callee, site in s.calls:
                if callee not in self.summaries or not held:
                    continue
                for lid, asite in acq[callee].items():
                    for hid, hsite in held:
                        self.edge(hid, hsite, lid, asite)
                for bsite, desc in blk[callee]:
                    self._blocking_held(held, bsite, desc,
                                        via=(self.path, site[1]))

    def _blocking_held(self, held: tuple, site: Site, desc: str,
                       via: Optional[Site] = None,
                       exempt: Optional[str] = None) -> None:
        """L113 when any held lock is a dispatch/pool lock."""
        dispatch = set()
        for scope in self.scopes.values():
            dispatch |= scope.dispatch
        for hid, hsite in held:
            if hid not in dispatch or hid == exempt:
                continue
            rel = [(hsite[0], hsite[1], f"{hid!r} acquired here")]
            if via is not None:
                rel.append((via[0], via[1], "reached via this call"))
            self.diag("L113",
                      f"{desc} while holding dispatch lock {hid!r}",
                      site[1], related=tuple(rel))
            return

    def check_l114(self) -> None:
        for scope in self.scopes.values():
            # one in-class thread + the external caller thread would also
            # make two writers, but resolving the external side is
            # guesswork — require two explicit roots (conservative)
            if len(scope.thread_roots) < 2:
                continue
            prefix = f"{scope.name}."
            # intra-scope call graph closure per thread root
            callees: Dict[str, Set[str]] = {}
            for q, s in self.summaries.items():
                if not q.startswith(prefix):
                    continue
                m = q[len(prefix):]
                callees[m] = {c[len(prefix):] for _h, c, _s in s.calls
                              if c.startswith(prefix)}
            closures: Dict[str, Set[str]] = {}
            for root in scope.thread_roots:
                seen = {root}
                frontier = [root]
                while frontier:
                    m = frontier.pop()
                    for c in callees.get(m, ()):
                        if c not in seen:
                            seen.add(c)
                            frontier.append(c)
                closures[root] = seen
            # field -> write records grouped by root
            writes: Dict[str, Dict[str, List[Tuple[Site, tuple]]]] = {}
            for q, s in self.summaries.items():
                if not q.startswith(prefix):
                    continue
                m = q[len(prefix):]
                if m in ("__init__", "__new__"):
                    continue
                for field, site, held in s.writes:
                    for root, members in closures.items():
                        if m in members:
                            writes.setdefault(field, {}).setdefault(
                                root, []).append((site, held))
            for field, by_root in sorted(writes.items()):
                if len(by_root) < 2:
                    continue
                if field in scope.locks or field in scope.cond_lock \
                        or field in scope.queues or field in scope.events:
                    continue
                all_recs = [r for recs in by_root.values() for r in recs]
                guard_sets = [{hid for hid, _hs in rec[1]}
                              for rec in all_recs]
                if guard_sets and set.intersection(*guard_sets):
                    continue
                sites = sorted({rec[0] for rec in all_recs},
                               key=lambda s: (s[0], s[1]))
                first = sites[0]
                related = tuple(
                    (s[0], s[1], "another unguarded write") for s in sites[1:])
                roots = ", ".join(sorted(by_root))
                qual = f"{scope.name}.{field}"
                self.diag("L114",
                          f"field {qual!r} is written on threads rooted at "
                          f"{roots} with no common lock",
                          first[1], related=related)

    def run(self) -> List[Diagnostic]:
        self.collect()
        self.summarize()
        self.propagate()
        self.check_l114()
        return self.diags


class _FuncWalker:
    """Walks one function body tracking the held-lock stack."""

    def __init__(self, an: _Analysis, scope: _Scope, summ: _Summary):
        self.an = an
        self.scope = scope
        self.summ = summ
        self.held: List[Tuple[str, Site]] = []
        self.locals: Dict[str, str] = {}       # local var -> lock id
        self.local_queues: Set[str] = set()
        self.local_events: Set[str] = set()
        self.finally_releases: List[Set[str]] = []
        self.in_finally = 0
        self.nested: List[ast.AST] = []

    def run(self, fn: ast.AST) -> None:
        self.walk_body(fn.body)
        self.finish()

    def finish(self) -> None:
        while self.nested:
            sub = self.nested.pop()
            inner = _FuncWalker(self.an, self.scope, self.summ)
            inner.locals = dict(self.locals)
            inner.local_queues = set(self.local_queues)
            inner.local_events = set(self.local_events)
            inner.walk_body(sub.body)
            inner.finish()

    # -- resolution ----------------------------------------------------------
    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            return self.scope.lock_id(expr.attr)
        if isinstance(expr, ast.Name):
            if expr.id in self.locals:
                return self.locals[expr.id]
            mod = self.an.scopes.get("")
            if mod is not None:
                return mod.lock_id(expr.id)
        return None

    def _cond_underlying(self, expr: ast.AST) -> Optional[str]:
        """The lock under a condition receiver, or None if not a cond."""
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and expr.attr in self.scope.cond_lock):
            return self.scope.cond_lock[expr.attr]
        return None

    def _is_queue(self, expr: ast.AST) -> bool:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            return expr.attr in self.scope.queues
        return isinstance(expr, ast.Name) and expr.id in self.local_queues

    def _is_event(self, expr: ast.AST) -> bool:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            return expr.attr in self.scope.events
        return isinstance(expr, ast.Name) and expr.id in self.local_events

    # -- held stack ----------------------------------------------------------
    def _push(self, lid: str, line: int) -> None:
        site = (self.an.path, line)
        for hid, hsite in self.held:
            self.an.edge(hid, hsite, lid, site)
        if lid not in self.summ.acquired:
            self.summ.acquired[lid] = site
        self.held.append((lid, site))

    def _pop(self, lid: str) -> None:
        for i in range(len(self.held) - 1, -1, -1):
            if self.held[i][0] == lid:
                del self.held[i]
                return

    # -- statement walk ------------------------------------------------------
    def walk_body(self, body: List[ast.stmt]) -> None:
        pushed_here: List[str] = []
        for i, st in enumerate(body):
            for kind, arg in self.an.ann.get(st.lineno, ()):
                if kind == "acquires" and arg:
                    lid = self.scope.lock_id(arg) or arg
                    self._push(lid, st.lineno)
                    pushed_here.append(lid)
                elif kind == "releases" and arg:
                    lid = self.scope.lock_id(arg) or arg
                    self._pop(lid)
                    if lid in pushed_here:
                        pushed_here.remove(lid)
            self._stmt(st, body, i, pushed_here)
        for lid in pushed_here:
            self._pop(lid)

    def _stmt(self, st: ast.stmt, body: List[ast.stmt], i: int,
              pushed_here: List[str]) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.nested.append(st)
            return
        if isinstance(st, ast.ClassDef):
            return
        if isinstance(st, ast.With):
            pushed = []
            for item in st.items:
                self._scan_calls(item.context_expr, st.lineno)
                lid = self._lock_of(item.context_expr)
                if lid is not None:
                    self._push(lid, item.context_expr.lineno)
                    pushed.append(lid)
            self.walk_body(st.body)
            for lid in reversed(pushed):
                self._pop(lid)
            return
        if isinstance(st, ast.Try):
            released = self._releases_in(st.finalbody)
            self.finally_releases.append(released)
            self.walk_body(st.body)
            for h in st.handlers:
                self.walk_body(h.body)
            self.walk_body(st.orelse)
            self.finally_releases.pop()
            self.in_finally += 1
            self.walk_body(st.finalbody)
            self.in_finally -= 1
            return
        if isinstance(st, ast.If):
            self._scan_calls(st.test, st.lineno)
            self.walk_body(st.body)
            self.walk_body(st.orelse)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._scan_calls(st.iter, st.lineno)
            self.walk_body(st.body)
            self.walk_body(st.orelse)
            return
        if isinstance(st, ast.While):
            self._scan_calls(st.test, st.lineno)
            self.walk_body(st.body)
            self.walk_body(st.orelse)
            return
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            call = st.value
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr in ("acquire",
                                                           "release"):
                lid = self._lock_of(f.value) or self._cond_underlying(f.value)
                if lid is not None:
                    if f.attr == "acquire":
                        self._l115(lid, st, body, i)
                        self._push(lid, st.lineno)
                        pushed_here.append(lid)
                    else:
                        self._pop(lid)
                        if lid in pushed_here:
                            pushed_here.remove(lid)
                    return
            self._scan_calls(st.value, st.lineno)
            return
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._assign(st)
            return
        if isinstance(st, (ast.Return, ast.Raise)):
            val = getattr(st, "value", None) or getattr(st, "exc", None)
            if val is not None:
                self._scan_calls(val, st.lineno)
            return
        if isinstance(st, ast.Assert):
            self._scan_calls(st.test, st.lineno)
            return

    def _assign(self, st: ast.stmt) -> None:
        value = st.value
        if value is not None:
            # local lock/queue/event constructions
            if isinstance(value, ast.Call):
                ctor = _ctor_of(value)
                targets = st.targets if isinstance(st, ast.Assign) \
                    else [st.target]
                tgt = targets[0] if targets else None
                if isinstance(tgt, ast.Name):
                    if ctor in _LOCK_CTORS:
                        self.locals[tgt.id] = \
                            f"{self.scope.name}.{self.summ.qual}.{tgt.id}"
                    elif ctor in _QUEUE_CTORS:
                        self.local_queues.add(tgt.id)
                    elif ctor in _EVENT_CTORS:
                        self.local_events.add(tgt.id)
            self._scan_calls(value, st.lineno)
        targets = st.targets if isinstance(st, ast.Assign) else [st.target]
        for tgt in targets:
            self._record_write(tgt, st.lineno)

    def _record_write(self, tgt: ast.AST, line: int) -> None:
        if isinstance(tgt, ast.Tuple):
            for elt in tgt.elts:
                self._record_write(elt, line)
            return
        if (isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"):
            held = tuple(self.held)
            for kind, arg in self.an.ann.get(line, ()):
                if kind == "guard" and arg:
                    lid = self.scope.lock_id(arg) or arg
                    held = held + ((lid, (self.an.path, line)),)
            self.summ.writes.append((tgt.attr, (self.an.path, line), held))

    def _releases_in(self, stmts: List[ast.stmt]) -> Set[str]:
        out: Set[str] = set()
        for node in stmts:
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "release"):
                    lid = self._lock_of(sub.func.value) \
                        or self._cond_underlying(sub.func.value)
                    if lid is not None:
                        out.add(lid)
        return out

    def _l115(self, lid: str, st: ast.stmt, body: List[ast.stmt],
              i: int) -> None:
        """Flag acquire() whose release is not on every exception edge."""
        if self.in_finally:
            return                       # re-acquire in a finally
        for released in self.finally_releases:
            if lid in released:
                return
        if i + 1 < len(body) and isinstance(body[i + 1], ast.Try) \
                and lid in self._releases_in(body[i + 1].finalbody):
            return
        release_line = None
        risky = False
        for j in range(i + 1, len(body)):
            nxt = body[j]
            if (isinstance(nxt, ast.Expr) and isinstance(nxt.value, ast.Call)
                    and isinstance(nxt.value.func, ast.Attribute)
                    and nxt.value.func.attr == "release"):
                rid = self._lock_of(nxt.value.func.value) \
                    or self._cond_underlying(nxt.value.func.value)
                if rid == lid:
                    release_line = nxt.lineno
                    break
            for sub in ast.walk(nxt):
                if isinstance(sub, (ast.Call, ast.Raise)):
                    risky = True
                    break
        if release_line is not None and risky:
            self.an.diag(
                "L115",
                f"{lid!r} acquired here but released at line {release_line} "
                f"with no try/finally — an exception in between leaks the "
                f"lock",
                st.lineno,
                related=((self.an.path, release_line, "the release"),))

    # -- call scanning -------------------------------------------------------
    def _scan_calls(self, expr: ast.AST, line: int) -> None:
        ann_blocking = any(k == "blocking"
                           for k, _ in self.an.ann.get(line, ()))
        for node in self._walk_no_lambda(expr):
            if not isinstance(node, ast.Call):
                continue
            self._classify_call(node, ann_blocking)

    @staticmethod
    def _walk_no_lambda(expr: ast.AST):
        stack = [expr]
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, ast.Lambda):
                continue                 # body runs later, elsewhere
            stack.extend(ast.iter_child_nodes(node))

    def _classify_call(self, call: ast.Call, ann_blocking: bool) -> None:
        site = (self.an.path, call.lineno)
        held = tuple(self.held)
        f = call.func
        desc = None
        if ann_blocking:
            desc = "annotated-blocking call"
        elif isinstance(f, ast.Attribute):
            recv, attr = f.value, f.attr
            if attr == "get" and self._is_queue(recv) \
                    and not self._nonblocking_get(call):
                desc = "queue.get()"
            elif attr == "wait":
                under = self._cond_underlying(recv)
                if under is not None:
                    if any(h != under for h, _s in held):
                        self._blocking_held(
                            held, site, f"Condition.wait on {under!r}",
                            exempt=under)
                    return
                if self._is_event(recv):
                    desc = "Event.wait()"
            elif attr in _BLOCKING_ATTRS:
                desc = f".{attr}()"
            elif attr == "recv" and not isinstance(recv, ast.Attribute):
                # sock.recv(...) — bare-name receivers only, so dict-like
                # helper methods named recv on self/fields never match
                desc = ".recv()"
            elif (attr in _COLL_NAMES and isinstance(recv, ast.Name)
                    and recv.id in _COLL_BASES):
                desc = f"collective entry {recv.id}.{attr}"
        elif isinstance(f, ast.Name) and f.id in _BLOCKING_FUNCS:
            desc = f"{f.id}()"
        if desc is not None:
            self._blocking_held(held, site, desc)
            if (self.an.path, call.lineno) not in [s for s, _d
                                                   in self.summ.blocking]:
                self.summ.blocking.append((site, desc))
            return
        # self.method() / module_fn() calls: record for propagation
        callee = None
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self" and f.attr in self.scope.methods):
            callee = f"{self.scope.name}.{f.attr}"
        elif isinstance(f, ast.Name):
            mod = self.an.scopes.get("")
            if mod is not None and f.id in mod.methods:
                callee = f.id
        if callee is not None:
            self.summ.calls.append((held, callee, site))

    def _blocking_held(self, held: tuple, site: Site, desc: str,
                       exempt: Optional[str] = None) -> None:
        self.an._blocking_held(held, site, desc, exempt=exempt)

    @staticmethod
    def _nonblocking_get(call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return True
        if call.args and isinstance(call.args[0], ast.Constant) \
                and call.args[0].value is False:
            return True
        return False


# ---------------------------------------------------------------------------
# Cycle detection over the aggregated (possibly multi-file) edge set
# ---------------------------------------------------------------------------

def _find_path(edges: Dict[Tuple[str, str], Tuple[Site, Site]],
               src: str, dst: str) -> Optional[List[str]]:
    succ: Dict[str, List[str]] = {}
    for a, b in edges:
        succ.setdefault(a, []).append(b)
    seen = {src}
    parent: Dict[str, str] = {}
    frontier = [src]
    while frontier:
        nxt = []
        for a in frontier:
            for b in sorted(succ.get(a, ())):
                if b in seen:
                    continue
                seen.add(b)
                parent[b] = a
                if b == dst:
                    path = [b]
                    while path[-1] != src:
                        path.append(parent[path[-1]])
                    path.reverse()
                    return path
                nxt.append(b)
        frontier = nxt
    return None


def _cycle_diags(edges: Dict[Tuple[str, str], Tuple[Site, Site]],
                 ignored: Dict[str, Set[int]]) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    reported: Set[frozenset] = set()
    for (a, b) in sorted(edges):
        back = _find_path(edges, b, a)
        if back is None:
            continue
        nodes = frozenset([a] + back)
        if nodes in reported:
            continue
        reported.add(nodes)
        cycle = [(a, b)] + list(zip(back, back[1:]))
        # anchor at the lexically last inner acquisition — where the
        # inversion completes
        anchor = max(cycle, key=lambda e: edges[e][1])
        afile, aline = edges[anchor][1]
        if aline in ignored.get(afile, set()):
            continue
        related = []
        for (x, y) in cycle:
            osite, isite = edges[(x, y)]
            related.append((isite[0], isite[1],
                            f"{y!r} acquired while holding {x!r} "
                            f"(held since {_fmt(osite)})"))
        names = " -> ".join([a, b] if len(nodes) == 2
                            else [a] + back)
        out.append(Diagnostic(
            "L112",
            f"lock-order cycle: {names} — two acquisition paths establish "
            f"inverted order (potential deadlock)",
            file=afile, line=aline, related=tuple(related)))
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _analyze_source(src: str, path: str) -> Tuple[Optional[_Analysis],
                                                  List[Diagnostic]]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return None, [Diagnostic("L100", f"could not parse: {e.msg}",
                                 file=path, line=e.lineno or 0)]
    an = _Analysis(path, tree, src)
    return an, an.run()


def lock_lint_source(src: str, path: str = "<string>") -> List[Diagnostic]:
    """Analyze one source string (edges resolve within the file)."""
    an, diags = _analyze_source(src, path)
    if an is not None:
        diags = diags + _cycle_diags(an.edges, {an.path: an.ignored})
    diags.sort(key=lambda d: (d.file, d.line, d.code))
    return diags


def _expand(paths) -> List[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, _dirs, files in os.walk(p):
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(files) if f.endswith(".py"))
        else:
            out.append(p)
    return out


def lock_lint_paths(paths) -> List[Diagnostic]:
    """Analyze files/directories; the lock graph aggregates across all of
    them, so cross-file inverted acquisition orders are still cycles."""
    diags: List[Diagnostic] = []
    edges: Dict[Tuple[str, str], Tuple[Site, Site]] = {}
    ignored: Dict[str, Set[int]] = {}
    for path in _expand(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
        except OSError as e:
            diags.append(Diagnostic("L100", f"could not read: {e}",
                                    file=path))
            continue
        an, file_diags = _analyze_source(src, path)
        diags.extend(file_diags)
        if an is not None:
            for k, v in an.edges.items():
                edges.setdefault(k, v)
            ignored[an.path] = an.ignored
    diags.extend(_cycle_diags(edges, ignored))
    diags.sort(key=lambda d: (d.file, d.line, d.code))
    return diags


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m tpu_mpi_torch.analyze locks file.py dir/ …`` — prints
    diagnostics, exits 1 if any were found."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    diags = lock_lint_paths(argv)
    for d in diags:
        print(d)
    if diags:
        print(f"{len(diags)} diagnostic(s) in {len(_expand(argv))} file(s)")
        return 1
    return 0
