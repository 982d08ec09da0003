"""Static communication lint: a CPython-``ast`` pass over SPMD programs.

``python -m tpu_mpi_torch.lint file.py dir/ …`` flags the defect classes that are
cheap to prove from source alone — before any rank runs:

- **L101** rank-divergent collective sequences: a collective inside
  ``if rank == …`` with no matching call on the other branch(es);
- **L102** root argument mismatch across rank branches;
- **L103** reduction op / buffer dtype mismatch across rank branches;
- **L104** receive posted into a buffer smaller than the matching send;
- **L105** a send whose (literal) tag no receive in the unit matches;
- **L106** an Isend buffer mutated before its Wait;
- **L107** blocking send/recv cycle patterns (every rank receives first);
- **L108** overlapping RMA accesses to one target inside one fence epoch;
- **L109** persistent-request misuse: ``Start`` called twice without an
  intervening ``Wait``, the plan's buffer mutated between ``Start`` and
  ``Wait``, ``Start`` on a freed plan / freed communicator, or — when the
  unit literally sets ``TPU_MPI_AUTO_ARM_DONATE=1`` — in-place mutation
  of an allocating ``Allreduce`` result (the auto-armed donated plan may
  re-donate that buffer on a later round);
- **L110** an operation on a communicator after ``Comm_revoke`` (with no
  intervening ``Comm_agree``) or on the parent after ``Comm_shrink``;
- **L111** serve-session misuse: an RPC on a detached session, or a
  ``SessionComm`` passed to a *different* session's operation;
- **L116** gradient-bucket handle misuse (training tier): a handle
  produced by ``arm_bucket`` ``Start``ed twice with no intervening
  ``Wait`` (the second round's reduction is lost), or ``Wait``ed while
  not started (blocks forever on the legacy lane).

The linter is deliberately conservative: it only trusts what it can resolve
(literal tags/counts/roots, ``np.zeros``- and ``torch.zeros``-style buffer
shapes, each read as its library reads it, rank variables seeded from
``Comm_rank``) and stays silent otherwise — zero diagnostics on
``examples/`` and ``tpu_mpi_torch/parallel`` is part of the CI contract
(docs/analysis.md). Calls count as MPI calls only as bare names or as
attributes of ``MPI`` / ``mpi`` / ``tpu_mpi_torch``, so unrelated APIs with
colliding method names (e.g. ``queue.get``) are never matched.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from .diagnostics import Diagnostic

_MPI_BASES = {"MPI", "mpi", "tpu_mpi_torch"}

COLLECTIVES = {
    "Barrier", "Bcast", "bcast", "Scatter", "scatter", "Scatterv",
    "Gather", "gather", "Gatherv", "Allgather", "allgather", "Allgatherv",
    "Alltoall", "alltoall", "Alltoallv", "Reduce", "reduce", "Allreduce",
    "allreduce", "Scan", "scan", "Exscan", "exscan", "Reduce_scatter",
    "Reduce_scatter_block", "Comm_dup", "Comm_split", "Comm_split_type",
    "Comm_spawn", "Intercomm_merge", "Win_create", "Win_create_dynamic",
    "Win_allocate_shared", "Win_fence", "Ibarrier", "Ibcast", "Iallreduce",
    "Ireduce", "Igather", "Iallgather", "Iscatter", "Ialltoall", "Iscan",
    "Iexscan",
    # the later surface: ULFM recovery steps and MPI-4 persistent inits are
    # collective too — L101's arm-sequence comparison must not skip them.
    # (Comm_revoke is non-collective per ULFM, but a revoke reached on only
    # SOME arms of a rank-If still leaves the others publishing to a comm
    # the group is abandoning — flag the divergence; symmetric revoke or
    # module-level recovery code stays silent.)
    "Comm_shrink", "Comm_agree", "Comm_revoke",
    "Allreduce_init", "Bcast_init", "Barrier_init",
}
# root rank = keyword "root", else the second-to-last positional argument
# (every rooted signature here ends (..., root, comm)).
ROOTED = {"Bcast", "bcast", "Ibcast", "Reduce", "Ireduce", "Gather",
          "Igather", "Gatherv", "Scatter", "Iscatter", "Scatterv",
          "Bcast_init"}
# reduction-op position from the end of the positional argument list
REDUCE_OP_POS = {"Reduce": -3, "Ireduce": -3, "Allreduce": -2,
                 "Iallreduce": -2, "Scan": -2, "Iscan": -2, "Exscan": -2,
                 "Iexscan": -2, "Reduce_scatter": -2,
                 "Reduce_scatter_block": -2, "Allreduce_init": -2}

# send name -> tag argument position (buffer/object is argument 0)
SEND_TAG_POS = {"Send": 2, "Isend": 2, "send": 2, "isend": 2, "Send_init": 2,
                "Psend_init": 3}
# receive name -> (tag position, buffer position or None)
RECV_TAG_POS = {"Recv": (2, 0), "Irecv": (2, 0), "recv": (1, None),
                "irecv": (1, None), "Recv_init": (2, 0),
                "Precv_init": (3, 0)}
# blocking operations for the deadlock-cycle flow analysis
BLOCKING_RECV = {"Recv", "recv", "Probe"}
BLOCKING_SEND = {"Send", "send"}
RMA_ACCESS = {"Put", "Get", "Accumulate"}

WAIT_NAMES = {"Wait", "Waitall", "Waitany", "Waitsome", "Test", "Testall",
              "Testany", "Testsome"}

# MPI-4 persistent plans whose Start/Wait lifecycle L109 tracks
PERSISTENT_INITS = {"Allreduce_init", "Bcast_init", "Barrier_init",
                    "Send_init", "Recv_init", "Psend_init", "Precv_init"}
# the ULFM recovery verbs — the only calls L110 permits on a marked comm
FT_VERBS = {"Comm_revoke", "Comm_shrink", "Comm_agree", "free", "Comm_free"}
# communication ops whose comm argument L110 inspects (queries like
# Comm_rank stay legal on a revoked comm, so they are not in here)
COMM_OPS = (COLLECTIVES | set(SEND_TAG_POS) | set(RECV_TAG_POS)
            | {"Sendrecv", "Probe", "Iprobe"}) - FT_VERBS
# the serve-tier ClientSession RPC surface (L111)
SESSION_OPS = {"allreduce", "bcast", "barrier", "comm_dup", "comm_free",
               "pcontrol", "stats", "ping"}

_RANK_SEEDS = {"rank", "my_rank", "myrank"}
_BUF_MAKERS = {"zeros", "ones", "empty", "full", "arange", "array"}
# torch's constructors: ``zeros(2, 4)`` or ``zeros((2, 4))`` is a shape,
# ``full`` takes one size sequence, ``tensor`` one (nested) list
_TORCH_MAKERS = {"zeros", "ones", "empty", "full", "arange", "tensor"}


def _unparse(node: Optional[ast.AST]) -> str:
    if node is None:
        return "<none>"
    try:
        return ast.unparse(node)
    except Exception:
        return "<expr>"


def _literal_leaves(node: ast.expr) -> Optional[int]:
    """Element count of a literal (nested) list or tuple, as ``torch.tensor``
    reads it; None where a part is not a literal sequence of equal rows."""
    if not isinstance(node, (ast.List, ast.Tuple)):
        return None
    if not any(isinstance(el, (ast.List, ast.Tuple)) for el in node.elts):
        return len(node.elts)
    rows = [_literal_leaves(el) for el in node.elts]
    if None in rows or len(set(rows)) != 1:
        return None
    return sum(rows)


def _call_name(call: ast.Call) -> Optional[str]:
    """The MPI operation a call names, or None if it isn't one."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id in _MPI_BASES):
        return f.attr
    return None


class _Op:
    """One recognized MPI call in program order."""

    __slots__ = ("name", "call", "line", "arm", "cond", "epoch", "locked")

    def __init__(self, name, call, arm, cond, epoch, locked):
        self.name = name
        self.call = call
        self.line = call.lineno
        self.arm = arm          # innermost rank-branch id, () = unconditional
        self.cond = cond        # under any non-rank conditional / loop
        self.epoch = epoch      # fence-epoch ordinal (L108)
        self.locked = locked    # inside an exclusive Win_lock section


class _Unit:
    """One analysis scope: the module's top level, or one function body."""

    def __init__(self, name: str, stmts: List[ast.stmt], linter: "_Linter"):
        self.name = name
        self.L = linter
        self.ops: List[_Op] = []
        # rank-If descriptors: (if-node, [per-arm collective op lists],
        # has_else, test-source)
        self.rank_ifs: List[tuple] = []
        self._armed: Dict[str, tuple] = {}      # req var -> (buf var, line)
        # L109: plan var -> {kind, buf, comm, started, freed, init_line}
        self._pers: Dict[str, dict] = {}
        # L116: gradient-bucket handle var (arm_bucket result) ->
        # {started: Optional[line], init_line}
        self._bucket: Dict[str, dict] = {}
        self._freed: set = set()                # comm vars already freed
        # L110: comm var -> ("revoked" | "shrunk", line)
        self._ft: Dict[str, tuple] = {}
        # L111: session var -> detach line (None while live);
        # SessionComm var -> owning session var
        self._sessions: Dict[str, Optional[int]] = {}
        self._sess_comms: Dict[str, str] = {}
        # L109 auto-arm lane: only armed by a literal
        # os.environ["TPU_MPI_AUTO_ARM_DONATE"] = "1" in this unit;
        # name -> line of the allocating Allreduce that produced it
        self._auto_donate = False
        self._auto_live: Dict[str, int] = {}
        self._epoch = 0
        self._lock_depth = 0
        self._scan(stmts, arm=(), cond=False)

    # -- ordered traversal --------------------------------------------------

    def _scan(self, stmts, arm, cond):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue                      # separate units
            if isinstance(st, ast.If) and self.L.is_rank_test(st.test):
                self._scan_rank_if(st, arm, cond)
            elif isinstance(st, ast.If):
                self._scan(st.body, arm, True)
                self._scan(st.orelse, arm, True)
            elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                self._scan(st.body, arm, True)
                self._scan(st.orelse, arm, True)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                self._scan(st.body, arm, cond)
            elif isinstance(st, ast.Try):
                for blk in (st.body, st.orelse, st.finalbody):
                    self._scan(blk, arm, True if blk is not st.body else cond)
                for h in st.handlers:
                    self._scan(h.body, arm, True)
            else:
                self._leaf(st, arm, cond)

    def _scan_rank_if(self, node: ast.If, arm, cond):
        """Flatten an ``if rank…/elif/else`` chain into arms and record the
        per-arm collective sequences for L101/102/103."""
        arms: List[List[_Op]] = []
        test_src = _unparse(node.test)
        ifid = id(node)
        cur: Any = node
        has_else = False
        idx = 0
        while True:
            start = len(self.ops)
            self._scan(cur.body, arm + ((ifid, idx),), cond)
            arms.append([op for op in self.ops[start:]
                         if op.name in COLLECTIVES])
            idx += 1
            orelse = cur.orelse
            if len(orelse) == 1 and isinstance(orelse[0], ast.If):
                cur = orelse[0]
                continue
            if orelse:
                has_else = True
                start = len(self.ops)
                self._scan(orelse, arm + ((ifid, idx),), cond)
                arms.append([op for op in self.ops[start:]
                             if op.name in COLLECTIVES])
            break
        self.rank_ifs.append((node, arms, has_else, test_src))

    def _leaf(self, st: ast.stmt, arm, cond):
        calls = [n for n in ast.walk(st) if isinstance(n, ast.Call)]
        calls.sort(key=lambda c: (c.lineno, c.col_offset))
        for call in calls:
            name = _call_name(call)
            if name is None:
                # a `<mod>.arm_bucket(...)` from a non-MPI base still
                # mints a tracked bucket handle (L116)
                self._bucket_effects(st, call, None)
                self._method_effects(st, call)
                continue
            if name == "Win_fence":
                self._epoch += 1
            elif name == "Win_lock":
                if call.args and "EXCLUSIVE" in _unparse(call.args[0]):
                    self._lock_depth += 1
            elif name == "Win_unlock":
                self._lock_depth = max(0, self._lock_depth - 1)
            self.ops.append(_Op(name, call, arm, cond, self._epoch,
                                self._lock_depth > 0))
            self._isend_effects(st, call, name)
            self._persistent_effects(st, call, name)
            self._bucket_effects(st, call, name)
            self._ft_effects(st, call, name)
        self._auto_arm_effects(st)
        self._mutation_effects(st)
        self._assign_clears(st)

    # -- L109 auto-arm bookkeeping: donated armed-result lifetime -----------

    @staticmethod
    def _is_environ(node) -> bool:
        if isinstance(node, ast.Name):
            return node.id == "environ"
        return (isinstance(node, ast.Attribute) and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id == "os")

    def _auto_arm_effects(self, st):
        """Track the donate-knob gate and live donated-result names. The
        gate only opens on a *literal* env assignment, so the rule is
        structurally silent on the shipped tree (zero-FP contract)."""
        if isinstance(st, ast.Delete):
            for t in st.targets:
                if (isinstance(t, ast.Subscript) and self._is_environ(t.value)
                        and isinstance(t.slice, ast.Constant)
                        and t.slice.value == "TPU_MPI_AUTO_ARM_DONATE"):
                    self._auto_donate = False
            return
        for call in ast.walk(st):
            # os.environ.pop("TPU_MPI_AUTO_ARM_DONATE", ...) closes the gate
            if (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "pop"
                    and self._is_environ(call.func.value)
                    and call.args and isinstance(call.args[0], ast.Constant)
                    and call.args[0].value == "TPU_MPI_AUTO_ARM_DONATE"):
                self._auto_donate = False
        if not isinstance(st, ast.Assign) or len(st.targets) != 1:
            return
        t = st.targets[0]
        if (isinstance(t, ast.Subscript) and self._is_environ(t.value)
                and isinstance(t.slice, ast.Constant)
                and t.slice.value == "TPU_MPI_AUTO_ARM_DONATE"
                and isinstance(st.value, ast.Constant)):
            self._auto_donate = str(st.value.value).strip().lower() \
                not in ("", "0", "false", "no", "off")
            return
        target = self._assign_target(st)
        if target is None:
            return
        v = st.value
        if isinstance(v, ast.Call) and _call_name(v) == "Allreduce":
            # allocating form: a result binding while the donate knob is
            # set may alias the armed plan's donated ring slot
            if self._auto_donate:
                self._auto_live[target] = st.lineno
            else:
                self._auto_live.pop(target, None)
        elif isinstance(v, ast.Name) and v.id in self._auto_live:
            self._auto_live[target] = self._auto_live[v.id]
        else:
            self._auto_live.pop(target, None)

    # -- L106 bookkeeping (runs inline with the ordered scan) ---------------

    def _isend_effects(self, st, call, name):
        if name in ("Isend", "isend"):
            if (isinstance(st, ast.Assign) and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)
                    and call.args and isinstance(call.args[0], ast.Name)):
                self._armed[st.targets[0].id] = (call.args[0].id, call.lineno)
        elif name in WAIT_NAMES and call.args:
            a0 = call.args[0]
            if isinstance(a0, ast.Name):
                self._armed.pop(a0.id, None)
            elif isinstance(a0, (ast.List, ast.Tuple)):
                for el in a0.elts:
                    if isinstance(el, ast.Name):
                        self._armed.pop(el.id, None)

    # -- L109 bookkeeping: persistent plan lifecycle ------------------------

    @staticmethod
    def _assign_target(st) -> Optional[str]:
        if (isinstance(st, ast.Assign) and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)):
            return st.targets[0].id
        return None

    def _persistent_effects(self, st, call, name):
        if name in PERSISTENT_INITS:
            target = self._assign_target(st)
            if target is None:
                return
            buf = None
            if name != "Barrier_init" and call.args \
                    and isinstance(call.args[0], ast.Name):
                buf = call.args[0].id
            comm = self.L._arg(call, len(call.args) - 1, kw="comm")
            self._pers[target] = {
                "kind": name, "buf": buf,
                "comm": comm.id if isinstance(comm, ast.Name) else None,
                "started": None, "freed": None, "init_line": call.lineno,
            }
        elif name in ("Start", "Startall"):
            reqs: List[str] = []
            if call.args and isinstance(call.args[0], ast.Name):
                reqs = [call.args[0].id]
            elif call.args and isinstance(call.args[0], (ast.List, ast.Tuple)):
                reqs = [el.id for el in call.args[0].elts
                        if isinstance(el, ast.Name)]
            for r in reqs:
                self._start_plan(r, call.lineno)
        elif name in WAIT_NAMES and call.args:
            a0 = call.args[0]
            names = [a0] if isinstance(a0, ast.Name) else (
                list(a0.elts) if isinstance(a0, (ast.List, ast.Tuple)) else [])
            for el in names:
                if isinstance(el, ast.Name) and el.id in self._pers:
                    self._pers[el.id]["started"] = None
        elif name in ("free", "Comm_free", "Request_free") \
                and call.args and isinstance(call.args[0], ast.Name):
            a = call.args[0].id
            if a in self._pers:
                self._pers[a]["freed"] = call.lineno
            else:
                self._freed.add(a)

    def _start_plan(self, req: str, line: int):
        p = self._pers.get(req)
        if p is None:
            return
        if p["freed"] is not None:
            self.L.diag("L109",
                        f"Start on persistent plan {req!r} after it was freed "
                        f"at line {p['freed']}",
                        line, context=f"{p['kind']} at line {p['init_line']}")
        elif p["comm"] is not None and p["comm"] in self._freed:
            self.L.diag("L109",
                        f"Start on persistent plan {req!r} whose communicator "
                        f"{p['comm']!r} was already freed",
                        line, context=f"{p['kind']} at line {p['init_line']}")
        elif p["started"] is not None:
            self.L.diag("L109",
                        f"Start on persistent plan {req!r} which is already "
                        f"started (line {p['started']}) — call Wait before "
                        f"restarting",
                        line, context=f"{p['kind']} at line {p['init_line']}")
        p["started"] = line

    # -- L116 bookkeeping: gradient-bucket handle lifecycle -----------------

    @staticmethod
    def _is_arm_bucket(call: ast.Call) -> bool:
        """A call that mints a training-tier bucket handle: bare
        ``arm_bucket(...)`` or ``<anything>.arm_bucket(...)`` (the
        distinctive producer name is the whole point — see
        tpu_mpi_torch.train.ddp.arm_bucket)."""
        f = call.func
        return (isinstance(f, ast.Name) and f.id == "arm_bucket") or \
            (isinstance(f, ast.Attribute) and f.attr == "arm_bucket")

    def _bucket_effects(self, st, call, name):
        if self._is_arm_bucket(call):
            target = self._assign_target(st)
            if target is not None:
                self._bucket[target] = {"started": None,
                                        "init_line": call.lineno}
            return
        if name in ("Start", "Startall"):
            reqs: List[str] = []
            if call.args and isinstance(call.args[0], ast.Name):
                reqs = [call.args[0].id]
            elif call.args and isinstance(call.args[0], (ast.List, ast.Tuple)):
                reqs = [el.id for el in call.args[0].elts
                        if isinstance(el, ast.Name)]
            for r in reqs:
                self._start_bucket(r, call.lineno)
        elif name in WAIT_NAMES and call.args:
            a0 = call.args[0]
            names = [a0] if isinstance(a0, ast.Name) else (
                list(a0.elts) if isinstance(a0, (ast.List, ast.Tuple)) else [])
            for el in names:
                if isinstance(el, ast.Name):
                    self._wait_bucket(el.id, call.lineno)

    def _start_bucket(self, req: str, line: int):
        b = self._bucket.get(req)
        if b is None:
            return
        if b["started"] is not None:
            self.L.diag("L116",
                        f"gradient bucket {req!r} Started twice (previous "
                        f"Start at line {b['started']}) with no intervening "
                        f"Wait — the second round's reduction is lost",
                        line, context=f"arm_bucket at line {b['init_line']}")
        b["started"] = line

    def _wait_bucket(self, req: str, line: int):
        b = self._bucket.get(req)
        if b is None:
            return
        if b["started"] is None:
            self.L.diag("L116",
                        f"Wait on gradient bucket {req!r} which is not "
                        f"started — blocks forever on the legacy lane",
                        line, context=f"arm_bucket at line {b['init_line']}")
        b["started"] = None

    # -- L110 bookkeeping: revoked / shrunk communicators -------------------

    def _ft_effects(self, st, call, name):
        if name == "Comm_revoke":
            if call.args and isinstance(call.args[0], ast.Name):
                self._ft[call.args[0].id] = ("revoked", call.lineno)
            return
        if name == "Comm_shrink":
            if call.args and isinstance(call.args[0], ast.Name):
                self._ft[call.args[0].id] = ("shrunk", call.lineno)
            return
        comm = self.L._arg(call, len(call.args) - 1, kw="comm") \
            if call.args or call.keywords else None
        cname = comm.id if isinstance(comm, ast.Name) else None
        if name == "Comm_agree":
            # the group ran the decision protocol: reuse is deliberate now
            if call.args and isinstance(call.args[0], ast.Name):
                self._ft.pop(call.args[0].id, None)
            return
        if name in COMM_OPS and cname is not None and cname in self._ft:
            state, ftline = self._ft[cname]
            if state == "revoked":
                why = (f"{cname!r} was revoked at line {ftline} — run "
                       f"Comm_agree or switch to the Comm_shrink result first")
            else:
                why = (f"{cname!r} is the parent of a Comm_shrink at line "
                       f"{ftline} — use the shrunk communicator")
            self.L.diag("L110", f"{name} on communicator {why}",
                        call.lineno, context=f"comm variable {cname!r}")

    # -- L111 bookkeeping: serve-tier client sessions -----------------------

    def _session_attach(self, st, call) -> bool:
        """True if ``call`` is serve.attach(...); records the session var."""
        f = call.func
        is_attach = False
        if isinstance(f, ast.Name) and f.id == "attach":
            is_attach = True
        elif isinstance(f, ast.Attribute) and f.attr == "attach":
            base = f.value
            if isinstance(base, ast.Name) and base.id == "serve":
                is_attach = True
            elif (isinstance(base, ast.Attribute) and base.attr == "serve"
                    and isinstance(base.value, ast.Name)
                    and base.value.id in _MPI_BASES):
                is_attach = True
        if is_attach:
            target = self._assign_target(st)
            if target is not None:
                self._sessions[target] = None
        return is_attach

    def _session_effects(self, st, call, base, meth):
        detached = self._sessions[base]
        if meth in ("detach", "close"):
            self._sessions[base] = call.lineno
            return
        if meth not in SESSION_OPS:
            return
        if detached is not None:
            self.L.diag("L111",
                        f"{meth}() on session {base!r} after it was detached "
                        f"at line {detached}",
                        call.lineno, context=f"session variable {base!r}")
        if meth == "comm_dup":
            target = self._assign_target(st)
            if target is not None:
                self._sess_comms[target] = base
        for val in list(call.args) + [k.value for k in call.keywords]:
            if isinstance(val, ast.Name):
                owner = self._sess_comms.get(val.id)
                if owner is not None and owner != base:
                    self.L.diag(
                        "L111",
                        f"{meth}() on session {base!r} is passed communicator "
                        f"{val.id!r} that belongs to session {owner!r} — "
                        f"session comms are tenant-scoped",
                        call.lineno, context=f"comm variable {val.id!r}")

    def _method_effects(self, st, call):
        # req.wait() / req.test() disarm; buf.fill()-style calls mutate
        if self._session_attach(st, call):
            return
        f = call.func
        if not (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)):
            return
        base, meth = f.value.id, f.attr
        if base in self._sessions:
            self._session_effects(st, call, base, meth)
            return
        if meth in ("wait", "test", "Wait", "Test"):
            self._armed.pop(base, None)
            if base in self._pers:
                self._pers[base]["started"] = None
            if base in self._bucket:
                self._wait_bucket(base, call.lineno)
        elif meth in ("start", "Start") and base in self._pers:
            self._start_plan(base, call.lineno)
        elif meth in ("start", "Start") and base in self._bucket:
            self._start_bucket(base, call.lineno)
        elif meth == "free":
            if base in self._pers:
                self._pers[base]["freed"] = call.lineno
            else:
                self._freed.add(base)
        elif meth in ("fill", "sort", "put", "setfield", "resize"):
            self._flag_mutation(base, call.lineno)

    def _mutation_effects(self, st):
        targets: List[ast.expr] = []
        if isinstance(st, ast.Assign):
            targets = list(st.targets)
        elif isinstance(st, ast.AugAssign):
            targets = [st.target]
        for t in targets:
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                self._flag_mutation(t.value.id, st.lineno)
            elif isinstance(t, ast.Name) and isinstance(st, ast.AugAssign):
                self._flag_mutation(t.id, st.lineno)

    def _flag_mutation(self, varname: str, line: int):
        for req, (buf, post_line) in list(self._armed.items()):
            if buf == varname:
                self.L.diag("L106",
                            f"buffer {varname!r} of the Isend posted at line "
                            f"{post_line} is mutated before its Wait",
                            line, context=f"request variable {req!r}")
                del self._armed[req]
        for req, p in self._pers.items():
            # partitioned plans are EXPECTED to fill partitions between
            # Start and Wait — Pready/Parrived carry the per-slice contract
            if p["kind"] in ("Psend_init", "Precv_init"):
                continue
            if p["started"] is not None and p["buf"] == varname:
                self.L.diag("L109",
                            f"buffer {varname!r} of persistent plan {req!r} "
                            f"is mutated between Start (line {p['started']}) "
                            f"and its Wait",
                            line, context=f"{p['kind']} at line "
                                          f"{p['init_line']}")
                p["buf"] = None         # one diagnostic per plan
        src = self._auto_live.pop(varname, None)
        if src is not None:
            self.L.diag("L109",
                        f"result {varname!r} of the allocating Allreduce at "
                        f"line {src} is mutated in place — with "
                        f"TPU_MPI_AUTO_ARM_DONATE=1 the auto-armed plan may "
                        f"re-donate this buffer on a later round; copy it "
                        f"before writing",
                        line,
                        context="TPU_MPI_AUTO_ARM_DONATE=1 set in this unit")

    def _assign_clears(self, st):
        """Rebinding a tracked name retires whatever it pointed at."""
        target = self._assign_target(st)
        if target is None:
            return
        self._ft.pop(target, None)
        self._freed.discard(target)
        if not (isinstance(st.value, ast.Call)
                and _call_name(st.value) in PERSISTENT_INITS):
            self._pers.pop(target, None)
        if not (isinstance(st.value, ast.Call)
                and self._is_arm_bucket(st.value)):
            self._bucket.pop(target, None)
        if not (isinstance(st.value, ast.Call)
                and self._session_is_attach_value(st.value)):
            self._sessions.pop(target, None)
            self._sess_comms.pop(target, None)

    @staticmethod
    def _session_is_attach_value(call: ast.Call) -> bool:
        f = call.func
        return (isinstance(f, ast.Name) and f.id == "attach") or \
            (isinstance(f, ast.Attribute) and f.attr in ("attach", "comm_dup"))


class _Linter:
    """One source file: prescan + per-unit checks."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.out: List[Diagnostic] = []
        self.rank_vars = set(_RANK_SEEDS)
        self.var_int: Dict[str, int] = {}
        self.var_buf: Dict[str, tuple] = {}     # name -> (size, dtype src)
        self._prescan()

    def diag(self, code: str, msg: str, line: int, context: str = "",
             related: tuple = ()):
        self.out.append(Diagnostic(code, msg, file=self.path, line=line,
                                   context=context, related=related))

    # -- whole-file prescan: rank vars, int vars, buffer shapes -------------

    def _prescan(self):
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            val = node.value
            if isinstance(val, ast.Constant) and isinstance(val.value, int) \
                    and not isinstance(val.value, bool):
                self.var_int[name] = val.value
            if isinstance(val, ast.Call):
                cn = _call_name(val)
                if cn in ("Comm_rank", "Get_rank"):
                    self.rank_vars.add(name)
                    continue
                if (isinstance(val.func, ast.Attribute)
                        and val.func.attr == "Get_rank"):
                    self.rank_vars.add(name)
                    continue
                self._note_buffer(name, val)
            if any(isinstance(n, ast.Name) and n.id in self.rank_vars
                   for n in ast.walk(val)):
                self.rank_vars.add(name)        # rank-derived

    def _note_buffer(self, name: str, call: ast.Call):
        f = call.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "torch":
            if f.attr in _TORCH_MAKERS:
                self._note_torch_buffer(name, f.attr, call)
            return
        maker = None
        if isinstance(f, ast.Attribute) and f.attr in _BUF_MAKERS:
            maker = f.attr
        elif isinstance(f, ast.Name) and f.id in _BUF_MAKERS:
            maker = f.id
        if maker is None or not call.args:
            return
        size = None
        a0 = call.args[0]
        if maker == "array" and isinstance(a0, (ast.List, ast.Tuple)):
            size = len(a0.elts)
        else:
            shape = a0
            if isinstance(shape, (ast.Tuple, ast.List)) and len(shape.elts) == 1:
                shape = shape.elts[0]
            size = self.literal_int(shape)
        if size is None:
            return
        dtype = None
        for kw in call.keywords:
            if kw.arg == "dtype":
                dtype = _unparse(kw.value)
        if dtype is None and maker in ("zeros", "ones", "empty") \
                and len(call.args) > 1:
            dtype = _unparse(call.args[1])
        self.var_buf[name] = (size, dtype)

    def _note_torch_buffer(self, name: str, maker: str, call: ast.Call):
        """A ``torch.<maker>(...)`` buffer as torch reads it: the element
        count of its shape and the dtype of its ``dtype=`` keyword (torch
        takes no positional dtype)."""
        kw = {k.arg: k.value for k in call.keywords if k.arg is not None}
        size = None
        if maker == "tensor":
            if call.args:
                size = _literal_leaves(call.args[0])
        elif maker == "arange":
            bounds = [self.literal_int(a) for a in call.args]
            if 1 <= len(bounds) <= 3 and None not in bounds \
                    and bounds[2:] != [0]:
                size = len(range(*bounds))
        else:
            dims = call.args[:1] if maker == "full" else call.args
            if not dims and "size" in kw:
                dims = [kw["size"]]
            if len(dims) == 1 and isinstance(dims[0], (ast.Tuple, ast.List)):
                dims = dims[0].elts
            elif maker == "full":
                dims = []           # full's size is one sequence
            sizes = [self.literal_int(d) for d in dims]
            if sizes and None not in sizes:
                size = 1
                for d in sizes:
                    size *= d
        if size is None:
            return
        dtype = _unparse(kw["dtype"]) if "dtype" in kw else None
        self.var_buf[name] = (size, dtype)

    # -- small resolvers ----------------------------------------------------

    def literal_int(self, node: Optional[ast.expr]) -> Optional[int]:
        if node is None:
            return None
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            inner = self.literal_int(node.operand)
            return -inner if inner is not None else None
        if isinstance(node, ast.Name):
            return self.var_int.get(node.id)
        return None

    def is_rank_test(self, test: ast.expr) -> bool:
        return any(isinstance(n, ast.Name) and n.id in self.rank_vars
                   for n in ast.walk(test))

    def uses_rank(self, node: Optional[ast.expr]) -> bool:
        return node is not None and any(
            isinstance(n, ast.Name) and n.id in self.rank_vars
            for n in ast.walk(node))

    @staticmethod
    def _arg(call: ast.Call, pos: int, kw: Optional[str] = None
             ) -> Optional[ast.expr]:
        if kw is not None:
            for k in call.keywords:
                if k.arg == kw:
                    return k.value
        try:
            return call.args[pos]
        except IndexError:
            return None

    def _root_of(self, op: _Op) -> Optional[ast.expr]:
        return self._arg(op.call, len(op.call.args) - 2, kw="root")

    def _reduce_op_of(self, op: _Op) -> Optional[ast.expr]:
        pos = REDUCE_OP_POS.get(op.name)
        if pos is None:
            return None
        return self._arg(op.call, len(op.call.args) + pos, kw="op")

    def _buf_dtype_of(self, op: _Op) -> Optional[str]:
        if not op.call.args or not isinstance(op.call.args[0], ast.Name):
            return None
        info = self.var_buf.get(op.call.args[0].id)
        return info[1] if info else None

    # -- the pass -----------------------------------------------------------

    def run(self) -> List[Diagnostic]:
        units = [_Unit("<module>", list(self.tree.body), self)]
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                units.append(_Unit(node.name, list(node.body), self))
        for u in units:
            self._check_rank_ifs(u)
            self._check_truncation(u)
            self._check_unmatched_sends(u)
            self._check_cycles(u)
            self._check_rma(u)
        self.out.sort(key=lambda d: (d.line, d.code))
        return self.out

    # -- L101 / L102 / L103 -------------------------------------------------

    def _check_rank_ifs(self, u: _Unit):
        for node, arms, has_else, test_src in u.rank_ifs:
            if not any(arms):
                continue                    # no collectives anywhere: fine
            seqs = [[o.name for o in arm] for arm in arms]
            if not has_else:
                seqs.append([])             # the implicit empty branch
                arms = arms + [[]]
            if self._flag_sequence_divergence(arms, seqs, test_src, node):
                continue
            # identical sequences: compare signatures position by position
            base = arms[0]
            for other in arms[1:]:
                for a, b in zip(base, other):
                    self._compare_signatures(a, b, test_src)

    def _flag_sequence_divergence(self, arms, seqs, test_src, node) -> bool:
        longest = max(len(s) for s in seqs)
        for i in range(longest):
            names = [s[i] if i < len(s) else None for s in seqs]
            if len(set(names)) == 1:
                continue
            # first divergence: anchor on the first arm that HAS a
            # collective at this position
            armno = next(k for k, s in enumerate(seqs) if i < len(s))
            op = arms[armno][i]
            present = sorted({n for n in names if n is not None})
            if names.count(None):
                detail = "no matching call on the other branch"
            else:
                detail = f"the branches call {present}"
            self.diag("L101",
                      f"collective {op.name} is reached on only some ranks: "
                      f"sequence position {i} diverges across the branches "
                      f"of `if {test_src}:` ({detail})",
                      op.line, context=f"if {test_src}")
            return True
        return False

    def _compare_signatures(self, a: _Op, b: _Op, test_src: str):
        if a.name in ROOTED:
            ra, rb = self._root_of(a), self._root_of(b)
            va, vb = self.literal_int(ra), self.literal_int(rb)
            if (va is not None and vb is not None and va != vb) or \
               (va is None and vb is None and ra is not None and
                    rb is not None and _unparse(ra) != _unparse(rb)):
                self.diag("L102",
                          f"root of {a.name} differs across the branches of "
                          f"`if {test_src}:`: {_unparse(ra)} vs {_unparse(rb)}",
                          b.line, context=f"if {test_src}",
                          related=((self.path, a.line, "the other branch"),))
        if a.name in REDUCE_OP_POS:
            oa, ob = self._reduce_op_of(a), self._reduce_op_of(b)
            if oa is not None and ob is not None and \
                    _unparse(oa) != _unparse(ob):
                self.diag("L103",
                          f"reduction op of {a.name} differs across the "
                          f"branches of `if {test_src}:`: {_unparse(oa)} vs "
                          f"{_unparse(ob)}",
                          b.line, context=f"if {test_src}",
                          related=((self.path, a.line, "the other branch"),))
                return
        da, db = self._buf_dtype_of(a), self._buf_dtype_of(b)
        if da is not None and db is not None and da != db:
            self.diag("L103",
                      f"buffer dtype of {a.name} differs across the branches "
                      f"of `if {test_src}:`: {da} vs {db}",
                      b.line, context=f"if {test_src}",
                      related=((self.path, a.line, "the other branch"),))

    # -- L104 ---------------------------------------------------------------

    def _check_truncation(self, u: _Unit):
        sends, recvs = [], []
        for op in u.ops:
            if op.name in ("Send", "Isend", "Send_init"):
                tag = self.literal_int(self._arg(op.call, 2, kw="tag"))
                buf = op.call.args[0] if op.call.args else None
                if tag is not None and isinstance(buf, ast.Name):
                    info = self.var_buf.get(buf.id)
                    if info:
                        sends.append((tag, info[0], op))
            elif op.name in ("Recv", "Irecv", "Recv_init"):
                tag = self.literal_int(self._arg(op.call, 2, kw="tag"))
                buf = op.call.args[0] if op.call.args else None
                if tag is not None and isinstance(buf, ast.Name):
                    info = self.var_buf.get(buf.id)
                    if info:
                        recvs.append((tag, info[0], op))
        for stag, ssize, sop in sends:
            for rtag, rsize, rop in recvs:
                if stag == rtag and rsize < ssize:
                    self.diag("L104",
                              f"receive buffer holds {rsize} elements but "
                              f"the matching send (line {sop.line}, tag "
                              f"{stag}) ships {ssize}",
                              rop.line,
                              related=((self.path, sop.line, "the send"),))

    # -- L105 ---------------------------------------------------------------

    def _check_unmatched_sends(self, u: _Unit):
        recv_tags = set()
        wildcard = False
        n_recvs = 0
        for op in u.ops:
            if op.name in RECV_TAG_POS:
                n_recvs += 1
                pos, _ = RECV_TAG_POS[op.name]
                tnode = self._arg(op.call, pos, kw="tag")
                t = self.literal_int(tnode)
                if t is None:
                    wildcard = True     # ANY_TAG / computed tag: stay silent
                else:
                    recv_tags.add(t)
            elif op.name == "Sendrecv":
                n_recvs += 1
                t = self.literal_int(self._arg(op.call, 5, kw="recvtag"))
                if t is None:
                    wildcard = True
                else:
                    recv_tags.add(t)
        if wildcard:
            return
        if u.name != "<module>" and n_recvs == 0:
            return      # a send-only helper may be matched by its caller
        for op in u.ops:
            tag = None
            if op.name in SEND_TAG_POS:
                tag = self.literal_int(
                    self._arg(op.call, SEND_TAG_POS[op.name], kw="tag"))
            elif op.name == "Sendrecv":
                tag = self.literal_int(self._arg(op.call, 2, kw="sendtag"))
            if tag is not None and tag not in recv_tags:
                self.diag("L105",
                          f"{op.name} with tag {tag} has no receive with a "
                          f"matching tag in this scope "
                          f"(receive tags seen: {sorted(recv_tags)})",
                          op.line)

    # -- L107 ---------------------------------------------------------------

    def _first_blocking(self, ops: List[_Op]) -> Optional[_Op]:
        for op in ops:
            if op.name in BLOCKING_RECV or op.name in BLOCKING_SEND:
                return op
        return None

    def _check_cycles(self, u: _Unit):
        # flow A: every rank's first unconditional blocking P2P op is a
        # receive from a rank-dependent source -> nobody ever sends first.
        flat = [op for op in u.ops if op.arm == () and not op.cond]
        first = self._first_blocking(flat)
        if first is not None and first.name in BLOCKING_RECV:
            src = self._arg(first.call,
                            0 if first.name in ("recv", "Probe") else 1,
                            kw="src")
            if self.uses_rank(src) and "PROC_NULL" not in _unparse(src):
                later_send = any(
                    op.name in BLOCKING_SEND or op.name in ("Isend", "isend")
                    for op in flat if op.line > first.line)
                if later_send:
                    self.diag("L107",
                              f"every rank blocks in {first.name} (source "
                              f"{_unparse(src)}) before any rank sends — "
                              f"a send/recv cycle",
                              first.line,
                              context="first blocking operation is a receive "
                                      "on all ranks")
        # flow B: a rank-If with else where EVERY arm receives first
        for node, _arms, has_else, test_src in u.rank_ifs:
            if not has_else:
                continue
            ifid = id(node)
            per_arm: Dict[int, List[_Op]] = {}
            for op in u.ops:
                for (i, idx) in op.arm:
                    if i == ifid:
                        per_arm.setdefault(idx, []).append(op)
            firsts = [self._first_blocking(ops)
                      for ops in per_arm.values() if ops]
            firsts = [f for f in firsts if f is not None]
            if len(firsts) >= 2 and all(f.name in BLOCKING_RECV
                                        for f in firsts):
                self.diag("L107",
                          f"every branch of `if {test_src}:` blocks in a "
                          f"receive first — no rank can reach its send",
                          firsts[0].line, context=f"if {test_src}")

    # -- L108 ---------------------------------------------------------------

    def _rma_range(self, op: _Op):
        """(target literal, lo, hi) of a Put/Get/Accumulate, or None."""
        args = op.call.args
        if op.name in ("Put", "Get"):
            if len(args) == 5:
                count = self.literal_int(args[1])
                target = self.literal_int(args[2])
                disp = self.literal_int(args[3])
            elif len(args) == 3:
                target = self.literal_int(args[1])
                disp, count = 0, None
                if isinstance(args[0], ast.Name):
                    info = self.var_buf.get(args[0].id)
                    count = info[0] if info else None
            else:
                return None
        elif op.name == "Accumulate" and len(args) >= 5:
            count = self.literal_int(args[1])
            target = self.literal_int(args[2])
            disp = self.literal_int(args[3])
        else:
            return None
        if target is None or disp is None or count is None:
            return None
        return (target, disp, disp + count)

    def _check_rma(self, u: _Unit):
        accesses = []
        for op in u.ops:
            if op.name in RMA_ACCESS:
                rng = self._rma_range(op)
                if rng is not None:
                    accesses.append((op, rng))
        for i in range(len(accesses)):
            a, (ta, loa, hia) = accesses[i]
            for j in range(i + 1, len(accesses)):
                b, (tb, lob, hib) = accesses[j]
                if ta != tb or a.epoch != b.epoch:
                    continue
                if hia <= lob or hib <= loa:
                    continue
                if a.name == "Get" and b.name == "Get":
                    continue
                if a.name == "Accumulate" and b.name == "Accumulate":
                    continue
                if a.locked and b.locked:
                    continue        # serialized by an exclusive lock
                # different rank arms, or both unconditional (every rank
                # runs both) -> concurrent origins, one target, same epoch
                if a.arm != b.arm or (a.arm == () and b.arm == ()):
                    self.diag("L108",
                              f"{a.name} (line {a.line}) and {b.name} both "
                              f"touch [{max(loa, lob)}, {min(hia, hib)}) of "
                              f"rank {ta}'s window in the same fence epoch "
                              f"with no ordering between them",
                              b.line,
                              related=((self.path, a.line,
                                        "the other access"),))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def lint_source(src: str, path: str = "<string>") -> List[Diagnostic]:
    """Lint one source string."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Diagnostic("L100", f"could not parse: {e.msg}", file=path,
                           line=e.lineno or 0)]
    return _Linter(path, tree).run()


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


def lint_paths(paths) -> List[Diagnostic]:
    """Lint files and directories (directories recurse over ``*.py``)."""
    out: List[Diagnostic] = []
    for path in _expand(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
        except OSError as e:
            out.append(Diagnostic("L100", f"could not read: {e}", file=path))
            continue
        out.extend(lint_source(src, path))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m tpu_mpi_torch.lint file.py dir/ …`` — prints diagnostics,
    exits 1 if any were found."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    diags = lint_paths(argv)
    for d in diags:
        print(d)
    if diags:
        print(f"{len(diags)} diagnostic(s) in {len(_expand(argv))} file(s)")
        return 1
    return 0
