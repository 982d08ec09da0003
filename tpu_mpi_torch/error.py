"""Typed exception hierarchy + the MPI error-code space.

Reference: MPI.jl wraps every ccall in ``@mpichk`` and raises ``MPIError(code)``
whose message comes from ``MPI_Error_string`` (MPI.jl src/error.jl:1-23).
The TPU-native runtime raises typed Python exceptions directly — the message is
always complete — but every exception also carries a ``code`` drawn from the
standard MPI error-class space (MPI 4.0 §9.4, MPICH numbering), so FFI-shaped
callers and ``Error_string`` round-trip the way the reference's do.
"""

from __future__ import annotations

# --------------------------------------------------------------------------
# MPI error classes (MPI 4.0 §9.4; values follow MPICH, the ABI the reference
# defaults to — MPI.jl deps/consts_mpich.jl). SUCCESS..ERR_PENDING
# are the MPI-1 classes; the 20+ block is the MPI-2 IO/RMA/spawn classes.
# --------------------------------------------------------------------------
SUCCESS = 0
ERR_BUFFER = 1
ERR_COUNT = 2
ERR_TYPE = 3
ERR_TAG = 4
ERR_COMM = 5
ERR_RANK = 6
ERR_ROOT = 7
ERR_GROUP = 8
ERR_OP = 9
ERR_TOPOLOGY = 10
ERR_DIMS = 11
ERR_ARG = 12
ERR_UNKNOWN = 13
ERR_TRUNCATE = 14
ERR_OTHER = 15
ERR_INTERN = 16
ERR_IN_STATUS = 17
ERR_PENDING = 18
ERR_REQUEST = 19
ERR_ACCESS = 20
ERR_AMODE = 21
ERR_ASSERT = 22
ERR_FILE = 30
ERR_INFO_KEY = 31
ERR_INFO_VALUE = 33
ERR_INFO = 34
ERR_IO = 35
ERR_LOCKTYPE = 37
ERR_NO_SUCH_FILE = 42
ERR_RMA_SYNC = 47
ERR_SIZE = 49
ERR_SPAWN = 50
ERR_UNSUPPORTED_OPERATION = 52
ERR_WIN = 53
# Implementation-specific classes (past MPI_ERR_LASTCODE's standard block),
# for conditions libmpi cannot detect but this runtime does:
ERR_DEADLOCK = 64
ERR_COLLECTIVE_MISMATCH = 65
ERR_ABORTED = 66
ERR_RMA_RACE = 67
ERR_ANALYZE = 68
ERR_PROC_FAILED = 69
ERR_REVOKED = 70
ERR_QUOTA = 71
ERR_SERVE_BUSY = 72
ERR_SESSION = 73
ERR_SLO_EXPIRED = 74
ERR_POOL_DEGRADED = 75
ERR_LOCK_ORDER = 76

_ERROR_STRINGS = {
    SUCCESS: "MPI_SUCCESS: no error",
    ERR_BUFFER: "MPI_ERR_BUFFER: invalid buffer pointer or operand",
    ERR_COUNT: "MPI_ERR_COUNT: invalid count argument",
    ERR_TYPE: "MPI_ERR_TYPE: invalid datatype argument",
    ERR_TAG: "MPI_ERR_TAG: invalid tag argument",
    ERR_COMM: "MPI_ERR_COMM: invalid communicator (null, freed, or wrong kind)",
    ERR_RANK: "MPI_ERR_RANK: invalid rank for this communicator",
    ERR_REQUEST: "MPI_ERR_REQUEST: invalid or inactive request handle",
    ERR_ROOT: "MPI_ERR_ROOT: invalid root rank for this communicator",
    ERR_GROUP: "MPI_ERR_GROUP: invalid group argument",
    ERR_OP: "MPI_ERR_OP: invalid or non-applicable reduction operation",
    ERR_TOPOLOGY: "MPI_ERR_TOPOLOGY: invalid topology or topology-less communicator",
    ERR_DIMS: "MPI_ERR_DIMS: invalid dimension specification",
    ERR_ARG: "MPI_ERR_ARG: invalid argument",
    ERR_UNKNOWN: "MPI_ERR_UNKNOWN: unknown error",
    ERR_TRUNCATE: "MPI_ERR_TRUNCATE: receive buffer smaller than incoming message",
    ERR_OTHER: "MPI_ERR_OTHER: known error not in this list "
               "(see the raised exception's message)",
    ERR_INTERN: "MPI_ERR_INTERN: internal runtime error",
    ERR_IN_STATUS: "MPI_ERR_IN_STATUS: error code is in the status object",
    ERR_PENDING: "MPI_ERR_PENDING: operation pending, not failed",
    ERR_ACCESS: "MPI_ERR_ACCESS: permission denied on file",
    ERR_AMODE: "MPI_ERR_AMODE: invalid file access-mode combination",
    ERR_ASSERT: "MPI_ERR_ASSERT: invalid assertion argument",
    ERR_FILE: "MPI_ERR_FILE: invalid file handle",
    ERR_INFO_KEY: "MPI_ERR_INFO_KEY: info key too long or not ASCII",
    ERR_INFO_VALUE: "MPI_ERR_INFO_VALUE: info value too long or not ASCII",
    ERR_INFO: "MPI_ERR_INFO: invalid info object",
    ERR_IO: "MPI_ERR_IO: file I/O error",
    ERR_LOCKTYPE: "MPI_ERR_LOCKTYPE: invalid RMA lock type",
    ERR_NO_SUCH_FILE: "MPI_ERR_NO_SUCH_FILE: file does not exist",
    ERR_RMA_SYNC: "MPI_ERR_RMA_SYNC: RMA call out of epoch / wrong synchronization",
    ERR_SIZE: "MPI_ERR_SIZE: invalid size argument",
    ERR_SPAWN: "MPI_ERR_SPAWN: could not spawn processes",
    ERR_UNSUPPORTED_OPERATION: "MPI_ERR_UNSUPPORTED_OPERATION: operation not "
                               "supported on this object or backend",
    ERR_WIN: "MPI_ERR_WIN: invalid RMA window",
    ERR_DEADLOCK: "TPU_ERR_DEADLOCK: blocking operation exceeded the runtime's "
                  "deadlock timeout",
    ERR_COLLECTIVE_MISMATCH: "TPU_ERR_COLLECTIVE_MISMATCH: ranks of one "
                             "communicator called different collectives in the "
                             "same round",
    ERR_ABORTED: "TPU_ERR_ABORTED: job fate-shared down by MPI.Abort or a "
                 "failing rank",
    ERR_RMA_RACE: "TPU_ERR_RMA_RACE: concurrent overlapping RMA accesses in "
                  "one exposure epoch (tpu_mpi_torch.analyze race detector)",
    ERR_ANALYZE: "TPU_ERR_ANALYZE: communication-correctness diagnostic "
                 "(tpu_mpi_torch.analyze)",
    ERR_PROC_FAILED: "TPU_ERR_PROC_FAILED: a peer process died (heartbeat "
                     "timeout or closed transport socket) — shrink or abort",
    ERR_REVOKED: "TPU_ERR_REVOKED: communicator revoked by Comm_revoke after "
                 "a failure; only Comm_shrink/Comm_agree remain legal on it",
    ERR_QUOTA: "TPU_ERR_QUOTA: tenant byte/op quota exhausted; the broker "
               "rejected the operation (raise the quota or detach)",
    ERR_SERVE_BUSY: "TPU_ERR_SERVE_BUSY: broker admission queue full for this "
                    "tenant — retriable backpressure, resubmit after a backoff",
    ERR_SESSION: "TPU_ERR_SESSION: session handshake or lease violation "
                 "(bad token, tenant limit, revoked lease, or a cid outside "
                 "the leased namespace)",
    ERR_SLO_EXPIRED: "TPU_ERR_SLO_EXPIRED: generation request evicted — its "
                     "latency-SLO deadline expired before completion; "
                     "retriable under lighter load",
    ERR_POOL_DEGRADED: "TPU_ERR_POOL_DEGRADED: the serve pool lost ranks and "
                       "is running degraded — this tenant's communicators "
                       "span a dead rank; retriable once the autoscaler "
                       "restores capacity and rebinds the lease",
    ERR_LOCK_ORDER: "TPU_ERR_LOCK_ORDER: two threads established inverted "
                    "lock-acquisition order (tpu_mpi_torch.locksmith witness) — a "
                    "potential deadlock caught before any thread blocked",
}

# tpu_mpi_torch.analyze diagnostic code -> MPI error class. The analyzer's own
# code space (Lxxx static lint, Txxx trace verifier, Rxxx race detector —
# docs/analysis.md) projects onto the MPI classes above so FFI-shaped
# callers can Error_string any Diagnostic.mpi_code.
DIAGNOSTIC_CODES = {
    "L100": ERR_ARG,                    # unparseable source
    "L101": ERR_COLLECTIVE_MISMATCH,    # rank-divergent collective sequence
    "L102": ERR_ROOT,                   # root mismatch across rank branches
    "L103": ERR_TYPE,                   # op/dtype mismatch across branches
    "L104": ERR_TRUNCATE,               # recv-count truncation
    "L105": ERR_PENDING,                # send with no matching receive
    "L106": ERR_BUFFER,                 # send-buffer reuse before Wait
    "L107": ERR_DEADLOCK,               # blocking send/recv cycle pattern
    "L108": ERR_RMA_RACE,               # static RMA epoch race
    "L109": ERR_REQUEST,                # persistent-request misuse
    "L110": ERR_REVOKED,                # op on revoked/shrunk communicator
    "L111": ERR_SESSION,                # serve-session misuse
    "L112": ERR_LOCK_ORDER,             # static lock-order cycle
    "L113": ERR_DEADLOCK,               # blocking under a dispatch/pool lock
    "L114": ERR_INTERN,                 # unguarded cross-thread field write
    "L115": ERR_LOCK_ORDER,             # release path differs from acquire
    "L116": ERR_REQUEST,                # gradient-bucket handle misuse
    "T201": ERR_COLLECTIVE_MISMATCH,    # collective order mismatch (traced)
    "T202": ERR_COLLECTIVE_MISMATCH,    # collective signature mismatch
    "T203": ERR_PENDING,                # sent message never received
    "T206": ERR_BUFFER,                 # Isend buffer modified before Wait
    "T207": ERR_REVOKED,                # agree/shrink protocol divergence
    "T208": ERR_SESSION,                # measured books don't partition pool
    "T210": ERR_DEADLOCK,               # alternate-schedule deadlock
    "T211": ERR_PENDING,                # alternate-schedule orphaned message
    "T212": ERR_ARG,                    # schedule-dependent wildcard values
    "T213": ERR_COLLECTIVE_MISMATCH,    # per-rank algorithm selection split
    "T214": ERR_COLLECTIVE_MISMATCH,    # rank skipped elastic rebind barrier
    "T215": ERR_COLLECTIVE_MISMATCH,    # dispatch sections failed to serialize
    "C401": ERR_DEADLOCK,               # blocked while holding a witnessed lock
    "R301": ERR_RMA_RACE,               # vector-clock RMA race
    "R302": ERR_BUFFER,                 # donated fold result read after inval
}


def diagnostic_error_code(diag_code: str) -> int:
    """MPI error class for a tpu_mpi_torch.analyze diagnostic code."""
    return DIAGNOSTIC_CODES.get(str(diag_code), ERR_ANALYZE)


class MPIError(RuntimeError):
    """Root of all framework errors (analog of MPI.jl's MPIError,
    src/error.jl:1-3). ``code`` defaults to the class's MPI error class
    (``CODE``), so every exception type is distinguishable by code alone the
    way libmpi's error classes are."""

    CODE = ERR_OTHER

    def __init__(self, msg: str = "MPI error", code: "int | None" = None):
        super().__init__(msg)
        self.code = self.CODE if code is None else int(code)
        # flight-recorder note (docs/observability.md): crash-grade codes
        # auto-dump the ring. Lazy import — config imports this module, so
        # flight (which imports config) can only be reached from here at
        # call time; any failure must never mask the error being raised.
        try:
            from . import flight
            flight.on_error(self)
        except Exception:
            pass

    def __str__(self) -> str:  # pretty-print like src/error.jl:21-23
        return f"{self.args[0]} (code {self.code})"

    def Get_error_string(self) -> str:
        """The MPI_Error_string of this exception's error class — covers the
        standard table, the runtime-specific classes, and every
        tpu_mpi_torch.analyze diagnostic (whose codes project onto MPI classes via
        ``DIAGNOSTIC_CODES``)."""
        return Error_string(self.code)


class AbortError(MPIError):
    """Raised in every rank when the job is fate-shared down.

    The reference's ``MPI.Abort`` kills the whole job (src/environment.jl:252-254)
    and a single failing rank fails the run (test/runtests.jl:37-39). In the
    threaded host runtime, failure is propagated by raising this in every rank
    blocked in the runtime. ``code`` is the user's Abort errorcode when one was
    given, else ERR_ABORTED.
    """

    CODE = ERR_ABORTED


class DeadlockError(MPIError):
    """A blocking operation exceeded the runtime's deadlock timeout."""

    CODE = ERR_DEADLOCK


class LockOrderError(MPIError):
    """Two threads established inverted lock-acquisition order.

    Raised by the :mod:`tpu_mpi_torch.locksmith` witness (``TPU_MPI_LOCKCHECK=1``)
    the moment the global order graph gains a cycle — no thread has to
    actually deadlock for this to fire. The message carries both
    acquisition paths as file:line chains."""

    CODE = ERR_LOCK_ORDER


class TruncationError(MPIError):
    """Receive buffer smaller than the incoming message (MPI_ERR_TRUNCATE)."""

    CODE = ERR_TRUNCATE


class CollectiveMismatchError(MPIError):
    """Ranks of one communicator called different collectives in the same round.

    The reference has no such check (libmpi would hang or corrupt); SURVEY.md §5
    calls for a debug-mode sequence check — here it is always on, since the host
    rendezvous sees every call.
    """

    CODE = ERR_COLLECTIVE_MISMATCH


class InvalidCommError(MPIError):
    """Operation on COMM_NULL or a freed communicator."""

    CODE = ERR_COMM


class ProcFailedError(MPIError):
    """A peer process died while this rank was communicating with it.

    The ULFM MPI_ERR_PROC_FAILED analog: raised out of a blocked receive or a
    collective rendezvous when the failure detector (heartbeat timeout or a
    closed transport socket — docs/fault-tolerance.md) declares a peer of the
    operation dead, instead of hanging until the deadlock timeout. ``ranks``
    lists the world ranks known dead at raise time."""

    CODE = ERR_PROC_FAILED

    def __init__(self, msg: str = "peer process failed",
                 code: "int | None" = None,
                 ranks: "tuple[int, ...] | None" = None):
        super().__init__(msg, code=code)
        self.ranks = tuple(ranks) if ranks else ()


class RevokedError(MPIError):
    """The communicator was revoked (ULFM MPI_ERR_REVOKED analog).

    After ``Comm_revoke`` floods the group, every pending and future
    operation on the communicator raises this deterministically on every
    surviving rank; only ``Comm_shrink``/``Comm_agree`` remain legal."""

    CODE = ERR_REVOKED


class QuotaExceededError(MPIError):
    """A tenant's byte/op quota was exhausted (docs/serving.md).

    Raised by the broker's admission path — the op is REJECTED, never run,
    and never hangs. ``tenant`` names the offender; ``used``/``quota`` are
    byte counts at rejection time."""

    CODE = ERR_QUOTA

    def __init__(self, msg: str = "tenant quota exhausted",
                 code: "int | None" = None, tenant: "str | None" = None,
                 used: int = 0, quota: int = 0):
        super().__init__(msg, code=code)
        self.tenant = tenant
        self.used = int(used)
        self.quota = int(quota)


class ServeBusyError(MPIError):
    """Broker admission queue full for this tenant (docs/serving.md).

    The retriable backpressure status of the serve tier: nothing was
    admitted or charged; resubmitting after a backoff is always safe.
    ``retriable`` is True by construction so clients can branch on the
    attribute instead of the code."""

    CODE = ERR_SERVE_BUSY
    retriable = True

    def __init__(self, msg: str = "serve queue full, retry later",
                 code: "int | None" = None, tenant: "str | None" = None,
                 depth: int = 0):
        super().__init__(msg, code=code)
        self.tenant = tenant
        self.depth = int(depth)


class SLOExpiredError(MPIError):
    """A generation request's latency-SLO deadline expired before it could
    finish, and the inference scheduler evicted it (docs/serving.md
    "Inference engine"). Like :class:`ServeBusyError` this is retriable
    backpressure: the request was rolled back, nothing is half-generated on
    the wire, and resubmitting under lighter load is always safe.
    ``tenant``/``rid`` identify the evicted request; ``slo_ms`` is the
    deadline it missed."""

    CODE = ERR_SLO_EXPIRED
    retriable = True

    def __init__(self, msg: str = "generation SLO deadline expired",
                 code: "int | None" = None, tenant: "str | None" = None,
                 rid: "int | None" = None, slo_ms: int = 0):
        super().__init__(msg, code=code)
        self.tenant = tenant
        self.rid = rid
        self.slo_ms = int(slo_ms)


class PoolDegradedError(MPIError):
    """The serve pool lost ranks and this tenant's communicators span one
    (docs/serving.md "Degraded mode"). Retriable backpressure like
    :class:`ServeBusyError`: nothing was run or charged, surviving tenants
    whose communicators avoid the dead ranks keep streaming, and the
    autoscaler will re-spawn capacity and rebind the lease — resubmitting
    after a backoff is always safe. ``dead`` lists the world ranks known
    dead at rejection time; ``headroom`` is the healthy-rank count clients
    can still attach against."""

    CODE = ERR_POOL_DEGRADED
    retriable = True

    def __init__(self, msg: str = "serve pool degraded, retry later",
                 code: "int | None" = None, tenant: "str | None" = None,
                 dead: "tuple[int, ...] | None" = None, headroom: int = 0):
        super().__init__(msg, code=code)
        self.tenant = tenant
        self.dead = tuple(dead) if dead else ()
        self.headroom = int(headroom)


class SessionError(MPIError):
    """Session handshake or lease violation (docs/serving.md): bad session
    token, tenant limit reached, an op on a revoked lease, or a cid outside
    the leased namespace (cross-tenant cid use)."""

    CODE = ERR_SESSION


class AnalyzerError(MPIError):
    """A communication-correctness diagnostic escalated to an exception.

    Raised when tpu_mpi_torch.analyze findings are surfaced as errors; ``code``
    is the diagnostic's MPI error class (``diagnostic_error_code``), so
    ``Get_error_string`` describes the underlying defect class."""

    CODE = ERR_ANALYZE

    def __init__(self, msg: str = "analyzer diagnostic",
                 code: "int | None" = None, diag_code: "str | None" = None):
        if code is None and diag_code is not None:
            code = diagnostic_error_code(diag_code)
        super().__init__(msg, code=code)
        self.diag_code = diag_code


def Error_string(code: int) -> str:
    """Human-readable description of an error code (src/error.jl:11-19
    ``error_string``). Covers every code the package raises — the full MPI
    error-class table plus the runtime-specific classes."""
    return _ERROR_STRINGS.get(int(code), f"unknown MPI error code {code}")


# MPI-4 naming alias (mpi4py spells it Get_error_string on the module too).
Get_error_string = Error_string
