"""Unified configuration: environment variables + persisted TOML preferences.

Reference: MPI.jl deps/build.jl:14-58 reads ``JULIA_MPI_*`` env vars
and persists them to ``~/.julia/prefs/MPI.toml``; runtime knobs
(JULIA_MPIEXEC_ARGS, JULIA_MPI_TEST_*) stay env-only. The TPU analog is one
module owning every knob: the backend choice (real TPU vs CPU-sim), mesh/sim
device count, multi-process coordinator address, and timeouts — consulted by
the launcher, the runtime, and the multi-process backend instead of ad-hoc
``os.environ`` reads scattered per file.

Precedence per key: explicit function argument > ``TPU_MPI_*`` env var >
persisted TOML (``~/.config/tpu_mpi/config.toml`` or ``$TPU_MPI_CONFIG``) >
built-in default.

The port keeps the JAX package's knob names as they are — every
``TPU_MPI_*`` variable and the same persisted TOML — so one environment
configures both packages. Knobs of tiers the port has not reached yet
(mesh, multi-process, serve) are read but have no effect here.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, fields
from typing import Any, Optional

from . import error as _ec
from .error import MPIError

_DEFAULT_TOML = os.path.join("~", ".config", "tpu_mpi", "config.toml")


@dataclass
class Config:
    """Every knob the framework consults, with its default."""

    # backend selection (build.jl:60-138 binary/ABI choice analog):
    # "auto" = use whatever jax.devices() yields; "cpu-sim" forces fake XLA
    # CPU devices; "tpu" requires a real TPU and errors otherwise.
    backend: str = "auto"
    # CPU-sim substrate size (xla_force_host_platform_device_count).
    sim_devices: int = 8
    # default world size for tpurun when -n is not given (0 = #devices).
    nprocs: int = 0
    # multi-process tier: coordinator address ("host:port") for joining an
    # existing rendezvous (multi-host launch), "" = launcher-local.
    coordinator: str = ""
    # interface the coordinator binds ("127.0.0.1" single-host; "0.0.0.0"
    # to serve a real cluster over DCN).
    coordinator_bind: str = "127.0.0.1"
    # address remote hosts dial for the coordinator ("" = the bind address,
    # or the hostname when binding 0.0.0.0).
    coordinator_advertise: str = ""
    # seconds a blocking wait may stall before DeadlockError.
    deadlock_timeout: float = 60.0
    # seconds a child waits for the world address map at rendezvous.
    rendezvous_timeout: float = 600.0
    # max native-transport frame size (corrupt-stream guard), bytes.
    max_frame_bytes: int = 1 << 31
    # multi-process tier: array payloads at least this large travel between
    # same-host ranks through one-shot POSIX shm segments instead of the TCP
    # stream (the libmpi shared-memory-BTL analog); 0 disables the shm lane.
    shm_min_bytes: int = 1 << 18
    # host-path overlap engine (docs/performance.md "Overlap engine"):
    # payloads at least this large are chunk-pipelined through the
    # transfer / reduce-combine stages instead of moving monolithically;
    # 0 disables pipelining entirely.
    pipeline_min_bytes: int = 1 << 20
    # number of chunks a pipelined payload splits into (clamped to at
    # least 2 when pipelining engages; the last chunk absorbs remainders).
    pipeline_chunks: int = 4
    # strict mode: poison batched-read RMA origins (Get / Fetch_and_op
    # results inside a deferred lock epoch) with a sentinel until the
    # closing synchronization, so a caller consuming them mid-epoch —
    # undefined behavior per MPI — fails loudly instead of reading stale
    # bytes (docs/performance.md "Batched read epochs").
    strict: bool = False
    # blocking-send flow control: a Send/send blocks while the destination's
    # unexpected queue holds more than this many bytes (the rendezvous-
    # protocol analog; Isend keeps buffered semantics). 0 disables.
    send_highwater_bytes: int = 1 << 26
    # debug mode (SURVEY §5 race detection): stamp every P2P message with a
    # per-(sender, dest, cid) sequence number and fail loudly on any
    # reordering/duplication/loss at delivery.
    debug_sequence_check: bool = False
    # fused multi-operand reduction fold (kernels.fused_reduce) in the
    # collective fold paths: "off" = always the chained PyTorch fold (the
    # user's explicit off switch); any other value ("auto", and "interp",
    # which the JAX package reads) = the CUDA kernel on CUDA tensors and
    # its plain version on CPU tensors.
    fused_fold: str = "auto"
    # communication-event tracing (tpu_mpi_torch.analyze, docs/analysis.md):
    # record per-rank event ring buffers consumed by the cross-rank trace
    # verifier, the RMA race detector, and the DeadlockError dump of
    # per-rank pending operations + the wait-for cycle.
    trace: bool = False
    # per-rank event ring-buffer capacity while tracing is on.
    trace_buffer: int = 4096
    # request-scoped distributed tracing (docs/observability.md "Request
    # traces"): fraction of serve-session ops that mint a trace context
    # (trace_id + span parenting carried in frame metadata through router,
    # front door, fair queue and per-rank phase spans). 0.0 (default)
    # disables span recording entirely — ops carry no trace metadata and
    # the hot path stays one generation-gated check. 1.0 samples all.
    trace_sample: float = 0.0
    # crash flight recorder (docs/observability.md "Flight recorder"):
    # capacity of the always-on per-process ring of recent spans and
    # typed-error/lifecycle events, auto-dumped on fatal errors and
    # SIGTERM. 0 disables the recorder (and the auto-dump hooks).
    flight_ring: int = 256
    # directory flight-recorder auto-dumps are written into
    # ("flight-<pid>-<reason>.json", CRC-stamped); "" = the system temp dir.
    flight_dir: str = ""
    # fleet-wide serve SLO (docs/observability.md "SLO burn-rate"): the
    # per-op latency objective in microseconds applied to every tenant
    # without an explicit Ledger.set_objective; at most 1% of a tenant's
    # ops may take this long or longer before its burn rate crosses 1.0
    # (an elastic grow signal). 0 = no objective.
    serve_slo_us: int = 0
    # path PREFIX for per-rank trace dumps written at Finalize (one
    # ``<prefix>.rank<N>.trace.json`` per rank); consumed offline by
    # ``python -m tpu_mpi_torch.analyze explore``. "" = no dump.
    trace_dump: str = ""
    # collective algorithm layer (tpu_mpi_torch.tune, docs/performance.md
    # "Algorithm selection"): path of a measured tuning table written by
    # ``tpurun --tune``; "" = use the built-in heuristic crossovers.
    tune_table: str = ""
    # force-override for debugging/CI: comma list of collective=algorithm
    # pins (e.g. "allreduce=rdouble,barrier=star"), clamped by per-
    # algorithm eligibility; "" = no override.
    coll_algo: str = ""
    # online bandit autotuner (tpu_mpi_torch.tune_online, docs/performance.md
    # "Online tuning"): fraction of live collective calls routed to an
    # eligible alternate algorithm for measurement (epsilon-greedy over a
    # shared deterministic schedule so every rank explores the same arm on
    # the same call). 0.0 disables the loop entirely — the default.
    tune_explore: float = 0.0
    # minimum observations a (coll, algo, nbytes) cell needs before it may
    # set a crossover (noise guard for `tune --from-pvars`, fleet merges,
    # and the online loop's hot-swap).
    tune_min_samples: int = 8
    # online loop: recompute + hot-swap the crossover table every this many
    # algorithm decisions per communicator (a lockstep internal round
    # merges per-rank arm stats so every rank derives the same table).
    tune_swap_period: int = 256
    # seed of the shared deterministic exploration schedule (every rank
    # must use the same value — it's part of the lockstep contract).
    tune_seed: int = 0
    # fleet tuning database written by `python -m tpu_mpi_torch.tune merge`
    # (schema 2: sample-weighted merge of per-rank pvar dumps + measured
    # tables). Consulted by select() after tune_table, before the
    # heuristic; "" = no database layer.
    tune_db: str = ""
    # test/debug latency shim: comma list of coll:algo=microseconds added
    # to the measured op span (e.g. "allreduce:star=2000" slows the star
    # arm) so bandit convergence is deterministic under test; "" = off.
    tune_shim: str = ""
    # same-host shared-memory collective fold (the libmpi coll/sm analog):
    # Allreduce payloads strictly below this many bytes — and Barrier —
    # use one mmap'd /dev/shm segment per communicator instead of O(P)
    # transport messages when all ranks share a host; 0 disables the lane.
    coll_shm_max_bytes: int = 1 << 16
    # registered-buffer fast path (docs/performance.md "Registered
    # buffers"): persistent collectives (Allreduce_init + Start/Wait)
    # pre-pin their wire views and fold scratch at plan creation and run
    # each round allocation-free on the calling thread; off = every round
    # takes the generic per-call path (parse, plan lookup, worker hop).
    registered_buffers: bool = True
    # auto-arming (docs/performance.md "Auto-arming"): plain repeated
    # same-signature collectives (the training-loop `comm.Allreduce(x)`
    # case) are transparently promoted onto the registered persistent path
    # after `auto_arm_threshold` identical calls — no `Allreduce_init`
    # required. Results keep copy-out semantics (bitwise-identical to the
    # generic path, never aliased). Off = only hand-armed persistent
    # requests take the registered path.
    auto_arm: bool = True
    # consecutive identical calls (same comm, op, buffer objects, count,
    # dtype) before a signature auto-arms.
    auto_arm_threshold: int = 4
    # explicit donation opt-in for the AUTO-armed lane: allocating-flavor
    # results are handed out as the registered fold slot itself (zero
    # copy-out) — round k's result is re-donated by round k+2, so holding
    # a result across two later calls reads in-flight data (the R302
    # hazard the race detector models). Off (default) = copy-out.
    auto_arm_donate: bool = False
    # batched submission (docs/performance.md "Batched submission"): max
    # queued ops (chunk frames of one collective, or a Waitall run of
    # armed persistent rounds) coalesced into ONE rendezvous round trip —
    # one writev scatter-gather frame on the native transport, one
    # condvar wakeup on the thread tier. <=1 disables coalescing.
    batch_max_ops: int = 16
    # byte budget per coalesced flush: a batch frame closes early once its
    # payloads reach this size. 0 = no byte cap (count cap only).
    batch_max_bytes: int = 1 << 22
    # performance-variable (pvar) collection level (docs/observability.md):
    # 0 disables every counter (one branch per op remains), 1 collects.
    # Pcontrol(level) overrides this at runtime without a config reload.
    pvars: int = 1
    # directory for per-rank pvar dumps at Finalize / Pcontrol(>=2):
    # each rank writes pvars-rank<R>.json there; "" = no dump.
    pvars_dump: str = ""
    # per-collective latency histogram width (log2-microsecond buckets):
    # bucket i counts ops with latency in [2^(i-1), 2^i) us.
    pvars_hist_bins: int = 24
    # fault tolerance (docs/fault-tolerance.md): heartbeat period in
    # milliseconds on the native-transport poll loop. 0 (the default)
    # disables the failure detector entirely — the fault path is strictly
    # pay-for-use; fate-sharing semantics are unchanged.
    heartbeat_ms: int = 0
    # milliseconds of heartbeat silence before a peer is declared dead
    # (ProcFailedError). 0 derives 10x heartbeat_ms (min 1000 ms).
    failure_timeout_ms: int = 0
    # deadline for any single blocking recv / request Wait, milliseconds:
    # past it the op raises DeadlockError with the per-rank pending-op dump
    # even when the global deadlock_timeout is longer. 0 disables (default).
    op_timeout_ms: int = 0
    # multi-tenant serve tier (docs/serving.md): the well-known socket the
    # broker listens on and clients attach to. A value containing "/" is a
    # Unix-domain socket path; otherwise "host:port" TCP. "" = the broker
    # picks a loopback TCP port and prints it.
    serve_socket: str = ""
    # max concurrently-leased tenants the broker admits; attach past the
    # limit fails with a typed SessionError instead of queueing.
    serve_max_tenants: int = 8
    # per-tenant traffic quota, bytes moved through collectives (charged at
    # admission): past it ops are REJECTED with QuotaExceededError, never
    # hung. 0 = unlimited.
    serve_quota_bytes: int = 0
    # shared secret a client must present in the session handshake; "" (the
    # default) means the broker accepts any token — loopback/dev mode.
    session_token: str = ""
    # serve pool backend (docs/serving.md "Scale-out"): "threads" = rank
    # threads inside the broker process on one warm thread-tier world;
    # "procs" = OS-process ranks over the framed native transport, spawned
    # through the launcher rendezvous and driven by per-rank control
    # sockets (the production backend — survives rank SIGKILL, no shared
    # GIL with the broker loop).
    serve_backend: str = "threads"
    # multi-broker scale-out: comma list of broker sockets the router
    # shards tenants across (and `tpurun --serve --stats` merges).
    serve_brokers: str = ""
    # this broker's disjoint cid-range shard as "index/count" (e.g. "0/2");
    # "" = the whole namespace range (single-broker). Each shard carves
    # tenant cid namespaces from a disjoint base so N brokers can front
    # one fleet without cid collisions (serve/ledger.py CidShard).
    serve_shard: str = ""
    # zero-copy frame path: OP payload views are scatter-gather written
    # (socket sendmsg) straight from the session recv buffer to the rank
    # mailbox — no intermediate marshal; off = the legacy join+copy path
    # (the before/after comparison lane in benchmarks/serve_scale_sweep.py).
    serve_zerocopy: bool = True
    # socket the scale-out router (`tpurun --serve --router`) listens on;
    # same spec grammar as serve_socket, "" = pick a loopback TCP port.
    serve_router_socket: str = ""
    # router session handling: "splice" proxies every byte through the
    # router (clients need only its address); "redirect" answers HELLO
    # with the tenant's home broker so the data path goes direct.
    serve_router_mode: str = "splice"
    # session transport at the broker's front door (docs/serving.md "Front
    # door"): "events" multiplexes every attached session socket on one
    # edge-triggered readiness loop with a fixed worker pool (idle sockets
    # cost zero threads — the C10k path); "threads" is the legacy
    # one-handler-thread-per-connection front door, kept for A/B and as
    # the conservative fallback.
    serve_transport: str = "events"
    # size of the event-driven front door's worker pool: how many session
    # frames can be in service at once (attaches, collectives waiting on
    # the pool, stats probes). Sockets scale independently of this.
    serve_workers: int = 8
    # recv-lease window, bytes: inbound OP payloads at or under this size
    # land zero-copy in a registered buffer recycled across frames (the
    # inbound mirror of serve_zerocopy's sendmsg path); larger payloads
    # fall back to a per-frame exact-size buffer (a lease miss, counted).
    serve_lease_window: int = 1 << 16
    # inference engine (docs/serving.md "Inference engine"): per-request
    # latency SLO in milliseconds — a generation request whose deadline
    # expires before it finishes is EVICTED with a typed retriable
    # SLOExpiredError rather than hung. 0 = no deadline.
    infer_slo_ms: int = 0
    # max concurrently-decoding sessions per continuous-batching step; also
    # the per-expert routing capacity so admitted tokens are never dropped.
    infer_max_batch: int = 8
    # KV-cache paged-block granularity in tokens; also the partition size
    # for cross-stage prefill streaming over Psend_init/Precv_init.
    kv_block_tokens: int = 16
    # decode fast path (docs/serving.md "Decode fast path"): batch every
    # co-scheduled request's token rows into ONE MoE dispatch/combine per
    # layer round instead of one round per prefill partition per request.
    # Bitwise-identical outputs (row-wise math); off = the row-loop
    # baseline, kept for A/B lanes in benchmarks/infer_sweep.py.
    infer_vectorized: bool = True
    # speculative multi-token decode: draft up to k tokens per request per
    # step from the session's own history, verify in one batched pass and
    # accept the greedy-matching prefix. <= 1 = off (the k=1 baseline).
    # Greedy acceptance keeps output streams bitwise identical to k=1.
    infer_spec_k: int = 0
    # per-step prefill token budget: a prompt longer than this is split
    # across consecutive StepPlans so one giant prefill cannot
    # head-of-line-block co-batched decodes. 0 = off (whole prompt in one
    # step). The chunk boundaries ride in the rank-uniform plan.
    infer_prefill_chunk: int = 0
    # cross-tenant KV prefix sharing: content-hash full prompt-prefix
    # blocks in the paged KV cache, refcounted + copy-on-write, so
    # requests sharing a system prompt reuse physical KV blocks and skip
    # recomputing the shared prefix. Tenants only ever match prefixes of
    # tokens they themselves presented (admission-layer isolation).
    kv_prefix_share: bool = False
    # LRU bound on the persistent-collective plan cache AND the auto-arm
    # signature table (the auto table is capped at max(8, this // 4)) —
    # the shape-churn pressure guard; evictions are counted in the pvar
    # plan-cache block. Minimum 8.
    plan_cache_max: int = 128
    # hierarchical collectives (docs/performance.md "Hierarchical
    # collectives"): emulated domain count for the two-level runners.
    # 0 (default) derives domains from the rendezvous address table (one
    # domain per distinct host); k >= 2 partitions every communicator
    # into k contiguous equal blocks — the cpu-sim way to exercise the
    # multi-host split on one machine.
    domains: int = 0
    # byte floor for the heuristic to prefer the two-level "hier"
    # composite on multi-domain worlds (measured tables override).
    hier_min_bytes: int = 4096
    # training tier (docs/training.md): gradient-bucket capacity in bytes
    # for the DDP backward pass — gradients pack into size-bounded
    # buckets (reverse-layer order) and each bucket rides one persistent
    # Allreduce, so the knob trades per-op overhead (small buckets)
    # against overlap opportunity (a single huge bucket cannot overlap).
    train_bucket_bytes: int = 1 << 20
    # ZeRO-style sharded-state mode: partition optimizer state and flat
    # master params 1/nranks (Reduce_scatter the grad, Allgather the
    # updated params) instead of replicating them per rank.
    train_shard_state: bool = False
    # elastic capacity (docs/fault-tolerance.md "Elastic recovery"):
    # enables the broker-side autoscaler loop that re-spawns ranks after a
    # failure and grows/retires capacity from the load signals the broker
    # already records (queue depth, busy-rejection rate, SLO hit rate).
    elastic: bool = False
    # pool-size floor the autoscaler will never retire below.
    elastic_min_ranks: int = 1
    # pool-size ceiling for pressure-driven growth; 0 = the starting size
    # (failure replacement always restores to the pre-failure target).
    elastic_max_ranks: int = 0
    # autoscaler tick interval.
    elastic_interval_ms: int = 200
    # refractory period after any resize before the next one may start.
    elastic_cooldown_ms: int = 2000
    # consecutive over/under-threshold ticks before a resize fires
    # (hysteresis — one noisy sample never resizes the pool).
    elastic_hysteresis: int = 3
    # queued-op depth across tenants that counts as growth pressure.
    elastic_depth_high: int = 16
    # consecutive idle ticks before a spare rank is retired; 0 = never.
    elastic_idle_ticks: int = 0
    # per-rank sidecar watchdog processes: SIGKILLing a sidecar declares
    # its rank failed (the chaos hook for the thread-tier pool, where rank
    # threads cannot be killed individually).
    elastic_sidecars: bool = False
    # runtime lock witness (tpu_mpi_torch.locksmith): swap every named lock
    # construction site for a LockWitness that maintains the global
    # acquisition-order graph and raises LockOrderError on inversion.
    # Pay-for-use: off means plain threading primitives, zero overhead.
    lockcheck: bool = False
    # record full acquisition stacks (not just the caller's site) in
    # witness reports — costlier, for post-mortem dumps.
    lockcheck_stacks: bool = False

    def replace(self, **kw: Any) -> "Config":
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d.update({k: v for k, v in kw.items() if v is not None})
        return Config(**d)


_ENV_MAP = {
    "backend": "TPU_MPI_BACKEND",
    "sim_devices": "TPU_MPI_SIM_DEVICES",
    "nprocs": "TPU_MPI_NPROCS",
    "coordinator": "TPU_MPI_PROC_COORD",
    "coordinator_bind": "TPU_MPI_COORD_BIND",
    "coordinator_advertise": "TPU_MPI_COORD_ADVERTISE",
    "deadlock_timeout": "TPU_MPI_DEADLOCK_TIMEOUT",
    "rendezvous_timeout": "TPU_MPI_RENDEZVOUS_TIMEOUT",
    "max_frame_bytes": "TPU_MPI_MAX_FRAME_BYTES",
    "shm_min_bytes": "TPU_MPI_SHM_MIN_BYTES",
    "pipeline_min_bytes": "TPU_MPI_PIPELINE_MIN_BYTES",
    "pipeline_chunks": "TPU_MPI_PIPELINE_CHUNKS",
    "strict": "TPU_MPI_STRICT",
    "send_highwater_bytes": "TPU_MPI_SEND_HIGHWATER_BYTES",
    "debug_sequence_check": "TPU_MPI_DEBUG_SEQUENCE",
    "fused_fold": "TPU_MPI_FUSED_FOLD",
    "trace": "TPU_MPI_TRACE",
    "trace_buffer": "TPU_MPI_TRACE_BUFFER",
    "trace_sample": "TPU_MPI_TRACE_SAMPLE",
    "flight_ring": "TPU_MPI_FLIGHT_RING",
    "flight_dir": "TPU_MPI_FLIGHT_DIR",
    "serve_slo_us": "TPU_MPI_SERVE_SLO_US",
    "trace_dump": "TPU_MPI_TRACE_DUMP",
    "tune_table": "TPU_MPI_TUNE_TABLE",
    "coll_algo": "TPU_MPI_COLL_ALGO",
    "tune_explore": "TPU_MPI_TUNE_EXPLORE",
    "tune_min_samples": "TPU_MPI_TUNE_MIN_SAMPLES",
    "tune_swap_period": "TPU_MPI_TUNE_SWAP_PERIOD",
    "tune_seed": "TPU_MPI_TUNE_SEED",
    "tune_db": "TPU_MPI_TUNE_DB",
    "tune_shim": "TPU_MPI_TUNE_SHIM",
    "coll_shm_max_bytes": "TPU_MPI_COLL_SHM_MAX_BYTES",
    "registered_buffers": "TPU_MPI_REGISTERED_BUFFERS",
    "auto_arm": "TPU_MPI_AUTO_ARM",
    "auto_arm_threshold": "TPU_MPI_AUTO_ARM_THRESHOLD",
    "auto_arm_donate": "TPU_MPI_AUTO_ARM_DONATE",
    "batch_max_ops": "TPU_MPI_BATCH_MAX_OPS",
    "batch_max_bytes": "TPU_MPI_BATCH_MAX_BYTES",
    "pvars": "TPU_MPI_PVARS",
    "pvars_dump": "TPU_MPI_PVARS_DUMP",
    "pvars_hist_bins": "TPU_MPI_PVARS_HIST_BINS",
    "heartbeat_ms": "TPU_MPI_HEARTBEAT_MS",
    "failure_timeout_ms": "TPU_MPI_FAILURE_TIMEOUT_MS",
    "op_timeout_ms": "TPU_MPI_OP_TIMEOUT_MS",
    "serve_socket": "TPU_MPI_SERVE_SOCKET",
    "serve_max_tenants": "TPU_MPI_SERVE_MAX_TENANTS",
    "serve_quota_bytes": "TPU_MPI_SERVE_QUOTA_BYTES",
    "session_token": "TPU_MPI_SESSION_TOKEN",
    "serve_backend": "TPU_MPI_SERVE_BACKEND",
    "serve_brokers": "TPU_MPI_SERVE_BROKERS",
    "serve_shard": "TPU_MPI_SERVE_SHARD",
    "serve_zerocopy": "TPU_MPI_SERVE_ZEROCOPY",
    "serve_router_socket": "TPU_MPI_SERVE_ROUTER_SOCKET",
    "serve_router_mode": "TPU_MPI_SERVE_ROUTER_MODE",
    "serve_transport": "TPU_MPI_SERVE_TRANSPORT",
    "serve_workers": "TPU_MPI_SERVE_WORKERS",
    "serve_lease_window": "TPU_MPI_SERVE_LEASE_WINDOW",
    "infer_slo_ms": "TPU_MPI_INFER_SLO_MS",
    "infer_max_batch": "TPU_MPI_INFER_MAX_BATCH",
    "kv_block_tokens": "TPU_MPI_KV_BLOCK_TOKENS",
    "infer_vectorized": "TPU_MPI_INFER_VECTORIZED",
    "infer_spec_k": "TPU_MPI_INFER_SPEC_K",
    "infer_prefill_chunk": "TPU_MPI_INFER_PREFILL_CHUNK",
    "kv_prefix_share": "TPU_MPI_KV_PREFIX_SHARE",
    "plan_cache_max": "TPU_MPI_PLAN_CACHE_MAX",
    "domains": "TPU_MPI_DOMAINS",
    "hier_min_bytes": "TPU_MPI_HIER_MIN_BYTES",
    "train_bucket_bytes": "TPU_MPI_TRAIN_BUCKET_BYTES",
    "train_shard_state": "TPU_MPI_TRAIN_SHARD_STATE",
    "elastic": "TPU_MPI_ELASTIC",
    "elastic_min_ranks": "TPU_MPI_ELASTIC_MIN_RANKS",
    "elastic_max_ranks": "TPU_MPI_ELASTIC_MAX_RANKS",
    "elastic_interval_ms": "TPU_MPI_ELASTIC_INTERVAL_MS",
    "elastic_cooldown_ms": "TPU_MPI_ELASTIC_COOLDOWN_MS",
    "elastic_hysteresis": "TPU_MPI_ELASTIC_HYSTERESIS",
    "elastic_depth_high": "TPU_MPI_ELASTIC_DEPTH_HIGH",
    "elastic_idle_ticks": "TPU_MPI_ELASTIC_IDLE_TICKS",
    "elastic_sidecars": "TPU_MPI_ELASTIC_SIDECARS",
    "lockcheck": "TPU_MPI_LOCKCHECK",
    "lockcheck_stacks": "TPU_MPI_LOCKCHECK_STACKS",
}

_lock = threading.Lock()
_cached: Optional[Config] = None


def _toml_path() -> str:
    return os.path.expanduser(os.environ.get("TPU_MPI_CONFIG", _DEFAULT_TOML))


def _parse_mini_toml(text: str) -> dict:
    """Vendored minimal TOML reader for Python < 3.11 without tomli: flat
    ``key = value`` pairs with string/bool/int/float values — exactly the
    subset :func:`persist` writes. Tables, arrays and multi-line strings are
    out of scope and rejected loudly rather than misread."""
    out: dict[str, Any] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            raise ValueError(f"line {lineno}: TOML tables are not supported "
                             "by the vendored reader (install tomli)")
        if "=" not in line:
            raise ValueError(f"line {lineno}: expected 'key = value'")
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if not key:
            raise ValueError(f"line {lineno}: empty key")
        if val.startswith('"'):
            if len(val) < 2 or not val.endswith('"'):
                raise ValueError(f"line {lineno}: unterminated string")
            body = val[1:-1]
            # unescape the two sequences persist() emits (plus common ones)
            out[key] = (body.replace('\\"', '"').replace("\\\\", "\\")
                        .replace("\\n", "\n").replace("\\t", "\t"))
        elif val in ("true", "false"):
            out[key] = val == "true"
        else:
            # strip an inline comment on non-string values
            val = val.split("#", 1)[0].strip()
            try:
                out[key] = int(val)
            except ValueError:
                out[key] = float(val)   # ValueError propagates to the caller
    return out


def _read_toml(path: str) -> dict:
    try:
        import tomllib as _toml              # py>=3.11
    except ImportError:
        try:
            import tomli as _toml            # the PyPI backport, if present
        except ImportError:
            _toml = None
    if _toml is not None:
        try:
            with open(path, "rb") as f:
                return _toml.load(f)
        except FileNotFoundError:
            return {}
        except Exception as e:
            raise MPIError(f"malformed config file {path!r}: {e}") from None
    # py3.10 without tomli: the vendored flat-key reader
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except FileNotFoundError:
        return {}
    try:
        return _parse_mini_toml(text)
    except Exception as e:
        raise MPIError(f"malformed config file {path!r}: {e}") from None


def _coerce(name: str, default: Any, raw: Any) -> Any:
    kind = type(default)
    try:
        if kind is bool:
            s = str(raw).lower()
            if s in ("1", "true", "yes", "on"):
                return True
            if s in ("0", "false", "no", "off", ""):
                return False
            raise ValueError(s)
        return kind(raw)
    except (TypeError, ValueError):
        raise MPIError(f"config key {name}={raw!r} is not a valid {kind.__name__}",
                       code=_ec.ERR_ARG) from None


def _validate(cfg: Config) -> None:
    """Range checks for knobs whose type coercion alone cannot catch a
    value that would corrupt downstream state (histogram shapes, ring
    sizes, sampling probabilities). Same loud-failure contract as
    :func:`_coerce`: a bad knob raises ERR_ARG at load, never later."""
    if not (0.0 <= cfg.trace_sample <= 1.0):
        raise MPIError(
            f"config key trace_sample={cfg.trace_sample!r} must be a "
            f"probability in [0.0, 1.0]", code=_ec.ERR_ARG)
    if cfg.flight_ring < 0:
        raise MPIError(
            f"config key flight_ring={cfg.flight_ring!r} must be >= 0 "
            f"(0 disables the flight recorder)", code=_ec.ERR_ARG)
    if cfg.pvars_hist_bins < 1:
        raise MPIError(
            f"config key pvars_hist_bins={cfg.pvars_hist_bins!r} must be "
            f">= 1 (one log2-microsecond bucket minimum)", code=_ec.ERR_ARG)
    if cfg.serve_slo_us < 0:
        raise MPIError(
            f"config key serve_slo_us={cfg.serve_slo_us!r} must be >= 0 "
            f"(0 disables the fleet SLO)", code=_ec.ERR_ARG)


# Bumped whenever the effective config is (re)computed; hot-path callers
# (``_runtime.deadlock_timeout``) key their caches on it so a
# ``load(refresh=True)`` invalidates them without taking the lock per call.
GENERATION = 0


def load(refresh: bool = False) -> Config:
    """The effective configuration (cached after first read)."""
    global _cached, GENERATION
    with _lock:
        if _cached is not None and not refresh:
            return _cached
        GENERATION += 1
        cfg = Config()
        file_vals = _read_toml(_toml_path())
        merged: dict[str, Any] = {}
        for f in fields(Config):
            raw = os.environ.get(_ENV_MAP[f.name])
            if raw is None and f.name in file_vals:
                raw = file_vals[f.name]
            if raw is not None:
                merged[f.name] = _coerce(f.name, getattr(cfg, f.name), raw)
        effective = cfg.replace(**merged)
        _validate(effective)          # raise BEFORE caching a bad config
        _cached = effective
        return _cached


def persist(path: Optional[str] = None, **overrides: Any) -> str:
    """Write the current effective config (plus overrides) as TOML — the
    analog of build.jl persisting JULIA_MPI_* into ~/.julia/prefs/MPI.toml.
    Returns the written path."""
    cfg = load().replace(**overrides)
    path = os.path.expanduser(path or _toml_path())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lines = []
    for f in fields(Config):
        v = getattr(cfg, f.name)
        if isinstance(v, str):
            sv = '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
        elif isinstance(v, bool):
            sv = "true" if v else "false"
        else:
            sv = repr(v)
        lines.append(f"{f.name} = {sv}")
    with open(path, "w") as fh:
        fh.write("# tpu_mpi_torch persisted preferences (see tpu_mpi_torch.config)\n")
        fh.write("\n".join(lines) + "\n")
    load(refresh=True)
    return path


def get(name: str) -> Any:
    """One config value by key name."""
    cfg = load()
    if not hasattr(cfg, name):
        raise MPIError(f"unknown config key {name!r}", code=_ec.ERR_ARG)
    return getattr(cfg, name)
