"""Multi-process tier — the part the port's first slice reads.

The JAX package's module of the same name is the multi-process transport
(socket/shm channels, the ring, Rabenseifner and hierarchical runners). The
thread tier does not run it, but the collective-algorithm decision
(``collective._coll_select`` and ``tune.select``) reads its bulk threshold,
so only that knob lives here until the multi-process slice of the port
(ROADMAP Queue A item 9) brings the rest.
"""

from __future__ import annotations

import os

# Below this payload size the star rendezvous wins on latency (2 hops vs
# 2(P-1) ring steps); above it the ring's O(bytes/P) per-process traffic wins.
_RING_MIN_BYTES = int(os.environ.get("TPU_MPI_RING_MIN_BYTES", str(64 * 1024)))
