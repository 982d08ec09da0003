"""Per-rank sidecar processes: a kill-able stand-in for rank death.

The thread tier cannot lose a rank to SIGKILL — ranks are threads of the
broker process and fate-share its address space. Chaos tooling still needs
a real OS-level kill to drive the elastic loop end to end, so each world
rank gets a trivial sidecar child process; a watcher polls them, and when
one dies (``kill -9`` from benchmarks/elastic_chaos.py, the CI ``elastic``
job, or an operator) it delivers exactly the verdict a heartbeat failure
detector would deliver for a process rank: ``on_death(rank)`` — which the
broker routes to :meth:`Broker.on_rank_failure`.

Opt-in via ``TPU_MPI_ELASTIC_SIDECARS`` (docs/configuration.md); a broker
embedded in tests usually injects failures by calling
``broker.on_rank_failure`` directly instead.
"""

from __future__ import annotations

import subprocess
import sys
import threading
from typing import Callable, Dict, Optional

from .. import locksmith


class RankSidecars:
    """One sleeping child process per world rank + a poller thread."""

    def __init__(self, ranks, on_death: Callable[[int], None],
                 poll_s: float = 0.05):
        self.on_death = on_death
        self.poll_s = float(poll_s)
        self._procs: Dict[int, subprocess.Popen] = {}
        self._reported: set = set()
        self._retired: set = set()
        self._lock = locksmith.make_lock("elastic.sidecars")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for r in ranks:
            self.spawn_for(r)

    def spawn_for(self, rank: int) -> int:
        """(Re)create the sidecar for a rank — also called for replacement
        ranks after a grow. Returns its pid."""
        p = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(10**9)"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        with self._lock:
            self._procs[rank] = p
            self._reported.discard(rank)
            self._retired.discard(rank)
        return p.pid

    def pid_of(self, rank: int) -> int:
        with self._lock:
            return self._procs[rank].pid

    def pids(self) -> Dict[int, int]:
        with self._lock:
            return {r: p.pid for r, p in self._procs.items()
                    if r not in self._retired}

    def retire(self, rank: int) -> None:
        """Administrative retire (idle scale-down): stop watching BEFORE
        terminating, so the watcher never mistakes it for a failure."""
        with self._lock:
            self._retired.add(rank)
            p = self._procs.get(rank)
        if p is not None and p.poll() is None:
            p.terminate()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._watch,
                                        name="elastic-sidecar-watch",
                                        daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                items = [(r, p) for r, p in self._procs.items()
                         if r not in self._reported
                         and r not in self._retired]
            for rank, p in items:
                if p.poll() is not None:
                    with self._lock:
                        self._reported.add(rank)
                    try:
                        self.on_death(rank)
                    except Exception:       # noqa: BLE001 - detector must live
                        pass
            self._stop.wait(self.poll_s)

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            procs = list(self._procs.values())
        for p in procs:
            if p.poll() is None:
                p.kill()
            try:
                p.wait(timeout=5)
            except Exception:               # noqa: BLE001 - shutdown best-effort
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
