"""Process-group leasing for the k-search's distributed fits.

``SubmeshPool`` leases per-worker process groups to the threaded
distributed-fit executor: each worker keeps ONE group for its lifetime —
a group is a worker-identity resource, not a function of the k being
evaluated. (The reference's ``make_wave_mesh`` and the LM's production
mesh helpers wait for the sharded planes and the train path.)
"""
from __future__ import annotations

import threading
from typing import Any, Sequence


class SubmeshPool:
    """Lease one process group per *worker* for the threaded distributed-fit path.

    The executor's workers are threads that each run one k-evaluation at a
    time on a dedicated group; the evaluate closure only sees the k, so the
    pool keys the lease on ``threading.get_ident()``. First touch assigns
    the next group round-robin; every later call from the same worker
    returns the same group. (Keying on k instead — e.g. ``groups[k % n]`` —
    lands two concurrent workers on the same group whenever their ks
    collide mod n, serializing the fits the groups exist to parallelize.)
    """

    def __init__(self, submeshes: Sequence[Any]):
        if not submeshes:
            raise ValueError("SubmeshPool needs at least one group")
        self.submeshes = list(submeshes)
        self._lock = threading.Lock()
        self._assign: dict[int, Any] = {}

    def acquire(self) -> Any:
        """The calling worker's group (assigned on first touch)."""
        ident = threading.get_ident()
        with self._lock:
            group = self._assign.get(ident)
            if group is None:
                group = self.submeshes[len(self._assign) % len(self.submeshes)]
                self._assign[ident] = group
            return group

    def assignments(self) -> dict[int, int]:
        """thread ident -> group index (introspection for tests/traces)."""
        with self._lock:
            index = {id(g): i for i, g in enumerate(self.submeshes)}
            return {t: index[id(g)] for t, g in self._assign.items()}
