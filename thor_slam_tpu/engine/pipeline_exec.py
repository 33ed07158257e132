"""Pipelined tick execution: the pending queue + batched output fetching.

Extracted from :class:`TpuSlamEngine` (which keeps the tracking state
machine and dispatch): this object owns the in-flight tick records and
the discipline for getting their outputs back from the device without
ever paying more round trips than necessary. The engine hands it two
callables — ``fetch`` (materialize device outputs into the records) and
``finalize`` (run the host state machine over one fetched record) — so
the executor contains no SLAM logic at all.

The round-trip discipline (each host sync costs a host–device round trip):

* a tick's outputs start their device->host copies AT DISPATCH
  (``copy_to_host_async`` in the engine), so by the time the record is
  finalized the fetch usually reads a cached host value;
* finalizes batch: finalizing the oldest pending tick also finalizes, in
  the SAME round trip, every newer tick whose outputs are already ready;
* ``defer_sync`` never syncs mid-stream at all — one batched fetch over
  the whole stream at flush.
"""

from __future__ import annotations

from collections import deque
from typing import Callable


class PipelineExecutor:
    """In-flight tick records and their finalize order.

    Args:
        depth: Number of in-flight ticks before finalizes begin (pose
            latency in ticks).
        defer_sync: Never finalize mid-stream; :meth:`flush` fetches the
            whole stream's outputs in one transfer and replays them.
        fetch: ``fetch(records)`` materializes every record's device
            outputs in place (the engine's ``_fetch_records``). Looked up
            through this callable at call time, so profiling shims that
            wrap the engine method keep seeing every fetch.
        finalize: ``finalize(record)`` runs the host state machine over
            one fetched record and returns the pose (or None).
    """

    def __init__(
        self,
        depth: int,
        defer_sync: bool,
        fetch: Callable[[list[dict]], None],
        finalize: Callable[[dict], object],
    ) -> None:
        self.depth = max(1, int(depth))
        self.defer_sync = bool(defer_sync)
        self._fetch = fetch
        self._finalize = finalize
        self._q: deque[dict] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def clear(self) -> None:
        """Drop in-flight records without finalizing (reset/relocalize)."""
        self._q.clear()

    def submit(self, record: dict) -> None:
        self._q.append(record)

    @property
    def at_depth(self) -> bool:
        """True when the queue has reached the pipeline depth (the next
        submit should be preceded by a finalize)."""
        return len(self._q) >= self.depth

    def finalize_ready(self):
        """Finalize the oldest pending tick — and, in the SAME device
        round trip, every newer tick whose outputs are already computed.

        A host sync costs a host–device round trip; batching the fetches
        amortizes that across ``depth`` ticks instead of paying it per
        tick.
        """
        q = self._q
        take = 1
        while take < len(q) and q[take]["packed"].is_ready():
            take += 1
        records = [q.popleft() for _ in range(take)]
        self._fetch(records)
        pose = None
        for rec in records:
            pose = self._finalize(rec)
        return pose

    def drain(self):
        """Finalize every in-flight tick in order (stream flush).

        In ``defer_sync`` mode this is where the entire stream's outputs
        come back: one batched fetch over every deferred tick, then the
        host state machine replays them in order. Returns
        ``(last_pose, per_tick_poses)`` — ``per_tick_poses`` is only
        populated in defer_sync mode (the engine exposes it as
        ``last_flush_poses``), None otherwise.
        """
        if self.defer_sync and self._q:
            records = list(self._q)
            self._q.clear()
            self._fetch(records)
            pose = None
            poses = []
            for rec in records:
                pose = self._finalize(rec)
                poses.append(pose)
            return pose, poses
        pose = None
        while self._q:
            pose = self.finalize_ready()
        return pose, None
