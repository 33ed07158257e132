"""Host->device transfer pipelining.

The reference's equivalent is the camera ASIC dataflow + XLink queues
(SURVEY.md §2.4): the host only drains output queues. Here the host stages
each rig tick as ONE dense array and ships it while the previous tick is
still being tracked — `jax.device_put` is asynchronous, and a one-slot
pipeline keeps staging (numpy stacking, uint8->float conversion) off the
critical path.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

import jax
import numpy as np


class DoubleBufferedUploader:
    """Overlap host staging + upload of tick T+1 with compute of tick T.

    Usage::

        up = DoubleBufferedUploader(stage_fn=lambda fs: stack(fs))
        up.submit(frame_set_0)
        while running:
            up.submit(frame_set_k)        # starts staging/upload of tick k
            images = up.get()              # device array of tick k-1
            state, out = step(state, images)
    """

    def __init__(self, stage_fn: Callable[[Any], np.ndarray], device=None) -> None:
        self._stage_fn = stage_fn
        self._device = device  # None: the caller's default device
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="uploader")
        self._pending: Future | None = None

    def submit(self, item: Any) -> None:
        """Queue the next tick for host staging (non-blocking).

        Only the HOST staging (numpy stacking) runs on the worker thread.
        The ``device_put`` itself happens on the caller's thread in
        :meth:`get`, so it lands on the caller's default device, and
        ``device_put`` is asynchronous anyway, so the caller loses nothing.
        uint8 ships as-is: the consumer normalizes on device (4x smaller
        transfer, no multi-MB host float conversion).
        """
        if self._pending is not None and not self._pending.done():
            # The consumer is behind; finish the in-flight staging first.
            self._pending.result()
        self._pending = self._pool.submit(self._stage_fn, item)

    def get(self):
        """The device array for the most recently submitted tick."""
        if self._pending is None:
            raise RuntimeError("submit() must be called before get()")
        return jax.device_put(self._pending.result(), self._device)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
