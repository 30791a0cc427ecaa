"""Host->device input pipelining (port of llavamod_tpu/runtime/prefetch.py).

`DevicePrefetcher` wraps a host batch iterator (dicts of numpy arrays) and
keeps `depth` batches on their way to the device: on the card each array is
copied into pinned host memory and sent with a `non_blocking` copy on a side
stream, so batch N+1 travels while step N runs; the compute stream waits on
the copy's event before it reads the batch.  On the CPU the arrays become
tensors as they are.  Under torch.distributed each process has one card
and its loader yields the rank's own rows, so the rank's batch goes to
its `device` (cuda:$LOCAL_RANK) the same way.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch


class DevicePrefetcher:
    def __init__(self, batches: Iterable[Dict[str, Any]], *, device="cuda",
                 depth: int = 2):
        self._it = iter(batches)
        self._device = torch.device(device)
        self._depth = max(1, depth)
        self._queue: collections.deque = collections.deque()
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)

    def _send(self, batch: Dict[str, Any], non_blocking: bool):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not non_blocking:
            return host
        return {k: v.pin_memory().to(self._device, non_blocking=True)
                for k, v in host.items()}

    def _put(self, batch: Dict[str, Any]):
        if self._stream is None:
            return self._send(batch, False), None
        with torch.cuda.stream(self._stream):
            out = self._send(batch, True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _fill(self):
        while len(self._queue) < self._depth:
            try:
                batch = next(self._it)
            except StopIteration:
                return
            self._queue.append(self._put(batch))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        self._fill()
        while self._queue:
            out, done = self._queue.popleft()
            if done is not None:
                current = torch.cuda.current_stream(self._device)
                current.wait_event(done)
                for v in out.values():
                    # the side stream allocated it; the compute stream uses it
                    v.record_stream(current)
            self._fill()
            yield out
