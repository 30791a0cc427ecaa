"""Host data loading: dataset + sampler + collator -> batch iterator.

The port's own copy of llavamod_tpu/train/loader.py (`DataLoader`,
`infinite_batches`, `fold_microbatches`): batches are assembled by a thread
pool (PIL decode and tokenization release the GIL through numpy/PIL) and
prefetched into a bounded queue, in the sampler's order whatever the worker
count.  It stands in for the reference's torch DataLoader with worker
processes (dataloader_num_workers 8, shells/train/qwen/pretrain.sh:55).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import CancelledError, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List

_SENTINEL = object()


class DataLoader:
    """Minimal epoch-based loader.

    dataset: indexable with __getitem__/__len__.
    sampler: iterable of indices with set_epoch(); defaults to sequential.
    collate_fn: List[sample] -> batch dict.
    drop_last: drop the trailing partial batch (the static batch shapes
    want constant B, so default True).
    """

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Callable[[List[Any]], Dict[str, Any]],
                 sampler=None, *, drop_last: bool = True,
                 num_workers: int = 8, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = sampler
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self) -> Iterator[List[int]]:
        if self.sampler is not None:
            if hasattr(self.sampler, "set_epoch"):
                self.sampler.set_epoch(self.epoch)
            indices = list(iter(self.sampler))
        else:
            indices = list(range(len(self.dataset)))
        for i in range(0, len(indices), self.batch_size):
            chunk = indices[i:i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield chunk

    def _build(self, idx_batch: List[int]) -> Dict[str, Any]:
        samples = [self.dataset[i] for i in idx_batch]
        return self.collate_fn(samples)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        self.epoch += 1
        if self.num_workers == 0:
            for idx_batch in self._index_batches():
                yield self._build(idx_batch)
            return

        out: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        abandoned = threading.Event()

        def produce():
            try:
                futures = []
                for idx_batch in self._index_batches():
                    if abandoned.is_set():
                        return
                    futures.append(pool.submit(self._build, idx_batch))
                    # bound in-flight work: drain completed futures in order
                    while len(futures) > self.prefetch:
                        out.put(futures.pop(0).result())
                for f in futures:
                    out.put(f.result())
            except (RuntimeError, CancelledError):
                # the consumer abandoned the generator mid-epoch and shut
                # the pool down (cancelling the queued builds) while we
                # were submitting or waiting — a normal exit for
                # infinite_batches-style consumers, not an error
                if not abandoned.is_set():
                    raise
            finally:
                out.put(_SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out.get()
                if item is _SENTINEL:
                    break
                yield item
        finally:
            abandoned.set()
            pool.shutdown(wait=False, cancel_futures=True)
            # unblock a producer waiting on the bounded queue
            try:
                out.get_nowait()
            except queue.Empty:
                pass


def infinite_batches(loader: DataLoader) -> Iterator[Dict[str, Any]]:
    """Cycle the loader forever, bumping the epoch each pass."""
    while True:
        yielded = False
        for batch in loader:
            yielded = True
            yield batch
        if not yielded:
            raise RuntimeError("DataLoader yielded no batches "
                               "(dataset smaller than one batch?)")



def fold_microbatches(batches: Iterator[Dict[str, Any]], m: int,
                      rows_per_sample: int) -> Iterator[Dict[str, Any]]:
    """Concatenate every m consecutive batches along the batch axis.

    Feeds the fused align step's in-batch gradient accumulation
    (train/fused_steps.py): one folded batch = one optimizer update over
    m microbatches, with per-microbatch loss normalization done inside
    the step.  Array values are concatenated on axis 0.

    `image_pos` keys are GLOBAL row indices into the batch-flattened media
    table (data/collator.py adds `sample_row * rows_per_sample`), so each
    microbatch's entries are re-offset by the samples folded before it;
    rows_per_sample must match the collator's
    (max_images * num_image_tokens)."""
    import numpy as np

    if m <= 1:
        yield from batches
        return
    while True:
        group = []
        for _ in range(m):
            try:
                group.append(next(batches))
            except StopIteration:
                if group:
                    raise RuntimeError(
                        f"{len(group)} dangling microbatch(es) at the end "
                        f"of the stream (not a multiple of m={m})")
                return
        out: Dict[str, Any] = {}
        for k, v0 in group[0].items():
            if not isinstance(v0, np.ndarray):
                if not all(g[k] is v0 or g[k] == v0 for g in group):
                    raise ValueError(f"non-array batch key '{k}' differs "
                                     f"across microbatches")
                out[k] = v0
            elif k.endswith("image_pos"):
                parts, row0 = [], 0
                for g in group:
                    parts.append(g[k] + row0 * rows_per_sample)
                    row0 += g[k].shape[0]
                out[k] = np.concatenate(parts, axis=0)
            else:
                out[k] = np.concatenate([g[k] for g in group], axis=0)
        yield out
