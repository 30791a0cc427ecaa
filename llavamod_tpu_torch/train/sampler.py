"""Batch samplers, including the modality-grouped length sampler.

The port's own copy of llavamod_tpu/train/sampler.py: the same index order
for the same seed and epoch (tests/test_torch_data.py); the per-process
`ProcessShardSampler` that a multi-process run wraps around them
(tests/test_torch_multihost_data.py).
Re-implementation of the reference's LengthGroupedSampler
(train/llava_trainer.py:40-132):

  * indices are shuffled, grouped into "megabatches" of
    world_size * batch_size, each megabatch sorted by length (descending)
    and split into `world_size` near-equal-total-length chunks
    (split_to_even_chunks, llava_trainer.py:40-60);
  * modality grouping first separates image-bearing (positive length) from
    text-only (negative length) samples, builds megabatches per modality,
    shuffles megabatch order, and appends the two leftovers as one final
    batch (llava_trainer.py:63-88).

With static [B, T] shapes, grouping similar lengths also keeps pad waste
low within each batch.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    """Split indices into num_chunks chunks of roughly equal total length
    (greedy shortest-chunk assignment, llava_trainer.py:40-60)."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    totals = [0.0] * num_chunks
    for index in indices:
        shortest = totals.index(min(totals))
        chunks[shortest].append(index)
        totals[shortest] += lengths[index]
        if len(chunks[shortest]) == per_chunk:
            totals[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int,
                               rng: Optional[np.random.Generator] = None,
                               ) -> List[int]:
    """Shuffle -> megabatches -> sort each by length desc -> even chunks
    (llava_trainer.py:92-100)."""
    rng = rng or np.random.default_rng()
    indices = rng.permutation(len(lengths)).tolist()
    mb = world_size * batch_size
    megabatches = [indices[i:i + mb] for i in range(0, len(lengths), mb)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size)
                   for m in megabatches]
    return [i for m in megabatches for chunk in m for i in chunk]


def get_modality_length_grouped_indices(
        lengths: Sequence[int], batch_size: int, world_size: int,
        rng: Optional[np.random.Generator] = None) -> List[int]:
    """Group multimodal (length > 0) and text-only (length < 0) samples into
    separate length-sorted megabatches (llava_trainer.py:63-88)."""
    rng = rng or np.random.default_rng()
    assert all(l != 0 for l in lengths), "Should not have zero length."
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices(lengths, batch_size, world_size, rng)

    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, l) for i, l in enumerate(lengths) if l < 0]
    mm_indices = [i for i, _ in mm]
    lang_indices = [i for i, _ in lang]
    mm_lengths = [l for _, l in mm]
    lang_lengths = [-l for _, l in lang]

    mm_shuffle = [mm_indices[i] for i in get_length_grouped_indices(
        mm_lengths, batch_size, world_size, rng)]
    lang_shuffle = [lang_indices[i] for i in get_length_grouped_indices(
        lang_lengths, batch_size, world_size, rng)]
    mb = world_size * batch_size
    mm_megabatches = [mm_shuffle[i:i + mb] for i in range(0, len(mm_shuffle), mb)]
    lang_megabatches = [lang_shuffle[i:i + mb]
                        for i in range(0, len(lang_shuffle), mb)]

    # last (possibly ragged) megabatch of each modality goes to the end
    last_mm = mm_megabatches[-1] if mm_megabatches else []
    last_lang = lang_megabatches[-1] if lang_megabatches else []
    additional = last_mm + last_lang
    megabatches = mm_megabatches[:-1] + lang_megabatches[:-1]
    order = rng.permutation(len(megabatches)).tolist()
    megabatches = [megabatches[i] for i in order]
    if additional:
        megabatches.append(sorted(additional))
    return [i for m in megabatches for i in m]


class LengthGroupedSampler:
    """Iterable of dataset indices (one epoch), length/modality grouped."""

    def __init__(self, batch_size: int, world_size: int,
                 lengths: Sequence[int], *, group_by_modality: bool = False,
                 seed: int = 0):
        if lengths is None:
            raise ValueError("Lengths must be provided.")
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = list(lengths)
        self.group_by_modality = group_by_modality
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.lengths)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.group_by_modality:
            idx = get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng)
        else:
            idx = get_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng)
        return iter(idx)


class RandomSampler:
    """Plain shuffling sampler with epoch reseeding."""

    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return self.n

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        return iter(rng.permutation(self.n).tolist())


class ProcessShardSampler:
    """Per-process shard of a global sampler order (one process per card).

    Every process iterates the SAME deterministic global order (all samplers
    here are seeded by seed+epoch) and keeps the rank-strided slice
    [rank::num_shards], truncated so every process yields the same count —
    torch DistributedSampler semantics, which the reference inherits from
    the deepspeed launcher + sampler world_size (llava_trainer.py:62-90).
    """

    def __init__(self, base, rank: int, num_shards: int):
        assert 0 <= rank < num_shards, (rank, num_shards)
        self.base = base
        self.rank = rank
        self.num_shards = num_shards

    def __len__(self) -> int:
        return len(self.base) // self.num_shards

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __iter__(self) -> Iterator[int]:
        order = list(iter(self.base))
        per = len(order) // self.num_shards
        return iter(order[self.rank::self.num_shards][:per])
