"""Small host-side helpers (the port's own copy of llavamod_tpu/utils/misc.py)."""

from __future__ import annotations

import random
from typing import List, Sequence, TypeVar

T = TypeVar("T")


def order_pick_k(items: Sequence[T], k: int, seed=None) -> List[T]:
    """Pick k elements uniformly at random but keep their original order
    (video frames, multi-image lists)."""
    if len(items) <= k:
        return list(items)
    rng = random.Random(seed) if seed is not None else random
    idx = sorted(rng.sample(range(len(items)), k))
    return [items[i] for i in idx]
