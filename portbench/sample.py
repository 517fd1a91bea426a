"""Seeded sampling of the window's calls for the check."""

from __future__ import annotations


class Reservoir:
    """``k`` items drawn uniformly from a stream of unknown length, the
    draws from a seeded generator."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item_fn) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item_fn())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item_fn()
