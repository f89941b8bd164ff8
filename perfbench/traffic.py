"""The one traffic generator: turns a cell's traffic parameters into the
requests each client sends.

A cell's `traffic` (in `perfbench/workloads/<cell>.json`) gives
`templates`, each template's whole-number share of the mix, `clients`,
and `loop`, which is `"closed"`: each client sends its next request when
its last one has answered. The requests come, in the order the clients
ask for them, from one seeded sequence of whole permutations of the mix
(every template as many times as its share): every seed sends the same
mix in another order, and whatever the window's length, the requests it
sends are whole permutations but for the last.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np


def deck(templates: Dict[str, int]) -> List[str]:
    """Every template as many times as its share, in file order."""
    out = []
    for name, share in templates.items():
        if int(share) != share or share < 1:
            raise ValueError(f"share of {name} must be a whole number >= 1")
        out += [name] * int(share)
    return out


class ClosedLoop:
    """The templates the closed-loop clients send, in order, forever;
    `next()` may be called from any client's thread."""

    def __init__(self, traffic: dict, seed: int):
        self._rng = np.random.default_rng([seed, 0])
        self._cards = deck(traffic["templates"])
        self._order: List[str] = []
        self._lock = threading.Lock()

    def next(self) -> str:
        with self._lock:
            if not self._order:
                self._order = [self._cards[i] for i in
                               self._rng.permutation(len(self._cards))][::-1]
            return self._order.pop()

