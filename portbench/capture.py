"""Sampling the answers the timed path produces, for the checks.

A check wraps an entry of the program (a module attribute the program
looks up at each call) for the measured window: the wrapper passes every
call through and keeps copies of the inputs and outputs of a sample of
calls drawn from the seed (`Reservoir`: every call has the same chance,
whatever the window's length). The copies are taken on the caller's
stream, in stream order, so they hold what the call read and wrote.
"""

from __future__ import annotations

import random
import threading

import torch


class Reservoir:
    """Keeps k of the items offered, each offered item with the same
    chance k / n (reservoir sampling), drawn from `seed`. Thread-safe:
    the tracker and the mapper thread offer at once."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.n = 0
        self.items = []
        self.lock = threading.Lock()

    def offer(self):
        """A slot to fill (`put`) or None: this call is not kept."""
        with self.lock:
            self.n += 1
            if len(self.items) < self.k:
                self.items.append(None)
                return len(self.items) - 1
            j = self.rng.randrange(self.n)
            return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        with self.lock:
            self.items[slot] = item

    def kept(self) -> list:
        return [x for x in self.items if x is not None]


def clone(x):
    """A copy of a tensor (its own storage, same device); anything else
    as it is."""
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


class Patch:
    """Replaces `module.<name>` by `make(original)` until `undo`."""

    def __init__(self):
        self.undo_list = []

    def set(self, module, name: str, make):
        orig = getattr(module, name)
        new = make(orig)
        # the program may count on the entry's attributes (a kernel
        # wrapper's launch counter)
        new.__dict__.update(getattr(orig, "__dict__", {}))
        setattr(module, name, new)
        self.undo_list.append((module, name, orig))
        return orig

    def undo(self) -> None:
        while self.undo_list:
            module, name, orig = self.undo_list.pop()
            setattr(module, name, orig)
