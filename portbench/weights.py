"""Weights made from the seed on the device: one flat float32 buffer
drawn from a standard normal in a few large calls, each leaf a view of
it scaled to its standard deviation (a norm's scale zero).

The same (spec, seed, device) gives the same bits, so the reference
makes its own copy of the starting weights again after the program's run
instead of keeping one.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Weights"]

_DRAW = 1 << 30          # elements a call


class Weights:
    """`spec`: (path, shape, std) of every leaf, std None for zeros."""

    def __init__(self, spec: list, seed: int, device):
        self.spec = spec
        self.slices = []
        at = 0
        for path, shape, _ in spec:
            n = math.prod(shape)
            self.slices.append((path, at, at + n, tuple(shape)))
            at += n
        self.numel = at
        self.flat = torch.empty(at, dtype=torch.float32, device=device)
        gen = torch.Generator(device=self.flat.device).manual_seed(seed)
        with torch.no_grad():
            for part in self.flat.split(_DRAW):
                part.normal_(generator=gen)
            for (_, a, b, _), (_, _, std) in zip(self.slices, spec):
                if std is None:
                    self.flat[a:b].zero_()
                else:
                    self.flat[a:b].mul_(std)

    def views(self, flat: torch.Tensor | None = None) -> dict:
        """path -> the leaf as a view of `flat` (default the buffer)."""
        flat = self.flat if flat is None else flat
        return {path: flat[a:b].view(shape)
                for path, a, b, shape in self.slices}

    def tree(self) -> dict:
        """The leaves as a nested dict (lists where a path holds an int):
        the layout that the program's model takes."""
        root: dict = {}
        for path, view in self.views().items():
            node = root
            for key, nxt in zip(path[:-1], path[1:]):
                empty = [] if isinstance(nxt, int) else {}
                if isinstance(key, int):
                    while len(node) <= key:
                        node.append(None)
                    if node[key] is None:
                        node[key] = empty
                    node = node[key]
                else:
                    node = node.setdefault(key, empty)
            node[path[-1]] = view
        return root

    def leaf_norms(self, flat: torch.Tensor,
                   minus: torch.Tensor | None = None) -> dict:
        """path -> the float64 norm of that leaf of `flat` (of `flat` -
        `minus`, a leaf at a time)."""
        out = {}
        with torch.no_grad():
            for path, a, b, _ in self.slices:
                x = flat[a:b] if minus is None else flat[a:b] - minus[a:b]
                out[path] = float(torch.linalg.vector_norm(
                    x, dtype=torch.float64))
        return out


def leaf(tree, path: tuple):
    """The leaf of a nested dict / list tree at `path`."""
    for key in path:
        tree = tree[key]
    return tree
