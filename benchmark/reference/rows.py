"""The rows of a global batch that one data-parallel rank takes.

The reference runs a data-parallel step as one process: it takes the
ranks' rows one after the other (`as_rank`), and every random draw is the
global batch's, of which the rank in hand keeps its rows, as each rank of
the program does (`draw_rows`).
"""

from __future__ import annotations

import contextlib

_RANK = [(0, 1)]


@contextlib.contextmanager
def as_rank(rank: int, world: int):
    _RANK.append((rank, world))
    try:
        yield
    finally:
        _RANK.pop()


def rank_world():
    return _RANK[-1]


def local_rows(x, rank: int, world: int, dim: int = 0):
    n = x.shape[dim]
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    mb = n // world
    return x.narrow(dim, rank * mb, mb)


def this_rank_rows(x, dim: int = 0):
    rank, world = rank_world()
    if world == 1 or x is None:
        return x
    if isinstance(x, tuple):
        return type(x)(*(this_rank_rows(f, dim) for f in x))
    return local_rows(x, rank, world, dim)


def draw_rows(draw, batch: int):
    """This rank's `batch` rows of `draw(batch * world)`."""
    return this_rank_rows(draw(batch * rank_world()[1]))
