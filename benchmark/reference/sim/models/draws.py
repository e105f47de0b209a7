"""Random draws of one rank's rows of a global batch.

Data parallelism that equals the single-process step draws every random
number a step needs at the global batch's shape and keeps the rank's rows.
The trainer hands the model a ``RowGenerator`` (a generator and the rank's
rows of the global batch) where it would hand a ``torch.Generator``:
``rand_rows`` / ``randn_rows`` / ``randint_rows`` draw a leading axis of
rows (or of rows times a factor, batch-major) at the global shape from it
and cut the rank's rows, and ``row_offset`` gives the first global row of
a launch, with which the flash kernels key their dropout. Given a
``torch.Generator`` or None, they are ``torch.rand`` / ``randn`` /
``randint`` and 0.

A ``RowGenerator`` is not a ``torch.Generator``: a draw that goes past
these functions raises instead of drawing the rank's rows alone.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


class RowGenerator:
    """``generator`` (a ``torch.Generator``) drawing for the ``rows`` rows
    from ``offset`` of a global batch of ``total`` rows. Its state and
    device are the generator's (a remat recomputation rewinds it)."""

    __slots__ = ("generator", "offset", "rows", "total")

    def __init__(self, generator: torch.Generator, offset: int, rows: int, total: int):
        self.generator, self.offset, self.rows, self.total = generator, offset, rows, total

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def get_state(self) -> Tensor:
        return self.generator.get_state()

    def set_state(self, state: Tensor) -> None:
        self.generator.set_state(state)


def plain(generator):
    """The ``torch.Generator`` (or None) of ``generator``, for a draw that
    every rank makes alike (a flash kernel's seed)."""
    return generator.generator if isinstance(generator, RowGenerator) else generator


def _factor(n: int, g: RowGenerator) -> int:
    f, r = divmod(n, g.rows)
    if r or not f:
        raise ValueError(f"a leading axis of {n} is not a multiple of the shard's {g.rows} rows")
    return f


def row_offset(generator, n: int) -> int:
    """The global index of the first of a leading axis of ``n`` local rows
    (0 unless ``generator`` is a ``RowGenerator``)."""
    return generator.offset * _factor(n, generator) if isinstance(generator, RowGenerator) else 0


def _draw(fn, shape, generator, device) -> Tensor:
    shape = tuple(shape)
    if not isinstance(generator, RowGenerator):
        return fn(shape, generator=generator, device=device)
    if not shape:
        return fn(shape, generator=generator.generator, device=device)
    f = _factor(shape[0], generator)
    full = fn((generator.total * f,) + shape[1:], generator=generator.generator, device=device)
    return full[generator.offset * f:(generator.offset + generator.rows) * f]


def rand_rows(shape, generator=None, device=None) -> Tensor:
    """``torch.rand(shape)``; from a ``RowGenerator``, drawn at the global
    batch's shape and cut to its rows."""
    return _draw(torch.rand, shape, generator, device)


def randn_rows(shape, generator=None, device=None) -> Tensor:
    return _draw(torch.randn, shape, generator, device)


def randint_rows(low: int, high: int, shape, generator=None, device=None) -> Tensor:
    return _draw(lambda s, **kw: torch.randint(low, high, s, **kw), shape, generator, device)
