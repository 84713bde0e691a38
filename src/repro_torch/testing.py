"""Deterministic fallback for the tiny slice of ``hypothesis`` the tests use.

The port's own copy of the reference's fallback, in numpy only.  Property
tests import hypothesis through a guard::

    try:
        from hypothesis import given, settings, strategies as st
    except ModuleNotFoundError:
        from repro_torch.testing import given, settings, strategies as st

Semantics here are a strict subset: ``@given`` draws ``max_examples`` examples
from the strategies with a seed derived from the test name (stable across
runs, so failures reproduce), with no shrinking and no example database.  When
real hypothesis is available it wins, shrinking and all.  :func:`draws` gives
the same examples outside a test (``chip_smoke.py``'s ``properties`` phase).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable

import numpy as np

__all__ = ["given", "settings", "strategies", "draws"]

DEFAULT_MAX_EXAMPLES = 20


@dataclasses.dataclass(frozen=True)
class _Strategy:
    draw: Callable[[np.random.Generator], Any]

    def sample(self, rng: np.random.Generator):
        return self.draw(rng)


class strategies:
    """Namespace mirroring ``hypothesis.strategies`` (the used subset)."""

    @staticmethod
    def floats(min_value: float, max_value: float) -> _Strategy:
        return _Strategy(lambda rng: float(rng.uniform(min_value, max_value)))

    @staticmethod
    def integers(min_value: int, max_value: int) -> _Strategy:
        # hypothesis bounds are inclusive
        return _Strategy(lambda rng: int(rng.integers(min_value, max_value + 1)))

    @staticmethod
    def tuples(*elems: _Strategy) -> _Strategy:
        return _Strategy(lambda rng: tuple(e.sample(rng) for e in elems))

    @staticmethod
    def lists(elem: _Strategy, *, min_size: int = 0, max_size: int = 10) -> _Strategy:
        def draw(rng):
            n = int(rng.integers(min_size, max_size + 1))
            return [elem.sample(rng) for _ in range(n)]

        return _Strategy(draw)


def settings(max_examples: int = DEFAULT_MAX_EXAMPLES, deadline=None):
    """Decorator setting the example count on a ``@given``-wrapped test."""

    def deco(fn):
        fn._max_examples = max_examples
        return fn

    return deco


def draws(name: str, strats, n: int = DEFAULT_MAX_EXAMPLES) -> list[tuple]:
    """The ``n`` examples ``@given(*strats)`` draws for a test named ``name``."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return [tuple(s.sample(rng) for s in strats) for _ in range(n)]


def given(*strats: _Strategy):
    """Run the test once per drawn example (deterministic per-test seed)."""

    def deco(fn):
        def run(*args, **kw):
            # @settings may sit above @given (stamps `run`) or below (stamps `fn`)
            n = getattr(
                run, "_max_examples", getattr(fn, "_max_examples", DEFAULT_MAX_EXAMPLES)
            )
            for example in draws(fn.__name__, strats, n):
                fn(*args, *example, **kw)

        # NOT functools.wraps: copying __wrapped__ would make pytest inspect
        # the original signature and treat the drawn arguments as fixtures.
        run.__name__ = fn.__name__
        run.__doc__ = fn.__doc__
        run.__module__ = fn.__module__
        return run

    return deco
