"""Parity: the port's partitioners against ``repro.core.balance``.

Boundaries come from f32 prefix sums, whose order differs between XLA and
PyTorch, so the costs here are integer-valued and their sums stay below
2**24: every sum is exact, and the boundaries are compared bitwise
(``np.array_equal``, tolerance 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balance as jb
from repro_torch.core import balance as tb


@pytest.mark.parametrize("n,r", [(1, 1), (7, 3), (123, 4), (1000, 3),
                                 (64, 8), (5, 8)])
def test_equal_boundaries_match(n, r):
    np.testing.assert_array_equal(np.asarray(jb.equal_boundaries(n, r)),
                                  tb.equal_boundaries(n, r).numpy())


@pytest.mark.parametrize("family", ["uniform", "skewed", "spike", "zeros"])
@pytest.mark.parametrize("n,r", [(123, 4), (61, 3), (1000, 3), (16, 8)])
def test_balanced_boundaries_match(family, n, r):
    g = np.random.default_rng(n * 10 + r)
    costs = {
        "uniform": np.ones(n),
        "skewed": np.floor(g.pareto(1.2, n) * 300) + 1,
        "spike": np.where(np.arange(n) == n // 3, 50_000.0, 3.0),
        "zeros": np.zeros(n),
    }[family].astype(np.float32)
    assert costs.sum() < 2**24
    for part in (jb.CostBalancedPartitioner(), jb.EqualPartitioner()):
        tpart = tb.resolve_partitioner(part.name)
        for axis in ("query", "object"):
            want = getattr(part, f"{axis}_boundaries")(jnp.asarray(costs), r)
            got = getattr(tpart, f"{axis}_boundaries")(torch.tensor(costs), r)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                          err_msg=f"{part.name}/{axis}")
            assert getattr(tpart, f"{axis}_capacity")(n, r) == getattr(
                part, f"{axis}_capacity")(n, r)


def test_balanced_boundaries_infeasible_and_registry():
    with pytest.raises(ValueError, match="infeasible partition"):
        tb.balanced_boundaries(torch.ones(10), 2, 4)
    assert tb.partitioner_names() == jb.partitioner_names()
    assert tb.resolve_partitioner(None) == tb.EqualPartitioner()
    part = tb.CostBalancedPartitioner(slack=1.5)
    assert tb.resolve_partitioner(part) is part
    with pytest.raises(ValueError, match="unknown partitioner"):
        tb.resolve_partitioner("nope")
    with pytest.raises(ValueError, match="slack"):
        tb.CostBalancedPartitioner(slack=0.5)
    with pytest.raises(ValueError, match="ema_alpha"):
        tb.CostBalancedPartitioner(ema_alpha=0.0)


def test_straggler_gap_and_tenant_weights_match():
    for work in ([1.0, 1.0, 1.0], [4.0, 0.0, 2.0], [0.0, 0.0], [3.5]):
        assert tb.straggler_gap(work) == jb.straggler_gap(work)
    for tenants in ([], [3, 3, 1, 7, 3, 1], [5]):
        np.testing.assert_array_equal(
            np.asarray(jb.tenant_fair_weights(tenants)),
            tb.tenant_fair_weights(tenants))
