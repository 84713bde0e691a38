"""Parity: the port's workload generator against the JAX package's.

``repro_torch.data`` keeps its own numpy copy of ``repro.data``; from the same
seed both must give the same positions and query batches, bit for bit, over
ticks (tolerance 0: the raw bits are compared).
"""
import dataclasses

import numpy as np
import pytest

import repro.data as rdata
import repro_torch.data as tdata

N = 2000
FAMILIES = ("uniform", "gaussian", "network", "zipf", "hotspot_cluster")


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _walk(kw, ticks=3, rate=1.0):
    """Both generators from one config: positions and the query batch at
    every tick, then ``advance()``."""
    ref = rdata.make_workload(N, **kw)
    port = tdata.make_workload(N, **kw)
    for _ in range(ticks + 1):
        _same_bits(ref.positions(), port.positions())
        (rq, rid), (tq, tid) = ref.query_batch(rate), port.query_batch(rate)
        _same_bits(rq, tq)
        _same_bits(rid, tid)
        ref.advance()
        port.advance()
    return ref, port


@pytest.mark.parametrize("family", FAMILIES)
def test_family_matches_jax_over_ticks(family):
    """Positions and full query batches over three ``advance()`` calls."""
    _walk({"distribution": family, "seed": 3})


@pytest.mark.parametrize("family", FAMILIES)
def test_partial_query_rate_matches_jax(family):
    """``query_rate < 1`` draws the issuers from the same generator state,
    so the draws interleave with the motion's as in the reference."""
    _walk({"distribution": family, "seed": 11}, rate=0.3)


@pytest.mark.parametrize("kw", [
    {"distribution": "network", "network_grid": 7, "max_speed": 400.0},
    {"distribution": "zipf", "zipf_a": 2.2, "clusters": 5},
    {"distribution": "hotspot_cluster", "cluster_frac": 0.4, "clusters": 3,
     "side": 5000.0},
    {"distribution": "gaussian", "hotspots": 4, "hotspot_sigma_frac": 0.1},
])
def test_family_knobs_match_jax(kw):
    _walk(dict(kw, seed=5), ticks=2)


def test_network_state_matches_jax():
    """The road network itself (nodes, edges, incidence) and each object's
    edge, parameter and direction after the turns at the nodes."""
    ref, port = _walk({"distribution": "network", "seed": 2}, ticks=4)
    for name in ("net_nodes", "net_edges", "net_inc", "net_deg", "obj_edge",
                 "obj_t", "obj_dir", "obj_speed"):
        _same_bits(getattr(ref, name), getattr(port, name))
    # objects that turned sit exactly on a node: the tie case of the sweep
    assert ((port.obj_t == 0) | (port.obj_t == 1)).sum() > N // 20


def test_config_matches_jax():
    ours = [(f.name, f.default)
            for f in dataclasses.fields(tdata.WorkloadConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(rdata.WorkloadConfig)]
    assert ours == theirs
    assert tdata.__all__ == rdata.__all__
    with pytest.raises(ValueError, match="unknown distribution"):
        tdata.make_workload(10, "spiral")
