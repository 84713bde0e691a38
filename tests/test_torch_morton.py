"""Parity: Morton coding of the PyTorch port against the JAX reference.

Every comparison is bitwise (``np.array_equal`` on the raw bits, tolerance 0).
Inputs come from numpy seeds and are handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from repro_torch.testing import given, settings, strategies as st

from repro.core import morton as jm
from repro_torch.core import morton as tm

torch.set_num_threads(2)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b)


def _t(x):
    return torch.tensor(np.asarray(x))


def _edge_points(rng, origin, side, n=2048):
    """Random points plus points on and just past the region's edges."""
    ox, oy = origin
    lo = np.float32(ox), np.float32(oy)
    hi = np.float32(ox + side), np.float32(oy + side)
    edge = []
    for x in (lo[0], hi[0], np.nextafter(lo[0], np.float32(-np.inf)),
              np.nextafter(hi[0], np.float32(np.inf)),
              np.nextafter(hi[0], np.float32(-np.inf))):
        for y in (lo[1], hi[1], np.nextafter(hi[1], np.float32(np.inf))):
            edge.append((x, y))
    pts = rng.uniform(-0.05 * side, 1.05 * side, (n, 2)) + np.array(origin)
    return np.concatenate([np.asarray(edge, np.float32),
                           pts.astype(np.float32)])


@pytest.mark.parametrize("origin,side,level", [
    ((0.0, 0.0), 22_500.0, 8),
    ((3.3, -7.25), 1234.5678, 6),
    ((-50.0, 12.0), 777.77, 10),
])
def test_codes_and_cells_match_jax(origin, side, level):
    """Codes and cells, bitwise, including edge and out-of-region points."""
    rng = np.random.default_rng(level)
    pts = _edge_points(rng, origin, side)
    o = np.asarray(origin, np.float32)
    s = np.float32(side)
    jx, jy = jax.jit(jm.points_to_cells, static_argnums=3)(pts, o, s, level)
    tx, ty = tm.points_to_cells(_t(pts), _t(o), _t(s), level)
    _bits_equal(jx, tx.numpy())
    _bits_equal(jy, ty.numpy())
    jc = jax.jit(jm.morton_encode_points, static_argnums=3)(pts, o, s, level)
    _bits_equal(jc, tm.morton_encode_points(_t(pts), _t(o), _t(s),
                                            level).numpy())


def test_encode_decode_match_jax():
    """encode_cells / decode_code / part1by1 on every 16-bit coordinate."""
    v = np.arange(1 << 16, dtype=np.int32)
    _bits_equal(jm.part1by1(jnp.asarray(v)).astype(jnp.int32),
                tm.part1by1(_t(v)).to(torch.int32).numpy())
    rng = np.random.default_rng(0)
    cx = rng.integers(0, 1 << 15, 4096).astype(np.int32)
    cy = rng.integers(0, 1 << 15, 4096).astype(np.int32)
    jc = jm.encode_cells(jnp.asarray(cx), jnp.asarray(cy))
    tc = tm.encode_cells(_t(cx), _t(cy))
    _bits_equal(jc, tc.numpy())
    for a, b in zip(jm.decode_code(jc), tm.decode_code(tc)):
        _bits_equal(a, b.numpy())
    np.testing.assert_array_equal(tm.decode_code(tc)[0].numpy(), cx)


@pytest.mark.parametrize("side", [22_500.0, 1000.0, 1234.5678])
def test_block_distance_matches_jax(side):
    """block_box and point_to_block_dist2 against the jitted reference."""
    l_max = 8
    rng = np.random.default_rng(int(side))
    n = 8192
    code = rng.integers(0, 4**l_max, n).astype(np.int32)
    a = rng.integers(0, 4, n).astype(np.int32)
    code = (code >> (2 * a)) << (2 * a)  # aligned to 4**a
    pts = _edge_points(rng, (2.5, -1.0), side, n - 15)
    px, py = pts[:, 0].copy(), pts[:, 1].copy()
    origin = np.asarray((2.5, -1.0), np.float32)
    s = np.float32(side)
    jbox = jax.jit(jm.block_box, static_argnums=4)(code, a, origin, s, l_max)
    tbox = tm.block_box(_t(code), _t(a), _t(origin), _t(s), l_max)
    for jv, tv in zip(jbox, tbox):
        _bits_equal(jv, tv.numpy())
    jd = jax.jit(jm.point_to_block_dist2, static_argnums=6)(
        px, py, code, a, origin, s, l_max)
    td = tm.point_to_block_dist2(_t(px), _t(py), _t(code), _t(a), _t(origin),
                                 _t(s), l_max)
    _bits_equal(jd, td.numpy())


# The reference's property tests (tests/test_morton.py), same names and
# strategies: each drawn input goes through both packages.
coords = st.integers(min_value=0, max_value=(1 << 15) - 1)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.tuples(coords, coords), min_size=1, max_size=64))
def test_encode_decode_roundtrip(cells):
    """Codes bitwise equal to JAX's; decoding gives the cells back."""
    cx = np.asarray([c[0] for c in cells], np.int32)
    cy = np.asarray([c[1] for c in cells], np.int32)
    tz = tm.encode_cells(_t(cx), _t(cy))
    _bits_equal(jm.encode_cells(jnp.asarray(cx), jnp.asarray(cy)),
                tz.numpy())
    dx, dy = tm.decode_code(tz)
    np.testing.assert_array_equal(dx.numpy(), cx)
    np.testing.assert_array_equal(dy.numpy(), cy)


@settings(max_examples=30, deadline=None)
@given(st.tuples(coords, coords), st.integers(0, 7))
def test_ancestor_prefix_property(cell, up):
    """z >> 2u decodes to the ancestor u levels up, as in JAX."""
    cx, cy = cell
    tz = tm.encode_cells(_t(np.int32([cx])), _t(np.int32([cy]))) >> (2 * up)
    jz = jm.encode_cells(jnp.asarray([cx]), jnp.asarray([cy])) >> (2 * up)
    ax, ay = tm.decode_code(tz)
    for a, b in zip(jm.decode_code(jz), (ax, ay)):
        _bits_equal(a, b.numpy())
    assert int(ax[0]) == cx >> up
    assert int(ay[0]) == cy >> up


@settings(max_examples=30, deadline=None)
@given(
    st.lists(
        st.tuples(st.floats(0, 999.99), st.floats(0, 999.99)),
        min_size=2,
        max_size=64,
    ),
    st.integers(2, 8),
)
def test_same_cell_same_code(points, level):
    """Codes bitwise equal to JAX's; points share a code iff they share a
    grid cell."""
    pts = np.asarray(points, np.float32)
    origin = np.zeros(2, np.float32)
    z = tm.morton_encode_points(_t(pts), _t(origin), _t(np.float32(1000.0)),
                                level).numpy()
    _bits_equal(jm.morton_encode_points(jnp.asarray(pts), jnp.zeros(2),
                                        1000.0, level), z)
    n = 1 << level
    cell = np.floor(pts / 1000.0 * n).clip(0, n - 1).astype(int)
    same_cell = (cell[:, None, :] == cell[None, :, :]).all(-1)
    np.testing.assert_array_equal(z[:, None] == z[None, :], same_cell)
