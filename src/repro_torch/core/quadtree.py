"""PR-quadtree spatial index and its maintenance, in PyTorch.

Counterpart of ``repro/core/quadtree.py``: the count pyramid (one bincount at
the finest level plus ``l_max`` reshape-sums), the leaf levels that form the
paper's z_map, and the per-cell prefix offsets.  The object order is the
canonical ``(code, id)`` order: a stable argsort of the id-indexed codes, with
``ids = order``.  The index is refreshed either by a full re-sort
(:func:`reindex_objects`) or by splicing only the moved rows into the old
order (:func:`reindex_objects_delta`); both give the same bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.delta_splice import (gather_splice, searchsorted_pairs,
                                    sparse_splice_plan)
from . import morton

__all__ = [
    "QuadtreeIndex",
    "INDEX_FIELDS",
    "pyramid_offset",
    "build_index",
    "rebuild_zmap",
    "reindex_objects",
    "reindex_objects_delta",
    "pyramid_delta",
    "leaf_of_points",
    "starts_from_pyramid",
    "local_pyramid_from_starts",
    "ball_stab_mask",
]

INDEX_FIELDS = ("origin", "side", "pos", "ids", "codes", "starts",
                "leaf_level", "pyramid")


@dataclasses.dataclass(frozen=True)
class QuadtreeIndex:
    """The spatial index + Morton-sorted object store.

    origin: (2,) f32; side: () f32; pos: (N, 2) f32 sorted by fine Morton code;
    ids: (N,) i32 original object ids; codes: (N,) i32 sorted fine codes;
    starts: (4**l_max + 1,) i32 prefix offsets per fine cell; leaf_level:
    (4**l_max,) i32 (the z_map); pyramid: i32 quadrant populations at every
    level, level-major.  All tensors live on one device.
    """

    origin: torch.Tensor
    side: torch.Tensor
    pos: torch.Tensor
    ids: torch.Tensor
    codes: torch.Tensor
    starts: torch.Tensor
    leaf_level: torch.Tensor
    pyramid: torch.Tensor
    l_max: int
    th_quad: int

    def level_counts(self, level: int) -> torch.Tensor:
        """Populations of the 4**level quadrants at ``level`` (view of pyramid)."""
        off = pyramid_offset(level)
        return self.pyramid[off : off + 4**level]

    @property
    def n_objects(self) -> int:
        return self.pos.shape[0]

    @property
    def n_fine(self) -> int:
        return 4**self.l_max

    @property
    def device(self) -> torch.device:
        return self.pos.device


def pyramid_offset(level: int) -> int:
    """Start of level ``level`` inside the flattened pyramid: (4**l - 1) / 3."""
    return ((1 << (2 * level)) - 1) // 3


def _rollup(fine: torch.Tensor, l_max: int) -> torch.Tensor:
    levels = [fine]
    cur = fine
    for _ in range(l_max):
        cur = cur.reshape(-1, 4).sum(dim=1, dtype=torch.int32)
        levels.append(cur)
    return torch.cat(list(reversed(levels)))


def _count_pyramid(codes: torch.Tensor, l_max: int) -> torch.Tensor:
    """Quadrant populations at every level, flattened level-major (int32)."""
    counts = torch.bincount(codes.to(torch.int64), minlength=4**l_max)
    return _rollup(counts.to(torch.int32), l_max)


def pyramid_delta(pyramid: torch.Tensor, old_codes: torch.Tensor,
                  new_codes: torch.Tensor, weight: torch.Tensor,
                  l_max: int) -> torch.Tensor:
    """The count pyramid after rows move from ``old_codes`` to ``new_codes``.

    ``-weight`` at each old fine cell and ``+weight`` at each new one
    (``weight`` 1 for a real row, 0 for padding; codes at or above
    ``4**l_max``, the sentinel, are dropped), then the same reshape-sum
    rollup as a recount.  Integer adds commute, so it equals the recount of
    the moved code set bit for bit.
    """
    n_fine = 4**l_max
    fine = torch.cat([pyramid[pyramid_offset(l_max):],
                      torch.zeros((1,), dtype=pyramid.dtype,
                                  device=pyramid.device)])
    weight = weight.to(fine.dtype)
    for codes, w in ((old_codes, -weight), (new_codes, weight)):
        at = torch.where((codes >= 0) & (codes < n_fine), codes, n_fine)
        fine.index_add_(0, at.long(), w)
    return _rollup(fine[:n_fine], l_max)


def starts_from_pyramid(pyramid: torch.Tensor, l_max: int) -> torch.Tensor:
    """Prefix offsets from the pyramid's fine level: ``starts[c] = # codes < c``."""
    fine_counts = pyramid[pyramid_offset(l_max):]
    return torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=pyramid.device),
        torch.cumsum(fine_counts, 0).to(torch.int32),
    ])


def local_pyramid_from_starts(starts: torch.Tensor, lo: int, own: int,
                              clone_code, capo: int, l_max: int) -> torch.Tensor:
    """Count pyramid of one Morton-contiguous slice, from GLOBAL offsets.

    A shard owning global sorted ranks ``[lo, lo + own)``, padded to ``capo``
    rows whose surplus rows all carry ``clone_code``, counts in fine cell
    ``c`` the overlap ``max(0, min(starts[c+1], lo + own) - max(starts[c],
    lo))`` of the cell's rank interval with its window, plus the
    ``capo - own`` clone rows at ``clone_code``.  All int32, so it equals a
    ``bincount`` of the slice's codes bit for bit.
    """
    s = starts[:-1]
    e = starts[1:]
    fine = (e.clamp(max=lo + own) - s.clamp(min=lo)).clamp(min=0)
    fine = fine.to(torch.int32)
    fine[clone_code] += capo - own
    return _rollup(fine, l_max)


def _leaf_levels(pyramid: torch.Tensor, l_max: int, th_quad: int) -> torch.Tensor:
    """Leaf level per fine cell = number of split ancestors along its path."""
    fine = torch.arange(4**l_max, dtype=torch.int64, device=pyramid.device)
    ll = torch.zeros(4**l_max, dtype=torch.int32, device=pyramid.device)
    for l in range(l_max):
        anc = fine >> (2 * (l_max - l))
        lvl_counts = pyramid[pyramid_offset(l): pyramid_offset(l) + 4**l]
        ll += (lvl_counts[anc] > th_quad).to(torch.int32)
    return ll


def build_index(points, origin, side, *, l_max: int = 8,
                th_quad: int = 192) -> QuadtreeIndex:
    """Build the PR-quadtree and index the objects, on ``points.device``.

    ``origin``/``side`` may be Python numbers or tensors; they are stored as
    f32 tensors on the points' device.
    """
    dev = points.device
    points = points.to(torch.float32)
    origin = torch.as_tensor(origin, dtype=torch.float32).to(dev)
    side = torch.as_tensor(side, dtype=torch.float32).to(dev)
    codes = morton.morton_encode_points(points, origin, side, l_max)
    order = torch.argsort(codes, stable=True)
    pyramid = _count_pyramid(codes, l_max)
    return QuadtreeIndex(
        origin=origin,
        side=side,
        pos=points[order],
        ids=order.to(torch.int32),
        codes=codes[order],
        starts=starts_from_pyramid(pyramid, l_max),
        leaf_level=_leaf_levels(pyramid, l_max, th_quad),
        pyramid=pyramid,
        l_max=l_max,
        th_quad=th_quad,
    )


def rebuild_zmap(index: QuadtreeIndex) -> QuadtreeIndex:
    """Re-derive only the leaf partition (z_map) from the live pyramid."""
    return dataclasses.replace(
        index,
        leaf_level=_leaf_levels(index.pyramid, index.l_max, index.th_quad),
    )


def reindex_objects(index: QuadtreeIndex, points) -> QuadtreeIndex:
    """Re-sort fresh object positions into the existing partition (stage ii)."""
    l_max = index.l_max
    points = points.to(torch.float32)
    codes = morton.morton_encode_points(points, index.origin, index.side, l_max)
    order = torch.argsort(codes, stable=True)
    pyramid = _count_pyramid(codes, l_max)
    return dataclasses.replace(
        index,
        pos=points[order],
        ids=order.to(torch.int32),
        codes=codes[order],
        starts=starts_from_pyramid(pyramid, l_max),
        pyramid=pyramid,
    )


def reindex_objects_delta(index: QuadtreeIndex, points: torch.Tensor,
                          delta_ids: torch.Tensor,
                          delta_old_pos: torch.Tensor) -> QuadtreeIndex:
    """Stage (ii) with work proportional to the delta: the same index as
    ``reindex_objects(index, points)`` when ``points`` differs from the
    indexed positions only at ``delta_ids``.

    The moved rows, keyed ``(new code, id)`` and sorted alone, are spliced
    into the surviving rows of the old order (the sparse plan of
    ``kernels/delta_splice.py``); each moved row's slot is found by searching
    its old key, recomputed from ``delta_old_pos``, the position it had when
    ``index`` was refreshed (bitwise).  The pyramid takes +-1 at the old and
    new fine cells (:func:`pyramid_delta`); ``leaf_level`` is kept, as
    ``reindex_objects`` keeps it.

    ``delta_ids`` holds each object id at most once; ids at or past N are
    sentinel padding, ignored (their old positions are arbitrary).  Where
    ``4**l_max * (n + 1) + n < 2**31`` the key ``code * (n + 1) + id`` packs
    into one int32 and one sort and one fused ``searchsorted`` serve, as in
    the reference; otherwise the pair formulation does (two stable sorts,
    :func:`~repro_torch.kernels.delta_splice.searchsorted_pairs`).
    """
    n = index.n_objects
    l_max = index.l_max
    dev = index.device
    points = points.to(torch.float32)
    ids = delta_ids.to(torch.int32)
    p = ids.shape[0]
    valid = ids < n
    safe = torch.where(valid, ids, 0).long()
    sent_code = 4**l_max  # above every real fine code
    q_ids = torch.where(valid, ids, n)
    old_codes = torch.where(
        valid,
        morton.morton_encode_points(delta_old_pos.to(torch.float32),
                                    index.origin, index.side, l_max),
        sent_code)
    # run B: the moved rows, sorted by (code, id): the only sort in the path
    new_pos = points[safe]
    new_codes = morton.morton_encode_points(new_pos, index.origin, index.side,
                                            l_max)
    new_codes_m = torch.where(valid, new_codes, sent_code)
    if 4**l_max * (n + 1) + n < 2**31:
        # (code, id) packs into one int32 (id < n + 1), whose numeric order
        # is the lexicographic order
        mult = n + 1
        pk_b, perm = torch.sort(new_codes_m * mult + q_ids, stable=True)
        codes_b = new_codes_m[perm]
        ids_b = q_ids[perm]
        # one search, side right: the first half hits existing keys exactly
        # (rank = slot + 1), the second ranks the new keys for insertion
        res = torch.searchsorted(index.codes * mult + index.ids,
                                 torch.cat([old_codes * mult + q_ids, pk_b]),
                                 right=True, out_int32=True)
    else:
        by_id = torch.argsort(q_ids, stable=True)
        perm = by_id[torch.argsort(new_codes_m[by_id], stable=True)]
        codes_b = new_codes_m[perm]
        ids_b = q_ids[perm]
        res = searchsorted_pairs(index.codes, index.ids,
                                 torch.cat([old_codes, codes_b]),
                                 torch.cat([q_ids, ids_b]), side="right")
    pos_b = new_pos[perm]
    slots = torch.where(valid, res[:p] - 1, n)
    src_a, b_src = sparse_splice_plan(slots, res[p:], n)
    pyramid = pyramid_delta(index.pyramid, old_codes, new_codes_m,
                            valid.to(torch.int32), l_max)
    return dataclasses.replace(
        index,
        pos=gather_splice(src_a, b_src, index.pos, pos_b),
        ids=gather_splice(src_a, b_src, index.ids, ids_b),
        codes=gather_splice(src_a, b_src, index.codes, codes_b),
        starts=starts_from_pyramid(pyramid, l_max),
        pyramid=pyramid,
    )


def leaf_of_points(index: QuadtreeIndex, points):
    """z_map lookup: points -> (leaf_key, leaf_level), both int32."""
    fine = morton.morton_encode_points(points, index.origin, index.side,
                                       index.l_max)
    lvl = index.leaf_level[fine]
    shift = 2 * (index.l_max - lvl)
    key = (fine >> shift) << shift
    return key, lvl


def _part1by1_np(v: np.ndarray) -> np.ndarray:
    """numpy replica of :func:`repro_torch.core.morton.part1by1` (host-side
    stab)."""
    v = np.asarray(v, np.uint32)
    v = (v | (v << 8)) & np.uint32(0x00FF00FF)
    v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
    v = (v | (v << 2)) & np.uint32(0x33333333)
    v = (v | (v << 1)) & np.uint32(0x55555555)
    return v


def _encode_cells_np(cx: np.ndarray, cy: np.ndarray) -> np.ndarray:
    return (_part1by1_np(cx) | (_part1by1_np(cy) << 1)).astype(np.int64)


# conservative widening of the stored squared k-th distance: the kernels give
# the Euclidean k-th distance in f32 (an f32 squared distance, then a
# correctly rounded f32 root), and the cache squares it back in f64, so the
# stored r^2 can sit a few ulps below the exact value (about 5 * 2**-23
# relative at worst); 2**-17 leaves an order of magnitude of headroom and is
# geometrically negligible.  At r^2 == 0 no margin is needed: an f32
# difference is exactly 0 only for bitwise-equal coordinates (or -0 and +0).
_STAB_MARGIN = 1.0 + 2.0**-17


def ball_stab_mask(centers: np.ndarray, kth2: np.ndarray, moved: np.ndarray,
                   *, origin, side, l_max: int,
                   exact_rows: int = 64) -> np.ndarray:
    """Which closed k-th-distance balls does a set of moved points stab?

    Host numpy.  Cache entry *e* (query ``centers[e]``, squared k-th distance
    ``kth2[e]``) can only have changed if some moved row's old or new
    position lies in its closed ball (an object tied at exactly the k-th
    distance can flip the lowest-id tie-break).  Returns an (E,) bool mask,
    True = evict.  The mask is conservative: widened by ``_STAB_MARGIN``,
    coarsened to cells on the pyramid path, and positions outside the region
    clipped to its boundary cells; each approximation adds stabs, never
    drops one.

    Two regimes, one contract:

    * at most ``exact_rows`` moved rows: the exact pairwise check in f64
      (the squared distance of f32 inputs is exact there, so only the stored
      radius needs the margin);
    * more: a Morton occupancy pyramid over the moved rows' fine cells and,
      per ball, the coarsest level whose cell side covers its diameter,
      where four occupancy probes decide the stab.

    NaN or infinite centres and NaN radii always stab (their ball is
    undefined), and an infinite radius (fewer than k candidates) stabs on
    any motion.
    """
    centers = np.asarray(centers, np.float64).reshape(-1, 2)
    kth2 = np.asarray(kth2, np.float64).reshape(-1)
    moved = np.asarray(moved, np.float64).reshape(-1, 2)
    E = centers.shape[0]
    M = moved.shape[0]
    bad = ~(np.isfinite(centers).all(axis=1) & ~np.isnan(kth2))
    if E == 0 or M == 0:
        # non-finite geometry stabs even without motion to localise
        return bad | np.isinf(kth2)
    r2 = kth2 * _STAB_MARGIN
    if M <= exact_rows:
        d2 = ((centers[:, None, 0] - moved[None, :, 0]) ** 2
              + (centers[:, None, 1] - moved[None, :, 1]) ** 2)
        return bad | (d2 <= r2[:, None]).any(axis=1)
    ox = float(np.asarray(origin).reshape(-1)[0])
    oy = float(np.asarray(origin).reshape(-1)[1])
    side = float(side)
    n_fine = 1 << l_max
    mx = np.clip(np.floor((moved[:, 0] - ox) / side * n_fine), 0, n_fine - 1)
    my = np.clip(np.floor((moved[:, 1] - oy) / side * n_fine), 0, n_fine - 1)
    occ_fine = np.zeros((n_fine * n_fine,), bool)
    occ_fine[_encode_cells_np(mx.astype(np.int64), my.astype(np.int64))] = True
    levels = [occ_fine]
    cur = occ_fine
    for _ in range(l_max):
        cur = cur.reshape(-1, 4).any(axis=1)
        levels.append(cur)
    occ = np.concatenate(list(reversed(levels)))
    # per ball: the coarsest level whose cell side is at least the diameter
    # (r == 0: the finest)
    r = np.sqrt(np.maximum(r2, 0.0))
    always = bad | np.isinf(r)
    ok = ~always
    lvl = np.full((E,), l_max, np.int64)
    pos_r = ok & (r > 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.floor(np.log2(side / (2.0 * np.where(pos_r, r, 1.0))))
    lvl[pos_r] = np.clip(want[pos_r], 0, l_max).astype(np.int64)
    n_cells = np.int64(1) << lvl
    off = ((np.int64(1) << (2 * lvl)) - 1) // 3

    def cell(coord, o):
        c = np.floor((coord - o) / side * n_cells)
        return np.clip(c, 0, n_cells - 1).astype(np.int64)

    # finite stand-ins on the always-stab rows, for the integer casts
    cx = np.where(ok, centers[:, 0], ox)
    cy = np.where(ok, centers[:, 1], oy)
    r = np.where(ok & np.isfinite(r), r, 0.0)
    xs = (cell(cx - r, ox), cell(cx + r, ox))
    ys = (cell(cy - r, oy), cell(cy + r, oy))
    hit = np.zeros((E,), bool)
    for ix in xs:
        for iy in ys:
            hit |= occ[off + _encode_cells_np(ix, iy)]
    return always | (ok & hit)
