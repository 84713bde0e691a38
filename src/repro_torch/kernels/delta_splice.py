"""Delta-splice: merge a sorted delta run into an existing sorted order.

Counterpart of ``repro/kernels/delta_splice.py``, the primitive of the
incremental index refresh (``maintenance="incremental"``): the moved rows are
sorted alone and spliced into the surviving rows of the old ``(code, id)``
order by a rank merge.  The reference writes it with jnp ops and no Pallas (a
two-run merge is data movement with no arithmetic to keep on chip), so the
port writes it with torch ops; there is no hand-written kernel here.

Keys are ``(code, id)`` pairs of int32, compared component by component
(:func:`searchsorted_pairs`): the reference runs with x64 off, so every value
at these functions' boundaries is int32, as here.  Two formulations of one
merge:

- dense (:func:`merge_ranks` + :func:`splice_payload`): each run's output
  positions by binary search, payloads by scatter;
- sparse (:func:`sparse_splice_plan` + :func:`gather_splice`): the path the
  index refresh takes; its scatters are delta-sized, and the merged order
  comes back as gather sources.

Stability: on fully equal keys run A precedes run B.  Real ``(code, id)``
keys are unique across the runs, so the tie side only places sentinel rows,
whose keys lie above every real key and whose positions fall at or past the
real count, where the scatters drop them.
"""
from __future__ import annotations

import torch

__all__ = [
    "searchsorted_pairs",
    "merge_ranks",
    "splice_payload",
    "sparse_splice_plan",
    "gather_splice",
]


def _pair_less(ac, ai, bc, bi):
    return (ac < bc) | ((ac == bc) & (ai < bi))


def searchsorted_pairs(keys_c, keys_i, q_c, q_i, *, side: str):
    """``searchsorted`` over lexicographic ``(c, i)`` int32 pair keys.

    ``(keys_c, keys_i)`` must ascend by ``(c, i)``.  Returns, per query pair,
    the count of keys below it (``side="left"``) or at most it
    (``side="right"``), int32.  A vectorised binary search of
    ``n.bit_length() + 1`` steps, the reference's count, each one gather and
    one pair comparison over every query.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    n = keys_c.shape[0]
    lo = torch.zeros(q_c.shape, dtype=torch.int32, device=q_c.device)
    if n == 0:
        return lo
    hi = torch.full(q_c.shape, n, dtype=torch.int32, device=q_c.device)
    for _ in range(n.bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        at = mid.clamp(max=n - 1).long()
        kc, ki = keys_c[at], keys_i[at]
        if side == "left":
            go_right = _pair_less(kc, ki, q_c, q_i)  # key[mid] < q
        else:
            go_right = ~_pair_less(q_c, q_i, kc, ki)  # key[mid] <= q
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def merge_ranks(codes_a, ids_a, codes_b, ids_b):
    """Output positions ``(pos_a, pos_b)`` (int32) of the stable merge of two
    ``(code, id)``-sorted runs; sentinel rows land at or past the real count.
    """
    pos_a = torch.arange(codes_a.shape[0], dtype=torch.int32,
                         device=codes_a.device) + searchsorted_pairs(
        codes_b, ids_b, codes_a, ids_a, side="left")
    pos_b = torch.arange(codes_b.shape[0], dtype=torch.int32,
                         device=codes_b.device) + searchsorted_pairs(
        codes_a, ids_a, codes_b, ids_b, side="right")
    return pos_a, pos_b


def _trash(pos, n: int):
    """Positions as int64 indices into n + 1 rows: those outside [0, n) go to
    row n, which the caller drops (a mask would read its count back to the
    host)."""
    return torch.where((pos >= 0) & (pos < n), pos, n).long()


def _scatter_set(out, pos, val):
    """``out[pos] = val``, rows whose position lies outside ``out`` dropped."""
    n = out.shape[0]
    wide = torch.cat([out, out.new_zeros((1,) + tuple(out.shape[1:]))])
    wide[_trash(pos, n)] = val.to(out.dtype)
    return wide[:n]


def splice_payload(pos_a, pos_b, val_a, val_b, n_out: int, fill=0):
    """Both runs' payload rows scattered to their merged positions; rows
    placed at or past ``n_out`` (the sentinel tails) are dropped."""
    out = torch.full((n_out,) + tuple(val_a.shape[1:]), fill,
                     dtype=val_a.dtype, device=val_a.device)
    return _scatter_set(_scatter_set(out, pos_a, val_a), pos_b, val_b)


def sparse_splice_plan(slots, ins_full, n: int):
    """Gather plan for splicing a sorted delta run into an n-row sorted order.

    ``slots`` (P,): the original slot of each moved row (``n`` for sentinel
    rows); ``ins_full`` (P,): for each run-B row, ascending by ``(code, id)``,
    its rank among the original rows (``searchsorted_pairs``, side right).
    Returns ``(src_a, b_src)``, (n,) int32 each: the original slot whose row
    lands at each output position, and the run-B row that lands there
    (``-1`` where a surviving row does).  The shift ``src_a[j] - j`` is
    piecewise constant with O(P) breakpoints, so it is a cumsum over a
    P-sparse bump array and no scatter is n-sized.
    """
    dev = slots.device
    slots = slots.to(torch.int32)
    ins_full = ins_full.to(torch.int32)
    p = slots.shape[0]
    arange_p = torch.arange(p, dtype=torch.int32, device=dev)
    moved = _scatter_set(torch.zeros((n,), dtype=torch.bool, device=dev),
                         slots, torch.ones((p,), dtype=torch.bool, device=dev))
    # pref[j] = number of moved slots < j, for j in [0, n]
    pref = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                      torch.cumsum(moved, 0, dtype=torch.int32)])
    # each run-B row's rank among the survivors, plus its own rank in B
    ins_c = ins_full - pref[ins_full.long()]
    pos_b = ins_c + arange_p
    # a vacated slot shifts every output from its first surviving
    # successor's final position on; ins_c is nondecreasing
    d_m = slots - pref[slots.clamp(0, n).long()]
    e_m = d_m + torch.searchsorted(ins_c, d_m, right=True, out_int32=True)
    bump = torch.zeros((n + 2,), dtype=torch.int32, device=dev)
    bump.index_add_(0, _trash(pos_b + 1, n + 1),
                    torch.full((p,), -1, dtype=torch.int32, device=dev))
    bump.index_add_(0, _trash(e_m, n + 1),
                    torch.ones((p,), dtype=torch.int32, device=dev))
    shift = torch.cumsum(bump[:n], 0, dtype=torch.int32)
    src_a = (torch.arange(n, dtype=torch.int32, device=dev) + shift).clamp(
        0, n - 1)
    b_src = _scatter_set(
        torch.full((n,), -1, dtype=torch.int32, device=dev), pos_b, arange_p)
    return src_a, b_src


def gather_splice(src_a, b_src, val_a, val_b):
    """One payload of a :func:`sparse_splice_plan` merge: two gathers and a
    select.  ``val_a`` is indexed by original slot, ``val_b`` by sorted-B
    rank; trailing payload dimensions broadcast."""
    take_b = b_src >= 0
    bs = b_src.clamp(0, val_b.shape[0] - 1).long()
    if val_a.dim() > 1:
        take_b = take_b.reshape((-1,) + (1,) * (val_a.dim() - 1))
    return torch.where(take_b, val_b[bs], val_a[src_a.long()])
