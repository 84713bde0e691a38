"""The comparison that decides ``correct``.

Two numbers, each an exact comparison with the limit 0:

- ``rows_differ``: query rows, of a sample drawn from the seed in each
  checked tick, whose ids or distance bits differ from the plain
  reference's;
- ``lists_bad``: rows of the window's last tick, every row, that are no
  valid answer at all: an id out of range or the issuer itself, a distance
  that is not the id's own, or entries not in strictly ascending
  ``(squared distance, id)`` order (which also rules out a repeated id).

``compare`` is the one path to both numbers, for a run of the program and
for the control in its place (``control.py``).  Imports nothing of the
program.
"""
from __future__ import annotations

import numpy as np
import torch

LIMITS = {"rows_differ": 0, "lists_bad": 0}
LIST_BLOCK = 1 << 17


def rows_differ(got_idx, got_dist, want_idx, want_dist) -> int:
    """Rows whose ids differ or whose distances differ in any bit."""
    got_idx = np.asarray(got_idx)
    got_dist = np.ascontiguousarray(got_dist, np.float32)
    want_idx = np.asarray(want_idx)
    want_dist = np.ascontiguousarray(want_dist, np.float32)
    if got_idx.shape != want_idx.shape or got_dist.shape != want_dist.shape:
        return int(want_idx.shape[0])
    bad = (got_idx != want_idx).any(1) | (
        got_dist.view(np.uint32) != want_dist.view(np.uint32)).any(1)
    return int(bad.sum())


def lists_bad(points, qpos, qid, nn_idx, nn_dist, device) -> int:
    """Rows of a full result that are no valid k-NN list (see above)."""
    n, rows = points.shape[0], nn_idx.shape[0]
    if nn_dist.shape != nn_idx.shape or qpos.shape[0] != rows:
        return int(rows)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    bad = 0
    for lo in range(0, rows, LIST_BLOCK):
        hi = min(lo + LIST_BLOCK, rows)
        idx = torch.as_tensor(np.asarray(nn_idx[lo:hi]), device=device).long()
        dist = torch.as_tensor(np.ascontiguousarray(nn_dist[lo:hi],
                                                    np.float32), device=device)
        q = torch.as_tensor(np.asarray(qpos[lo:hi], np.float32), device=device)
        own = torch.as_tensor(np.asarray(qid[lo:hi]), device=device).long()
        in_range = (idx >= 0) & (idx < n)
        p = pts[idx.clamp(0, n - 1)]
        dx = p[..., 0] - q[:, None, 0]
        dy = p[..., 1] - q[:, None, 1]
        d2 = torch.addcmul(dy * dy, dx, dx)
        d = torch.sqrt(d2.double()).float()
        row_ok = (in_range & (idx != own[:, None])
                  & (d.view(torch.int32) == dist.view(torch.int32))).all(1)
        # strictly ascending (squared distance, id): the order is decided on
        # the squared distance, which the square root can merge; both are
        # >= 0, so their bits order as the floats do
        key = (d2.view(torch.int32).long() << 32) | idx
        row_ok &= (key[:, 1:] > key[:, :-1]).all(1)
        bad += int((~row_ok).sum())
    return bad


def compare(reference, traffic, answers: dict, last, k: int, device):
    """Both numbers, each beside its limit, and the rows compared.

    ``answers`` maps each checked step to ``(rows, ids, dists)``: the
    answers that the side under test gave for those query rows, which the
    configuration's ``reference`` works out again from the positions that
    ``traffic`` held at that step.  ``last`` is ``(points, qpos, qid, ids,
    dists)`` of a whole tick, or of some of its rows, for ``lists_bad``.
    """
    differ = rows_checked = 0
    for step, pos in traffic.held_positions(answers):
        rows, got_i, got_d = answers[step]
        pts = torch.as_tensor(pos, device=device)
        sel = torch.as_tensor(rows, device=device)
        want_i, want_d = reference.knn(pts, pts[sel], sel, k)
        differ += rows_differ(got_i, got_d, want_i.cpu().numpy(),
                              want_d.cpu().numpy())
        rows_checked += len(rows)
        del pts
    bad = lists_bad(*last, device)
    checks = {"rows_differ": {"value": differ, "limit": LIMITS["rows_differ"]},
              "lists_bad": {"value": bad, "limit": LIMITS["lists_bad"]}}
    return checks, rows_checked


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
