"""ResultSink — per-tick result consumers on the device, in PyTorch.

Counterpart of ``repro/api/sink.py``.  Under ``ServiceSpec(collect="stats")``
the session feeds each tick's padded ``(Qp, k)`` lists to a
:class:`StatsSink` right behind the tick's work on the same stream, and only
the O(Q) aggregates reach the host: the k-th distance per query, its drift
since the last tick, how much the neighbour sets churned, and which object
shard served each reported neighbour.  Under ``collect="none"`` nothing does.

The sink's state (the previous tick's ids and k-th distances) stays on the
device, with the reference's sentinel: ``prev_kth = -1`` marks a row with no
previous observation (the first tick, or after the registry's row set
changed), for which drift reports 0 and churn 1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TickAggregates", "SinkState", "init_sink_state", "ResultSink",
           "StatsSink"]

# rows per block of the (rows, k, k) id match: 2**26 comparisons, 64 MiB of
# booleans, whatever k is
_MATCH_CELLS = 1 << 26


class TickAggregates(NamedTuple):
    """O(Q) / O(1) per-tick aggregates, computed on the device.

    ``kth_dist`` is padded to the registry batch (rows >= ``n_live`` are
    padding: slice before use, as ``TickResult.kth_dist`` does); every other
    field is already reduced over live rows only.
    """

    kth_dist: torch.Tensor  # (Qp,) f32, Euclidean k-th distance per query
    kth_drift_mean: torch.Tensor  # () f32, mean |kth - prev_kth|, live+finite
    kth_drift_max: torch.Tensor  # () f32
    churn_mean: torch.Tensor  # () f32, mean fraction of new neighbour ids
    churn_max: torch.Tensor  # () f32
    shard_hits: torch.Tensor  # (R_o,) f32, reported hits per object shard
    n_live: torch.Tensor  # () i32, live rows the reductions covered


class SinkState(NamedTuple):
    """The sink's memory across ticks, on the device."""

    prev_idx: torch.Tensor  # (Qp, k) i32; -1 = no entry
    prev_kth: torch.Tensor  # (Qp,) f32; -1 = no previous observation


def init_sink_state(qp: int, k: int, device) -> SinkState:
    return SinkState(
        prev_idx=torch.full((qp, k), -1, dtype=torch.int32, device=device),
        prev_kth=torch.full((qp,), -1.0, dtype=torch.float32, device=device),
    )


def _kept_counts(nn_idx: torch.Tensor, prev_idx: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Per row, how many valid current ids appear in the previous row.

    The reference compares all ``(Qp, k, k)`` pairs at once; the count is an
    integer, so comparing them a block of rows at a time gives the same
    value without a ``Qp * k * k`` tensor.
    """
    qp, k = nn_idx.shape
    blk = max(1, _MATCH_CELLS // max(k * k, 1))
    kept = torch.empty((qp,), dtype=torch.int64, device=nn_idx.device)
    for b in range(0, qp, blk):
        cur = nn_idx[b:b + blk]
        prev = prev_idx[b:b + blk]
        match = (cur[:, :, None] == prev[:, None, :]) & (prev[:, None, :] >= 0)
        kept[b:b + blk] = (match.any(dim=2) & valid[b:b + blk]).sum(dim=1)
    return kept


def _stats_update(state: SinkState, nn_idx: torch.Tensor,
                  nn_dist: torch.Tensor, index, bounds, n_live: int, *,
                  num_shards: int, use_bounds: bool):
    """(state, R_tau) -> (state', TickAggregates), on the tick's device.

    * **k-th drift**: ``|kth - prev_kth|`` over live rows where both are
      finite (under-full rows carry kth = inf, sentinel rows prev = -1).
    * **churn**: per live row, the fraction of current neighbour ids absent
      from the row's previous list (padding ids -1 never match); 1 for rows
      with no previous observation, 0 for empty rows.
    * **shard hits**: reported neighbour ids counted by owning object shard,
      under the rule delta routing uses (Morton rank // capacity, or the
      intervals of ``bounds`` when ``use_bounds``); padding entries and
      padding rows fall into an extra bin that is sliced off.

    Only device work is queued (no host read): ``n_live`` is the host's own
    row count.  Every field equals the reference's bit for bit except the
    two means, whose f32 sums may add in another order.  ``shard_hits`` is
    an exact integer count rounded once to f32.
    """
    qp, k = nn_idx.shape
    dev = nn_idx.device
    f32 = torch.float32
    live = torch.arange(qp, device=dev) < n_live
    valid = nn_idx >= 0

    kth = nn_dist[:, k - 1].contiguous()
    prev_kth = state.prev_kth
    has_prev = prev_kth >= 0.0
    drift_ok = (live & has_prev & torch.isfinite(kth)
                & torch.isfinite(prev_kth))
    drift = torch.where(drift_ok, (kth - prev_kth).abs(), 0.0)
    n_drift = drift_ok.sum().clamp(min=1).to(f32)
    drift_mean = drift.sum() / n_drift
    zero = torch.zeros((), dtype=f32, device=dev)
    drift_max = torch.maximum(drift.max(), zero)

    kept = _kept_counts(nn_idx, state.prev_idx, valid)
    n_valid = valid.sum(dim=1)
    churn_row = 1.0 - kept.to(f32) / n_valid.clamp(min=1).to(f32)
    churn_row = torch.where(n_valid > 0, churn_row, 0.0)
    churn_row = torch.where(has_prev, churn_row, 1.0)
    churn_live = torch.where(live, churn_row, 0.0)
    denom = torch.full((), max(n_live, 1), dtype=f32, device=dev)
    churn_mean = churn_live.sum() / denom
    churn_max = torch.maximum(churn_live.max(), zero)

    n = index.n_objects
    rank = torch.zeros((n,), dtype=torch.int32, device=dev)
    rank[index.ids.long()] = torch.arange(n, dtype=torch.int32, device=dev)
    flat = nn_idx.reshape(-1)
    ok = (valid & live[:, None]).reshape(-1)
    r = rank.index_select(0, flat.clamp(0, max(n - 1, 0)))
    if use_bounds:
        owner = (torch.searchsorted(bounds.to(torch.int32), r, right=True)
                 - 1).to(torch.int32)
    else:
        owner = r // (-(-n // num_shards))
    owner = torch.where(ok, owner, num_shards)
    shard_hits = torch.bincount(owner.long(), minlength=num_shards + 1)[
        :num_shards].to(f32)

    new_state = SinkState(
        prev_idx=torch.where(live[:, None], nn_idx, -1).to(torch.int32),
        prev_kth=torch.where(live, kth, -1.0),
    )
    agg = TickAggregates(
        kth_dist=kth,
        kth_drift_mean=drift_mean,
        kth_drift_max=drift_max,
        churn_mean=churn_mean,
        churn_max=churn_max,
        shard_hits=shard_hits,
        n_live=torch.full((), n_live, dtype=torch.int32, device=dev),
    )
    return new_state, agg


class ResultSink:
    """Interface: a per-tick consumer of device-resident results.

    ``init(qp, k, device)`` returns the cross-tick state;
    ``update(state, nn_idx, nn_dist, index, bounds, n_live)`` consumes one
    tick's padded ``(Qp, k)`` outputs and returns ``(state', aggregates)``,
    both on the device.  Implementations queue device work only: no host
    read inside.
    """

    def init(self, qp: int, k: int, device):
        raise NotImplementedError

    def update(self, state, nn_idx, nn_dist, index, bounds, n_live):
        raise NotImplementedError


class StatsSink(ResultSink):
    """The ``collect="stats"`` sink: drift, churn and shard hits."""

    def __init__(self, num_obj_shards: int = 1):
        self.num_obj_shards = max(1, int(num_obj_shards))

    def init(self, qp: int, k: int, device) -> SinkState:
        return init_sink_state(qp, k, device)

    def update(self, state, nn_idx, nn_dist, index, bounds, n_live):
        return _stats_update(state, nn_idx, nn_dist, index, bounds, n_live,
                             num_shards=self.num_obj_shards,
                             use_bounds=bounds is not None)
