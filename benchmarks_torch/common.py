"""Shared pieces of the port's chip scripts in this directory."""
from __future__ import annotations

import subprocess

import numpy as np


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def move_one_percent(pos: np.ndarray, side: float, g: np.random.Generator):
    """Move 1% of the objects up to 200 u in place; returns (ids, new rows)."""
    n = pos.shape[0]
    ids = g.choice(n, n // 100, replace=False).astype(np.int32)
    ang = g.uniform(0, 2 * np.pi, ids.size)
    r = g.uniform(0, 200.0, ids.size)
    new = pos[ids] + np.stack([np.cos(ang), np.sin(ang)], 1) * r[:, None]
    new = np.clip(new, 0, side - 1e-3).astype(np.float32)
    pos[ids] = new
    return ids, new
