"""Compiled per-row harvest forecast tables (host-side numpy).

This slice serves ``--sched reactive`` only, which never reads a forecast:
it carries the trivial zero table that ``make_sched_params`` builds, so the
control-plane parameters keep the reference's shape. The forecaster fits
(OU, occlusion, burst, AR(p)) come with ``--sched forecast``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FORECASTER_NAMES = ("ou", "occlusion", "burst", "arp")
FORECASTER_MODES = FORECASTER_NAMES + ("auto",)


@dataclasses.dataclass(frozen=True)
class RowForecast:
    """Per-row compiled forecast coefficients (one row per worker).

    order: lag window P (ticks); MU: (R,) affine base, W; W: (R, P) lag
    weights; THRESH: (R,) regime threshold, W (+inf: no regime step);
    HI/LO: (R,) regime addends, W; model: (R,) int8 forecaster code."""

    order: int
    MU: np.ndarray
    W: np.ndarray
    THRESH: np.ndarray
    HI: np.ndarray
    LO: np.ndarray
    model: np.ndarray


def zero_row_forecast(R: int, order: int = 1) -> RowForecast:
    """The zero-inflow prior: forecast 0 W unconditionally."""
    z = np.zeros(R)
    return RowForecast(order=int(order), MU=z, W=np.zeros((R, order)),
                       THRESH=np.full(R, np.inf), HI=z, LO=z,
                       model=np.zeros(R, dtype=np.int8))
