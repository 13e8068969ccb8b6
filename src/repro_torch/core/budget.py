"""Per-unit cost tables for an approximation knob (host-side numpy).

Counterpart of ``repro.core.budget.CostTable``; the budget meters of the
reference are not on the serve path and are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostTable:
    """Per-unit incremental costs for an approximation knob.

    ``unit_costs[i]`` is the *incremental* cost of adding knob unit ``i``
    (the i-th feature, i-th Gaussian tap, i-th layer), in joules.
    ``emit_cost`` is reserved for returning the result (the paper's BLE
    packet); ``fixed_cost`` is paid at acquisition (sampling / setup).
    """

    unit_costs: np.ndarray
    emit_cost: float = 0.0
    fixed_cost: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "unit_costs",
                           np.asarray(self.unit_costs, dtype=np.float64))

    @property
    def n_units(self) -> int:
        return int(self.unit_costs.shape[0])

    def cumulative(self) -> np.ndarray:
        """cumulative[k] = cost of running k units + fixed + emit."""
        return (np.concatenate([[0.0], np.cumsum(self.unit_costs)])
                + self.fixed_cost + self.emit_cost)
