"""Per-unit cost tables for an approximation knob (host-side numpy).

Counterpart of ``repro.core.budget.CostTable`` (host-side numpy, with a
per-device copy of the cumulative table for the policies); the budget
meters of the reference are not on the serve path and are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
    _on_device: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)

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

    def cumulative_on(self, device: torch.device) -> torch.Tensor:
        """:meth:`cumulative` as a float64 tensor on ``device``, uploaded
        once per device: a host-to-device copy inside the tick loop would
        wait for the device."""
        t = self._on_device.get(device)
        if t is None:
            t = torch.as_tensor(self.cumulative(), device=device)
            self._on_device[device] = t
        return t
