"""Fleet workload adapters for the paper's three scenarios (analytic proxies).

A ``FleetWorkload`` is what the scheduler needs to price and route a
request: a ``CostTable`` (joules per knob unit), an accuracy table
(``accuracy[k]`` = expected accuracy with ``k`` units) and a SMART admission
floor. Counterpart of ``repro.fleet.workloads``; the measured variants
(``real=True``, per-sample ``qtab`` tables) come with the quality slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.budget import CostTable
from repro_torch.core.energy import McuEnergyModel
from repro_torch.core.profile_tables import (decode_layer_cost_table,
                                             har_cost_table,
                                             harris_cost_table)

# HAR feature families in pipeline order (8 signals x (10 statistics + 7
# FFT bands) + 4 correlations = 140): drives the per-feature energy table
_N_BANDS = 7
FEATURE_FAMILIES: list[str] = []
for _s in range(8):
    FEATURE_FAMILIES += ["mean", "std", "mad", "minmax", "minmax", "energy",
                         "skew", "kurt", "fft_dom", "fft_entropy"]
    FEATURE_FAMILIES += ["fft_band"] * _N_BANDS
FEATURE_FAMILIES += ["corr"] * 4


@dataclasses.dataclass(frozen=True)
class FleetWorkload:
    """What the control plane needs to price, route and score one request
    class. The measured per-sample tables (``qtab``) of the reference come
    with the quality slice; the ledger scores against proxy rows."""

    name: str
    costs: CostTable
    accuracy: np.ndarray  # (n_units + 1,)
    floor: float = 0.0  # SMART admission floor; 0 -> greedy admission

    def __post_init__(self):
        if self.accuracy.shape[0] != self.costs.n_units + 1:
            raise ValueError("accuracy table must have n_units+1 entries")


def har_workload(*, floor: float = 0.8, scale: float = 90.0
                 ) -> FleetWorkload:
    """Anytime SVM over the 140-feature HAR pipeline, analytic proxy:
    identity feature order, accuracy saturating from chance (1/6) toward
    the trained SVM's ~0.92 plateau."""
    n = len(FEATURE_FAMILIES)
    costs = har_cost_table(FEATURE_FAMILIES, np.arange(n), scale=scale)
    k = np.arange(n + 1) / n
    acc = 1.0 / 6.0 + (0.92 - 1.0 / 6.0) * k ** 0.14
    return FleetWorkload("har", costs, acc, floor)


def harris_workload(*, floor: float = 0.8, n_taps: int = 25,
                    img_px: int = 128 * 128) -> FleetWorkload:
    """Perforated Harris corners; corner-set equivalence modelled as a
    logistic in the kept-tap fraction."""
    costs = harris_cost_table(n_taps=n_taps, img_px=img_px)
    k = np.arange(n_taps + 1) / n_taps
    acc = 1.0 / (1.0 + np.exp(-(k - 0.48) / 0.085))
    acc[-1] = 1.0  # all taps == exact computation
    return FleetWorkload("harris", costs, acc, floor)


def lm_workload(cfg=None, *, floor: float = 0.7, kv_len: int = 256,
                edge_flops: float = 5e9,
                edge_power_w: float | None = None) -> FleetWorkload:
    """Anytime LM decode: one knob unit = one decoder layer of ``cfg``
    (default stablelm-1.6b), priced in seconds by the decode FLOP model
    and converted to joules at the edge device's active power."""
    if cfg is None:
        from repro_torch.configs.stablelm_1_6b import CONFIG as cfg
    mcu = McuEnergyModel()
    p_w = edge_power_w if edge_power_w is not None else mcu.active_power_w
    sec = decode_layer_cost_table(cfg, kv_len, 1,
                                  flops_per_second=edge_flops)
    costs = CostTable(unit_costs=sec.unit_costs * p_w,
                      emit_cost=sec.emit_cost * p_w,  # final norm + LM head
                      fixed_cost=50e-6)  # tokenization / request setup
    d = np.arange(cfg.n_layers + 1)
    # the planner's depth-coherence proxy
    acc = np.clip((d / cfg.n_layers) ** 0.5, 1e-3, 1.0)
    acc[0] = 1e-3
    return FleetWorkload("lm", costs, acc, floor)
