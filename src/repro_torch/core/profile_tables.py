"""Offline cost tables (the paper's EPIC energy-profiling role), host-side.

Counterpart of ``repro.core.profile_tables``: per-feature HAR costs from a
cycle model of the MSP430 extractors, per-tap Harris costs, and per-layer
decode costs from analytic FLOP counts.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.budget import CostTable
from repro_torch.core.energy import McuEnergyModel

# cycles per 128-sample window on MSP430 (fixed-point), per feature family
_FEATURE_FAMILY_CYCLES = {
    "mean": 1200.0,
    "std": 2600.0,
    "mad": 5200.0,
    "minmax": 900.0,
    "energy": 1700.0,
    "skew": 4200.0,
    "kurt": 4600.0,
    "corr": 3800.0,
    # a shared 128-pt FFT amortised over the features that consume it
    "fft_dom": 9500.0,
    "fft_entropy": 11000.0,
    "fft_band": 7800.0,
}


def har_feature_costs(feature_families: list[str],
                      mcu: McuEnergyModel | None = None) -> np.ndarray:
    """Energy (J) to add each feature, in pipeline order."""
    mcu = mcu or McuEnergyModel()
    cyc = np.array([_FEATURE_FAMILY_CYCLES[f] for f in feature_families])
    return cyc / mcu.mcu_hz * mcu.active_power_w


def har_cost_table(feature_families: list[str], order: np.ndarray,
                   mcu: McuEnergyModel | None = None,
                   scale: float = 12.0) -> CostTable:
    """CostTable in anytime (importance) order, incl. sampling + BLE costs;
    ``scale`` calibrates per-feature cost to the paper's regime."""
    mcu = mcu or McuEnergyModel()
    per_feature = scale * har_feature_costs(feature_families, mcu)[order]
    return CostTable(unit_costs=per_feature,
                     emit_cost=mcu.ble_packet_j,
                     fixed_cost=mcu.sample_window_j)


def harris_cost_table(n_taps: int = 25, img_px: int = 128 * 128,
                      cycles_per_px_tap: float = 50.0,
                      fixed_cycles_per_px: float = 150.0,
                      mcu: McuEnergyModel | None = None) -> CostTable:
    """Corner detection: one unit = one Gaussian tap pass of the 25-tap
    structure-tensor accumulation; the fixed part covers Sobel, products,
    response and NMS plus loading the picture."""
    mcu = mcu or McuEnergyModel()
    per_tap = cycles_per_px_tap * img_px / mcu.mcu_hz * mcu.active_power_w
    fixed = fixed_cycles_per_px * img_px / mcu.mcu_hz * mcu.active_power_w
    return CostTable(unit_costs=np.full(n_taps, per_tap),
                     emit_cost=mcu.ble_packet_j,
                     fixed_cost=fixed + mcu.image_load_j)


def decode_layer_flops(d_model: int, n_heads: int, n_kv: int, d_ff: int,
                       kv_len: int, batch: int, moe_experts: int = 0,
                       moe_topk: int = 0) -> float:
    """Per-token decode FLOPs of one layer with a kv_len cache."""
    d_head = d_model // n_heads
    qkvo = 2 * batch * d_model * (2 * n_heads * d_head + 2 * n_kv * d_head)
    attn = 2 * 2 * batch * n_heads * kv_len * d_head
    if moe_experts:
        ff = 2 * batch * moe_topk * 3 * d_model * d_ff \
            + 2 * batch * d_model * moe_experts
    else:
        ff = 2 * batch * 3 * d_model * d_ff
    return float(qkvo + attn + ff)


def decode_layer_cost_table(cfg, kv_len: int, batch: int, *,
                            flops_per_second: float) -> CostTable:
    """Per-layer decode cost table, in seconds, for early-exit depth: the
    ``decode=True`` case of the reference's ``layer_cost_table``. Emission
    covers the final norm + LM head."""
    per_layer = decode_layer_flops(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, kv_len, batch)
    head = 2 * batch * cfg.d_model * cfg.vocab_size
    return CostTable(
        unit_costs=np.full(cfg.n_layers, per_layer / flops_per_second),
        emit_cost=head / flops_per_second,
        fixed_cost=0.0)
