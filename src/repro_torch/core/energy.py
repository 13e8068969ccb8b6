"""Energy environment: harvested-power traces, the capacitor buffer, the
MCU energy model, and the capacitor ops of the float64 and int32 ticks.

Trace synthesis and quantization run on the host in numpy, seeded exactly
as in ``repro.core.energy``, so a power matrix built from the same seed is
bit-identical to the reference's. The ``capacitor_*`` helpers (float64
volts and joules) and the ``capacitor_*_q`` helpers (int32 quanta) act on
torch tensors on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Harvested power traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnergyTrace:
    """Harvested power samples, W, on a fixed grid of ``dt`` seconds."""

    name: str
    power_w: np.ndarray  # shape (T,)
    dt: float  # seconds per sample


def _ou_process(rng: np.random.Generator, n: int, mean: float, theta: float,
                sigma: float) -> np.ndarray:
    """Ornstein-Uhlenbeck sample path; the workhorse for slow solar dynamics."""
    x = np.empty(n)
    x[0] = mean
    for i in range(1, n):
        x[i] = x[i - 1] + theta * (mean - x[i - 1]) + sigma * rng.standard_normal()
    return x


def rf_trace(seed: int = 0, duration_s: float = 600.0, dt: float = 0.01,
             mean_uw: float = 220.0) -> EnergyTrace:
    """RF harvesting (Mementos/WISP-like): on/off bursts with heavy-tailed
    gaps and jittered amplitude; least total energy."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt)
    p = np.zeros(n)
    i = 0
    while i < n:
        burst = int(rng.exponential(0.35) / dt) + 1  # ~0.35 s bursts
        gap = int(rng.pareto(1.5) * 0.3 / dt) + 1  # heavy-tailed gaps
        amp = mean_uw * 1e-6 * rng.uniform(2.0, 6.0)
        p[i:i + burst] = amp * (1.0 + 0.3 * rng.standard_normal(min(burst, n - i)))
        i += burst + gap
    np.clip(p, 0.0, None, out=p)
    # normalise so the configured mean power is exact -> comparable traces
    p *= (mean_uw * 1e-6) / max(p.mean(), 1e-12)
    return EnergyTrace("RF", p, dt)


# name -> (mean_uw, variability, mobility_hz)
_SOLAR_FAMILIES: dict[str, tuple[float, float, float]] = {
    "SOM": (900.0, 1.0, 0.05),
    "SIM": (450.0, 2.0, 0.2),
    "SOR": (650.0, 0.3, 0.0),
    "SIR": (220.0, 0.4, 0.0),
}


def _occlusion_profile(rng: np.random.Generator, n: int, dt: float,
                       mobility_hz: float) -> np.ndarray:
    """Mobile settings: occlusion events as the user moves."""
    occl = np.ones(n)
    t = 0
    while t < n:
        nxt = t + int(rng.exponential(1.0 / mobility_hz) / dt) + 1
        dur = int(rng.uniform(0.2, 3.0) / dt)
        occl[nxt:nxt + dur] = rng.uniform(0.05, 0.5)
        t = nxt + dur
    return occl


def _solar_trace(name: str, seed: int, duration_s: float,
                 dt: float) -> EnergyTrace:
    mean_uw, variability, mobility_hz = _SOLAR_FAMILIES[name]
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt)
    base = _ou_process(rng, n, 1.0, theta=0.002, sigma=0.002 * variability)
    if mobility_hz > 0:
        base = base * _occlusion_profile(rng, n, dt, mobility_hz)
    p = np.clip(base, 0.0, None)
    p *= (mean_uw * 1e-6) / max(p.mean(), 1e-12)
    return EnergyTrace(name, p, dt)


def som_trace(seed: int = 1, duration_s: float = 600.0, dt: float = 0.01) -> EnergyTrace:
    """Solar outdoor mobile: most stable family + highest energy content."""
    return _solar_trace("SOM", seed, duration_s, dt)


def sim_trace(seed: int = 2, duration_s: float = 600.0, dt: float = 0.01) -> EnergyTrace:
    """Solar indoor mobile: moderate energy, frequent occlusions."""
    return _solar_trace("SIM", seed, duration_s, dt)


def sor_trace(seed: int = 3, duration_s: float = 600.0, dt: float = 0.01) -> EnergyTrace:
    """Solar outdoor static: abundant, very stable."""
    return _solar_trace("SOR", seed, duration_s, dt)


def sir_trace(seed: int = 4, duration_s: float = 600.0, dt: float = 0.01) -> EnergyTrace:
    """Solar indoor static: stable but scarce (RF's total energy)."""
    return _solar_trace("SIR", seed, duration_s, dt)


def kinetic_trace(seed: int = 5, duration_s: float = 600.0,
                  dt: float = 0.01) -> EnergyTrace:
    """Wrist kinetic harvesting: walk / idle bouts with OU-modulated
    intensity, ~0.22 mW peak."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt)
    profile = np.zeros(n)
    t = 0
    while t < n:
        active = rng.random() < 0.55
        dur = int(rng.uniform(20, 120) / dt)
        if active:
            profile[t:t + dur] = np.clip(
                _ou_process(rng, min(dur, n - t), 0.8, 0.01, 0.02), 0, 1)
        t += dur
    p = 0.22e-3 * profile * (1 + 0.15 * rng.standard_normal(n))
    return EnergyTrace("KIN", np.clip(p, 0, None), dt)


# the eclipse schedule is fleet-shared: every ECL row draws its occlusion
# windows from this fixed seed, so the whole fleet goes dark together
ECLIPSE_SCHEDULE_SEED = 0xEC1


def _eclipse_mask(n: int, dt: float) -> np.ndarray:
    """Shared lit/dark schedule: lit spans of 4-12 s alternating with
    occlusions of 2-7 s at depth U(0.05, 0.15)."""
    rng = np.random.default_rng(ECLIPSE_SCHEDULE_SEED)
    mask = np.ones(n)
    t = 0
    while t < n:
        lit = int(rng.uniform(4.0, 12.0) / dt) + 1
        dark = int(rng.uniform(2.0, 7.0) / dt) + 1
        depth = rng.uniform(0.05, 0.15)
        mask[t + lit:t + lit + dark] = depth
        t += lit + dark
    return mask


def eclipse_trace(seed: int = 6, duration_s: float = 600.0,
                  dt: float = 0.01,
                  mean_uw: float = 320.0) -> EnergyTrace:
    """ECL: fleet-correlated occlusion harvesting (shared schedule,
    seed-distinct OU texture per row)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt)
    base = _ou_process(rng, n, 1.0, theta=0.002, sigma=0.0016)
    p = np.clip(base, 0.0, None) * _eclipse_mask(n, dt)
    p *= (mean_uw * 1e-6) / max(p.mean(), 1e-12)
    return EnergyTrace("ECL", p, dt)


TRACE_FACTORIES: dict[str, Callable[..., EnergyTrace]] = {
    "RF": rf_trace,
    "SOM": som_trace,
    "SIM": sim_trace,
    "SOR": sor_trace,
    "SIR": sir_trace,
    "KIN": kinetic_trace,
    "ECL": eclipse_trace,
}


def get_trace(name: str, **kw) -> EnergyTrace:
    return TRACE_FACTORIES[name](**kw)


# ---------------------------------------------------------------------------
# Float64 capacitor (the float64 tick)
# ---------------------------------------------------------------------------

# Each expression keeps the reference's operand order, and every op rounds
# once to nearest, like numpy's, so the results are bit-identical to it.


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 square root on any device.

    CUDA's double ``sqrt`` is IEEE round-to-nearest. PyTorch's CPU
    ``sqrt`` goes through MKL's vector math in its high-accuracy mode,
    which is up to 1 ulp off on some inputs, so CPU tensors
    take numpy's IEEE square root, the one the reference computes."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def capacitor_harvest(v, power_w, dt, *, capacitance_f, booster_eff, v_max):
    """New voltage after banking ``power_w * dt``, saturating at ``v_max``
    (the plain version of the ``harvest_step`` kernel)."""
    e = 0.5 * capacitance_f * v * v + booster_eff * power_w * dt
    return torch.minimum(sqrt_rn(2.0 * e / capacitance_f), v_max)


def capacitor_usable_energy(v, *, capacitance_f, v_off):
    """Joules above the brown-out voltage: the budget every policy reads."""
    e = 0.5 * capacitance_f * (v * v - v_off * v_off)
    return torch.clamp(e, min=0.0)


def capacitor_draw(v, energy_j, *, capacitance_f, v_off):
    """``(new_v, ok)``: a draw that would cross the brown-out floor fails
    (``ok`` False) and lands at ``v_off``, the residual charge retained."""
    e = 0.5 * capacitance_f * v * v - energy_j
    floor = 0.5 * capacitance_f * v_off * v_off
    ok = ~torch.lt(e, floor)
    e_safe = torch.where(ok, e, floor)
    return torch.where(ok, sqrt_rn(2.0 * e_safe / capacitance_f),
                       v_off), ok


# ---------------------------------------------------------------------------
# Integer energy quanta (the serve-tick numerics contract)
# ---------------------------------------------------------------------------

# The capacitor's stored energy E = 0.5 C v^2 is held as int32 quanta of
# 1 nJ, which turns harvest, wake, draw and brown-out into linear integer
# arithmetic with exact threshold compares. Per-worker e_work/e_harvest
# accumulators wrap at 2**31 quanta (~2.147 J), as in the reference.
DEFAULT_QUANTUM_J = 1e-9


def quantize_energy(energy_j, quantum_j: float = DEFAULT_QUANTUM_J
                    ) -> np.ndarray:
    """Round joules to int32 energy quanta (``rint``, ties-to-even), on
    the host. Every threshold, harvest increment and cost table passes
    through this one rule."""
    return np.rint(np.asarray(energy_j) / quantum_j).astype(np.int32)


def capacitor_harvest_q(eq: torch.Tensor, harvest_q: torch.Tensor,
                        e_max_q: torch.Tensor) -> torch.Tensor:
    """Bank ``harvest_q`` quanta, saturating at the capacitor ceiling."""
    return torch.minimum(eq + harvest_q, e_max_q)


def capacitor_usable_q(eq: torch.Tensor, e_off_q: torch.Tensor
                       ) -> torch.Tensor:
    """Quanta above the brown-out floor."""
    return torch.clamp(eq - e_off_q, min=0)


def capacitor_draw_q(eq: torch.Tensor, amount_q: torch.Tensor,
                     e_off_q: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(new_eq, ok)``: a draw that would cross the brown-out floor fails
    and lands exactly at ``e_off_q`` (residual charge retained)."""
    left = eq - amount_q
    ok = ~(left < e_off_q)
    return torch.where(ok, left, e_off_q), ok


# ---------------------------------------------------------------------------
# Capacitor buffer and MCU energy model (constants)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Capacitor:
    """Energy buffer constants: the paper's 1470 uF buffer behind a
    BQ25505 booster, with MSP430FR turn-on / brown-out thresholds. The
    fleet reads the constants; the float64 capacitor ops are above."""

    capacitance_f: float = 1470e-6
    v_on: float = 3.5  # booster releases the load
    v_off: float = 1.8  # brown-out
    v_max: float = 3.6
    booster_eff: float = 0.8  # BQ25505 conversion efficiency


@dataclasses.dataclass(frozen=True)
class McuEnergyModel:
    """MSP430FR5659-class energy model (8 MHz). All costs in joules."""

    active_power_w: float = 2.4e-3  # 8 MHz active mode, ~300 uA/MHz @3V
    sleep_power_w: float = 1.2e-6  # LPM3-class standby
    mcu_hz: float = 8e6
    # NVM (FRAM) costs: energy per byte written/read, incl. wait states
    fram_write_j_per_byte: float = 18e-9
    fram_read_j_per_byte: float = 7e-9
    ble_packet_j: float = 120e-6  # 1-byte payload advertisement burst
    sample_window_j: float = 180e-6  # 2.56 s of accel+gyro SPI sampling
    image_load_j: float = 90e-6  # load a test picture (corner app)
