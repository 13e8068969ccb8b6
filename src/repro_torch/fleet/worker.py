"""Vectorized intermittent worker pool: N devices in lockstep on one device.

Counterpart of ``repro.fleet.worker.FleetWorkerPool`` in dispatch mode:
workers idle until the scheduler assigns them a batch of requests; the
whole serve trace runs through :class:`TorchFleetBackend` with the state
on ``device``. ``kernel="cuda"`` runs each tick as one launch of the CUDA
serve-tick kernel, ``kernel="q32"`` as the plain PyTorch int32 tick. The
local (self-sampling) mode, the float64 tick and the persistence
disciplines are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.budget import CostTable
from repro_torch.core.energy import (DEFAULT_QUANTUM_J, Capacitor,
                                     EnergyTrace, McuEnergyModel)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.fleet.backend_torch import TICK_KERNELS, TorchFleetBackend
from repro_torch.fleet.state import (FleetParams, init_state,
                                     stack_cost_tables, to_numpy)

__all__ = ["FleetWorkerPool", "PoolStats", "stack_traces"]


def stack_traces(traces: Sequence[EnergyTrace]) -> np.ndarray:
    """Stack equal-grid traces into the (R, T) power matrix the pool eats."""
    dt = traces[0].dt
    T = traces[0].power_w.shape[0]
    for tr in traces:
        if not math.isclose(tr.dt, dt, rel_tol=1e-9, abs_tol=0.0) \
                or tr.power_w.shape[0] != T:
            raise ValueError("all traces must share dt and length")
    return np.stack([tr.power_w for tr in traces]).astype(np.float64)


@dataclasses.dataclass
class PoolStats:
    """Fleet-level aggregation of the per-worker state arrays."""

    n_workers: int
    emitted: int
    acquired: int
    skipped: int
    power_cycles: int
    energy_harvested_j: float
    energy_on_work_j: float
    energy_on_nvm_j: float  # 0.0 under the approximate discipline
    energy_on_sleep_j: float
    duration_s: float

    @property
    def throughput_per_min(self) -> float:
        return 60.0 * self.emitted / max(self.duration_s, 1e-9)


class FleetWorkerPool:
    """N harvest-powered approximate-intermittent devices in lockstep.

    ``power_w`` is an (R, T) matrix of harvested power (W) on a ``dt``
    grid; ``trace_index`` maps each worker to a row and ``phase`` offsets
    it. ``device`` holds the state and runs the ticks (default CUDA; a
    missing GPU raises)."""

    def __init__(self, power_w: np.ndarray, dt: float, *,
                 workloads: Sequence[CostTable],
                 n_workers: int | None = None,
                 trace_index: np.ndarray | None = None,
                 phase: np.ndarray | None = None,
                 mode: str = "dispatch",
                 mcu: McuEnergyModel | None = None,
                 cap: Capacitor | None = None,
                 capacitance_f: np.ndarray | float | None = None,
                 v_max: np.ndarray | float | None = None,
                 active_power_w: np.ndarray | float | None = None,
                 kernel: str = "cuda",
                 persist: str = "none",
                 device: str | torch.device = DEFAULT_DEVICE):
        if mode != "dispatch":
            raise NotImplementedError(
                f"pool mode {mode!r} is not ported yet (dispatch only)")
        if kernel not in TICK_KERNELS:
            raise NotImplementedError(
                f"kernel {kernel!r} is not ported yet; choose from "
                f"{TICK_KERNELS}")
        if persist != "none":
            raise NotImplementedError(f"persist={persist!r} is not ported yet")
        self.device = resolve_device(device)
        power = np.asarray(power_w, dtype=np.float64)
        if power.ndim != 2:
            raise ValueError("power_w must be (n_traces, T)")
        T = power.shape[1]
        n = int(n_workers if n_workers is not None else power.shape[0])
        cap = cap or Capacitor()
        C = np.broadcast_to(np.asarray(
            cap.capacitance_f if capacitance_f is None else capacitance_f,
            dtype=np.float64), (n,)).copy()
        vmax = np.broadcast_to(np.asarray(
            cap.v_max if v_max is None else v_max,
            dtype=np.float64), (n,)).copy()
        UC, FIX, EMITC, NU = stack_cost_tables(workloads)
        self.mcu = mcu or McuEnergyModel()
        AP = np.broadcast_to(np.asarray(
            self.mcu.active_power_w if active_power_w is None
            else active_power_w, dtype=np.float64), (n,)).copy()
        self.params = FleetParams(
            dt=float(dt), n=n, T=T, power=power,
            trace_index=(np.arange(n) % power.shape[0]
                         if trace_index is None
                         else np.asarray(trace_index, dtype=np.int64)),
            phase=(None if phase is None
                   else np.asarray(phase, dtype=np.int64) % T),
            C=C, v_max=vmax, v_on=float(cap.v_on), v_off=float(cap.v_off),
            eff=float(cap.booster_eff), active_power_w=AP,
            UC=UC, FIX=FIX, EMITC=EMITC, NU=NU,
            quantum_j=DEFAULT_QUANTUM_J)
        self.state = init_state(n, device=self.device)
        self.kernel = kernel
        self.steps_done = 0
        self._torch: TorchFleetBackend | None = None

    @property
    def dt(self) -> float:
        return self.params.dt

    def run_serve(self, sched, arrivals: np.ndarray, *,
                  dispatch_every: int = 10) -> None:
        """Serve the (n_ticks, W) arrival counts through the device loop;
        ``sched`` is a ``FleetScheduler`` whose state advances in place."""
        if self._torch is None:
            self._torch = TorchFleetBackend(self.params, kernel=self.kernel,
                                            device=self.device)
        self.state, sched.state = self._torch.run_serve(
            self.state, sched.params, sched.state, arrivals,
            i0=self.steps_done, dispatch_every=dispatch_every)
        self.steps_done += int(np.asarray(arrivals).shape[0])

    def stats(self) -> PoolStats:
        s, _ = to_numpy(self.state)
        # the state accounts energy in integer quanta; convert to joules
        q = self.params.quantum_j
        return PoolStats(
            n_workers=self.params.n,
            emitted=int(s.emit_count.sum()),
            acquired=int(s.acquired.sum()),
            skipped=int(s.skipped.sum()),
            power_cycles=int(s.cycles.sum()),
            energy_harvested_j=float(s.e_harvest.sum()) * q,
            energy_on_work_j=float(s.e_work.sum()) * q,
            energy_on_nvm_j=float(s.e_persist.sum()) * q,
            energy_on_sleep_j=0.0,
            duration_s=self.steps_done * self.params.dt)
