"""Vectorized intermittent worker pool: N devices in lockstep on one device.

Counterpart of ``repro.fleet.worker.FleetWorkerPool``, with the state on
``device`` and every tick run by :class:`TorchFleetBackend`. Two request
modes:

- ``local``: each worker samples its own sensor every
  ``sampling_period_s`` and runs the configured policy (the
  independent-workers baseline); :meth:`FleetWorkerPool.run` advances it.
  Local mode runs the float64 tick (``kernel="f64"``).
- ``dispatch``: workers idle until the scheduler assigns them a batch of
  requests; the whole serve trace runs through
  :meth:`FleetWorkerPool.run_serve`. ``kernel="f64"`` runs the float64
  tick (its harvest stage the CUDA ``harvest_step`` kernel),
  ``kernel="cuda"`` the int32 tick as one launch of the CUDA serve-tick
  kernel, ``kernel="q32"`` the same tick in plain PyTorch.

The persistence disciplines are not ported yet.
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
from repro_torch.core.policies import Policy
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
                 policy: Policy | None = None,
                 accuracy_table: np.ndarray | None = None,
                 sampling_period_s: float = 10.0,
                 mcu: McuEnergyModel | None = None,
                 cap: Capacitor | None = None,
                 capacitance_f: np.ndarray | float | None = None,
                 v_max: np.ndarray | float | None = None,
                 active_power_w: np.ndarray | float | None = None,
                 kernel: str = "cuda",
                 persist: str = "none",
                 device: str | torch.device = DEFAULT_DEVICE):
        if mode not in ("local", "dispatch"):
            raise ValueError(f"unknown pool mode {mode!r}")
        if kernel not in TICK_KERNELS:
            raise NotImplementedError(
                f"kernel {kernel!r} is not ported yet; choose from "
                f"{TICK_KERNELS}")
        if kernel != "f64" and mode != "dispatch":
            raise ValueError(
                "quantized kernels (q32/cuda) implement the dispatch serve "
                "tick only; local mode stays float64 (kernel='f64')")
        if persist != "none":
            raise NotImplementedError(f"persist={persist!r} is not ported yet")
        self.device = resolve_device(device)
        power = np.asarray(power_w, dtype=np.float64)
        if power.ndim != 2:
            raise ValueError("power_w must be (n_traces, T)")
        T = power.shape[1]
        n = int(n_workers if n_workers is not None else power.shape[0])
        if mode == "local" and (policy is None or accuracy_table is None
                                or len(workloads) != 1):
            raise ValueError("local mode needs exactly one workload table, "
                             "a policy and an accuracy table")
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
            dt=float(dt), n=n, T=T, mode=mode, power=power,
            trace_index=(np.arange(n) % power.shape[0]
                         if trace_index is None
                         else np.asarray(trace_index, dtype=np.int64)),
            phase=(None if phase is None
                   else np.asarray(phase, dtype=np.int64) % T),
            C=C, v_max=vmax, v_on=float(cap.v_on), v_off=float(cap.v_off),
            eff=float(cap.booster_eff), active_power_w=AP,
            UC=UC, FIX=FIX, EMITC=EMITC, NU=NU, tables=tuple(workloads),
            P=float(sampling_period_s), policy=policy, acc=accuracy_table,
            quantum_j=None if kernel == "f64" else DEFAULT_QUANTUM_J)
        self.kernel = kernel
        self._torch: TorchFleetBackend | None = None
        self.reset()

    @property
    def dt(self) -> float:
        return self.params.dt

    @property
    def emitted_count(self) -> int:
        return int(self.state.emit_count.sum())

    def reset(self) -> None:
        """Fresh per-worker state (discharged capacitors, zero counters);
        params and the device constants are kept."""
        self.state = init_state(self.params.n, device=self.device,
                                quantized=self.kernel != "f64")
        self.steps_done = 0

    def _backend(self) -> TorchFleetBackend:
        if self._torch is None:
            self._torch = TorchFleetBackend(self.params, kernel=self.kernel,
                                            device=self.device)
        return self._torch

    def step_macro(self, i0: int, n_ticks: int) -> None:
        """Advance a local-mode pool ``n_ticks`` ticks from trace index
        ``i0``."""
        self.state = self._backend().run(self.state, i0, n_ticks)
        self.steps_done = i0 + n_ticks

    def run(self, n_steps: int | None = None) -> PoolStats:
        """Run a local-mode pool from the start of the trace for
        ``n_steps`` ticks (default: the whole trace); returns its stats."""
        self.step_macro(0, self.params.T if n_steps is None else n_steps)
        return self.stats()

    def run_serve(self, sched, arrivals: np.ndarray, *,
                  dispatch_every: int = 10) -> None:
        """Serve the (n_ticks, W) arrival counts through the device loop;
        ``sched`` is a ``FleetScheduler`` whose state advances in place."""
        self.state, sched.state = self._backend().run_serve(
            self.state, sched.params, sched.state, arrivals,
            i0=self.steps_done, dispatch_every=dispatch_every)
        self.steps_done += int(np.asarray(arrivals).shape[0])

    def stats(self) -> PoolStats:
        s, _ = to_numpy(self.state)
        # quantized pools account energy in integer quanta; convert to
        # joules at this reporting boundary (summed on the host)
        q = self.params.quantum_j
        e_scale = 1.0 if q is None else q
        return PoolStats(
            n_workers=self.params.n,
            emitted=int(s.emit_count.sum()),
            acquired=int(s.acquired.sum()),
            skipped=int(s.skipped.sum()),
            power_cycles=int(s.cycles.sum()),
            energy_harvested_j=float(s.e_harvest.sum()) * e_scale,
            energy_on_work_j=float(s.e_work.sum()) * e_scale,
            energy_on_nvm_j=float(s.e_persist.sum()) * e_scale,
            energy_on_sleep_j=0.0,
            duration_s=self.steps_done * self.params.dt)
