"""Torch fleet backend: the fused serve loop (workers and scheduler).

Counterpart of ``repro.fleet.backend_jax.JaxFleetBackend.run_serve``: the
whole serve trace runs tick by tick on the device, each tick admitting
arrivals, every ``dispatch_every`` ticks shedding, planning and
dispatching, then one device tick, collection, and at the dispatch
cadence straggler eviction. Where the reference traces this into one
``lax.scan``, the port runs it as a host loop of device ops; the
cadence test ``i % dispatch_every == 0`` is a host integer test, like the
reference's ``lax.cond``.

``kernel`` selects the device tick:

- ``"q32"``: the plain PyTorch int32 tick (``fleet.qtick.tick_q``);
- ``"cuda"``: the hand-written CUDA serve-tick kernel
  (``kernels.serve_tick``), one launch per tick, updating the state in
  place. With CUDA tensors this loop reads no device value on the host
  (no ``.item()``, no ``.any()``), so a later change can capture it as a
  CUDA graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.energy import capacitor_usable_q
from repro_torch.fleet import qtick as Q
from repro_torch.fleet import sched as S
from repro_torch.fleet.state import (SCHED_FIELDS, FleetParams, FleetState,
                                     SchedParams, SchedState)

TICK_KERNELS = ("q32", "cuda")


class TorchFleetBackend:
    """Device-resident constants and the serve loop for one fleet."""

    def __init__(self, params: FleetParams, *, kernel: str = "cuda",
                 device: torch.device | str):
        if kernel not in TICK_KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; choose from "
                             f"{TICK_KERNELS}")
        self.p = params
        self.kernel = kernel
        self.device = torch.device(device)
        dev = self.device
        self.qp = Q.to_device(Q.quantize_fleet(params), dev)
        self.power = torch.as_tensor(params.power, device=dev)
        self.trace_index = torch.as_tensor(params.trace_index, device=dev)
        self.phase = (None if params.phase is None
                      else torch.as_tensor(params.phase, device=dev))
        self._sp_host: SchedParams | None = None
        self._sp_dev: SchedParams | None = None

    def _sched_params(self, sp: SchedParams) -> SchedParams:
        """``sp`` on the device, uploaded once; a params object that only
        rebinds the forecast tables re-uploads just those."""
        if not S.sched_params_compatible(self._sp_host, sp):
            self._sp_dev = S.params_to(sp, self.device)
        elif sp is not self._sp_host:
            self._sp_dev = dataclasses.replace(self._sp_dev, **{
                f: torch.as_tensor(getattr(sp, f), device=self.device)
                for f in S.FC_FIELDS})
        self._sp_host = sp
        return self._sp_dev

    def tick(self, fs: FleetState, i: int) -> tuple[FleetState, tuple]:
        """One device tick at trace index ``i``: returns the state (the
        same object, updated in place, under ``kernel="cuda"``) and the
        4-lane int32 event log."""
        qh = Q.harvest_row(self.p, self.qp, self.trace_index, self.phase, i)
        if self.kernel == "cuda":
            from repro_torch.kernels.serve_tick import serve_tick
            ev, _ = serve_tick(fs, self.qp, qh, i)
            return fs, ev
        rw, ev = Q.tick_q(self.qp, fs, qh, i)
        return dataclasses.replace(fs, **rw), ev

    def run_serve(self, fs: FleetState, sp: SchedParams, ss: SchedState,
                  arrivals: np.ndarray, *, i0: int = 0,
                  dispatch_every: int = 10
                  ) -> tuple[FleetState, SchedState]:
        """Serve ``arrivals.shape[0]`` ticks from trace index ``i0``.

        ``arrivals`` is the host (n_ticks, W) int64 matrix of per-tick
        arrival counts; ``fs``/``ss`` are the device states. Returns the
        final states (still on the device)."""
        p = self.p
        arrivals = np.asarray(arrivals, dtype=np.int64)
        spd = self._sched_params(sp)
        arr_dev = torch.as_tensor(arrivals, device=self.device)
        e_off = self.qp.E_OFF
        i32 = torch.int32
        ss = S.SS(*(getattr(ss, f) for f in SCHED_FIELDS))
        for j in range(arrivals.shape[0]):
            i = i0 + j
            t = i * p.dt
            if arrivals[j].any():  # host array: no device read
                ss = S.admit(spd, ss, arr_dev[j], t)
            is_tick = i % dispatch_every == 0
            if is_tick:
                ss = S.shed(spd, ss, t)
                # quanta -> joules: the reference's exact float64 expression
                budget_now = (capacitor_usable_q(fs.v, e_off)
                              .to(torch.float64) * p.quantum_j)
                pw_lags = S.power_lags(self.power, self.trace_index, i, p.T,
                                       spd.fc_order, phase=self.phase)
                budget_plan = S.plan_budget(spd, budget_now, pw_lags, p.eff)
                dispatchable = fs.on & ~fs.has_work & ~fs.p_pending
                ss, a = S.dispatch(spd, ss, dispatchable, budget_now,
                                   budget_plan, t)
                fs = dataclasses.replace(
                    fs,
                    p_pending=fs.p_pending | a.mask,
                    p_wl=torch.where(a.mask, a.wl.to(i32), fs.p_wl),
                    p_units=torch.where(a.mask, a.units.to(i32), fs.p_units),
                    p_batch=torch.where(
                        a.mask, torch.clamp(a.batch, min=1).to(i32),
                        fs.p_batch),
                    p_t_assigned=torch.where(a.mask, i, fs.p_t_assigned))
            fs, ev = self.tick(fs, i)
            evc, _, _, evu = ev
            ss = S.collect(spd, ss, evc == Q.EV_EMIT, evc == Q.EV_LOST,
                           evu.to(torch.int64), t)
            if is_tick:
                ss, evm = S.evict(spd, ss, t)
                fs = dataclasses.replace(fs, p_pending=fs.p_pending & ~evm,
                                         has_work=fs.has_work & ~evm)
        return fs, SchedState(**ss._asdict())
