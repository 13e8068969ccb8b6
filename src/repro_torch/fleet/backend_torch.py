"""Torch fleet backend: the device tick and the fused serve loop.

Counterpart of ``repro.fleet.backend_jax.JaxFleetBackend``.
:meth:`TorchFleetBackend.run_serve` runs a whole serve trace tick by tick
on the device: each tick admits arrivals, every ``dispatch_every`` ticks
sheds, plans and dispatches, then runs one device tick, collection, and at
the dispatch cadence straggler eviction. Where the reference traces this
into one ``lax.scan``, the port runs it as a host loop of device ops; the
cadence test ``i % dispatch_every == 0`` is a host integer test, like the
reference's ``lax.cond``. :meth:`TorchFleetBackend.run` advances a
local-mode (self-sampling) fleet the same way, with no control plane.

``kernel`` selects the device tick:

- ``"f64"``: the float64 tick (``_tick``: harvest, wake, acquire, unit
  progression, emit), the reference's ``kernel="xla"``, in local or
  dispatch mode. Its harvest stage is the hand-written CUDA kernel
  ``kernels.harvest_step`` (one launch per tick on CUDA tensors). The
  data-dependent unit loop is a masked ``while run.any()`` over the fleet,
  as in the reference: one host read of a device value per iteration, the
  only one inside the tick (``host_syncs`` counts them).
- ``"q32"``: the plain PyTorch int32 tick (``fleet.qtick.tick_q``);
- ``"cuda"``: the hand-written CUDA serve-tick kernel
  (``kernels.serve_tick``), one launch per tick, updating the state in
  place. With CUDA tensors this loop reads no device value on the host
  (no ``.item()``, no ``.any()``), so a later change can capture it as a
  CUDA graph.

The quantized kernels are dispatch-only. Every float64 expression keeps
the reference's operand order, and every torch op rounds once, as numpy
does: on the CPU the float64 tick is bit-equal to the reference's NumPy
backend, and the harvest kernel keeps it so on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.energy import (capacitor_draw, capacitor_usable_energy,
                                     capacitor_usable_q)
from repro_torch.core.policies import SKIP, Policy
from repro_torch.fleet import qtick as Q
from repro_torch.fleet import sched as S
from repro_torch.fleet.state import (SCHED_FIELDS, FleetParams, FleetState,
                                     SchedParams, SchedState)
from repro_torch.kernels.harvest_step import harvest_step

TICK_KERNELS = ("q32", "cuda", "f64")


class TorchFleetBackend:
    """Device-resident constants, the device tick and the serve loop for
    one fleet."""

    def __init__(self, params: FleetParams, *, kernel: str = "cuda",
                 device: torch.device | str):
        if kernel not in TICK_KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; choose from "
                             f"{TICK_KERNELS}")
        if kernel != "f64":
            if params.mode != "dispatch":
                raise ValueError(
                    "quantized kernels (q32/cuda) implement the dispatch "
                    "serve tick only; local mode stays float64")
            if params.quantum_j is None:
                raise ValueError("quantized kernels need "
                                 "FleetParams.quantum_j")
        if params.mode == "local" and (
                type(params.policy).decide_batch is Policy.decide_batch):
            # surface a policy without a closed form now, not mid-run
            raise TypeError(
                f"policy {type(params.policy).__name__}'s decide_batch has "
                "no closed form; the torch backend needs one (see "
                "core.policies)")
        self.p = params
        self.kernel = kernel
        self.device = torch.device(device)
        dev = self.device

        def t(x):
            return torch.as_tensor(np.asarray(x), device=dev)

        self.power = t(params.power)
        self.trace_index = t(params.trace_index)
        self.phase = None if params.phase is None else t(params.phase)
        if kernel == "f64":
            self.qp = None
            self.C = t(params.C)
            self.v_max = t(params.v_max)
            self.UC = t(params.UC)
            self.FIX = t(params.FIX)
            self.EMITC = t(params.EMITC)
            # one tick of active draw per worker (the reference's
            # active_power_w * dt, the same float64 product)
            self.ESTEP = t(np.asarray(params.active_power_w) * params.dt)
            self.ACC = (None if params.acc is None
                        else t(np.asarray(params.acc, dtype=np.float64)))
        else:
            self.qp = Q.to_device(Q.quantize_fleet(params), dev)
        self.host_syncs = 0  # device reads on the host (unit-loop tests)
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

    # -- device tick ---------------------------------------------------------

    def tick(self, fs: FleetState, i: int) -> tuple[FleetState, tuple]:
        """One device tick at trace index ``i``: returns the state (the
        same object, updated in place, under ``kernel="cuda"``) and the
        4-lane event log (code / time / ticket / units; int32 with tick
        times under the quantized kernels, float64 seconds and int64
        otherwise)."""
        if self.kernel == "f64":
            return self._tick(fs, self._ev0(), i)
        qh = Q.harvest_row(self.p, self.qp, self.trace_index, self.phase, i)
        if self.kernel == "cuda":
            from repro_torch.kernels.serve_tick import serve_tick
            ev, _ = serve_tick(fs, self.qp, qh, i)
            return fs, ev
        rw, ev = Q.tick_q(self.qp, fs, qh, i)
        return dataclasses.replace(fs, **rw), ev

    def run(self, fs: FleetState, i0: int, n_ticks: int) -> FleetState:
        """Advance a local-mode fleet ``n_ticks`` ticks from trace index
        ``i0``; returns the new state. Local mode has no events (emissions
        land in the ``emit_*`` counters); dispatch fleets serve through
        :meth:`run_serve`, whose collection consumes each tick's events."""
        if self.p.mode != "local":
            raise ValueError("run advances a local-mode fleet; dispatch "
                             "fleets serve through run_serve")
        ev = self._ev0()
        for i in range(i0, i0 + n_ticks):
            fs, ev = self._tick(fs, ev, i)
        return fs

    def _ev0(self) -> tuple:
        n, dev = self.p.n, self.device
        return (torch.zeros(n, dtype=torch.int64, device=dev),
                torch.zeros(n, dtype=torch.float64, device=dev),
                torch.zeros(n, dtype=torch.int64, device=dev),
                torch.zeros(n, dtype=torch.int64, device=dev))

    def _usable(self, v):
        return capacitor_usable_energy(v, capacitance_f=self.C,
                                       v_off=self.p.v_off)

    def _draw(self, v, amount):
        return capacitor_draw(v, amount, capacitance_f=self.C,
                              v_off=self.p.v_off)

    def _harvest(self, v, pw):
        # the CUDA kernel for CUDA tensors, its plain version on the CPU
        return harvest_step(v, pw, self.C, self.v_max, eff=self.p.eff,
                            dt=self.p.dt)

    # record events for mask lanes into the fixed-capacity log, first event
    # per worker wins: the int32 tick's recorder serves any lane dtypes
    _rec = staticmethod(Q._rec)

    def _tick(self, s: FleetState, ev: tuple, i: int
              ) -> tuple[FleetState, tuple]:
        """The float64 tick (the reference's ``_tick``)."""
        p = self.p
        t = i * p.dt

        # 1. harvest (mirrors Capacitor.harvest)
        col = (i % p.T) if self.phase is None else (self.phase + i) % p.T
        pw = self.power[self.trace_index, col]
        e_harvest = s.e_harvest + p.eff * pw * p.dt
        v = self._harvest(s.v, pw)

        # 2. turn on at v_on
        waking = ~s.on & (v >= p.v_on)
        on = s.on | waking
        cycles = s.cycles + waking
        working = on & s.has_work
        idle = on & ~s.has_work
        s = dataclasses.replace(s, v=v, on=on, cycles=cycles,
                                e_harvest=e_harvest)

        # 3. acquisition
        if p.mode == "local":
            s = self._acquire_local(s, idle, t)
        else:
            s, ev = self._acquire_dispatch(s, idle, t, ev)

        # 4. progress in-flight work by one dt of active execution
        s, ev, emit_now = self._progress(s, working, t, ev)

        # 5. emission (BLE packet / host transfer)
        finish = (working & s.has_work & s.on
                  & ((s.w_units_done >= s.w_target) | emit_now))
        return self._emit(s, finish, t, ev)

    def _acquire_local(self, s: FleetState, idle, t: float) -> FleetState:
        p = self.p
        due = idle & (t >= s.next_sample_t)
        delta = t - s.next_sample_t
        k = torch.div(delta, p.P, rounding_mode="floor")
        sample_counter = s.sample_counter + torch.where(
            due, k.to(torch.int64) + 1, 0)
        next_sample_t = s.next_sample_t + torch.where(
            due, p.P * (k + 1.0), 0.0)
        # decide BEFORE spending anything (SMART skips the whole round)
        us = self._usable(s.v)
        init, refine = p.policy.decide_batch(us, p.tables[0], p.acc)
        skip = due & (init == SKIP)
        go = due & ~(init == SKIP)
        fixed = self.FIX[0]  # a float64 tensor: two Python floats would
        # make torch.where float32
        v2, ok = self._draw(s.v, torch.minimum(fixed, us))
        succ = go & ok
        return dataclasses.replace(
            s, v=torch.where(go, v2, s.v), on=s.on & ~(go & ~ok),
            skipped=s.skipped + skip, sample_counter=sample_counter,
            next_sample_t=next_sample_t,
            e_work=s.e_work + torch.where(succ, fixed, 0.0),
            acquired=s.acquired + succ,
            has_work=s.has_work | succ,
            w_ticket=torch.where(succ, sample_counter - 1, s.w_ticket),
            w_t_acq=torch.where(succ, t, s.w_t_acq),
            w_cycle_acq=torch.where(succ, s.cycles, s.w_cycle_acq),
            w_units_done=torch.where(succ, 0, s.w_units_done),
            w_left=torch.where(succ, 0.0, s.w_left),
            w_target=torch.where(
                succ, torch.where(refine, int(p.NU[0]), init), s.w_target),
            w_tile=torch.where(succ, 0, s.w_tile),
            w_wl=torch.where(succ, 0, s.w_wl),
            w_batch=torch.where(succ, 1, s.w_batch))

    def _acquire_dispatch(self, s: FleetState, idle, t: float, ev):
        due = idle & s.p_pending
        us = self._usable(s.v)
        fixed = self.FIX[s.p_wl]
        v2, ok = self._draw(s.v, torch.minimum(fixed, us))
        fail = due & ~ok
        succ = due & ok
        ev = self._rec(ev, fail, Q.EV_LOST, t, s.p_ticket, 0)
        return dataclasses.replace(
            s, v=torch.where(due, v2, s.v), on=s.on & ~fail,
            p_pending=s.p_pending & ~due,
            e_work=s.e_work + torch.where(succ, fixed, 0.0),
            acquired=s.acquired + succ,
            has_work=s.has_work | succ,
            w_ticket=torch.where(succ, s.p_ticket, s.w_ticket),
            w_t_acq=torch.where(succ, t, s.w_t_acq),
            w_cycle_acq=torch.where(succ, s.cycles, s.w_cycle_acq),
            w_units_done=torch.where(succ, 0, s.w_units_done),
            w_left=torch.where(succ, 0.0, s.w_left),
            w_tile=torch.where(succ, s.p_units, s.w_tile),
            w_batch=torch.where(succ, s.p_batch, s.w_batch),
            w_target=torch.where(succ, s.p_units * s.p_batch, s.w_target),
            w_wl=torch.where(succ, s.p_wl, s.w_wl)), ev

    def _progress(self, s: FleetState, working, t: float, ev):
        p = self.p
        dispatch = p.mode == "dispatch"
        u_max = p.UC.shape[1]
        e_step = torch.where(working, self.ESTEP, 0.0)
        run = working & (s.w_units_done < s.w_target)
        emit_now = torch.zeros_like(run)
        v, on, has_work, e_work = s.v, s.on, s.has_work, s.e_work
        w_left, w_units_done = s.w_left, s.w_units_done
        emitc = self.EMITC[s.w_wl]
        tile = torch.clamp(s.w_tile, min=1)
        while True:
            # the fleet-wide loop test: the tick's one host read
            self.host_syncs += 1
            if not bool(run.any()):
                break
            # unit boundary: start the next unit only if unit + the emit
            # reserve (the BLE packet) are affordable now; "cant" emits
            # the partial result
            starting = run & (w_left <= 0)
            gidx = torch.where(s.w_tile > 0, w_units_done % tile,
                               w_units_done)
            nc = self.UC[s.w_wl, torch.clamp(gidx, 0, u_max - 1)]
            cant = starting & (self._usable(v) < nc + emitc)
            emit_now = emit_now | cant
            run = run & ~cant
            w_left = torch.where(starting & ~cant, nc, w_left)
            take = torch.minimum(e_step, w_left)
            v2, ok = self._draw(v, take)
            v = torch.where(run, v2, v)
            fail = run & ~ok
            # power failure mid-work: volatile by design; work lost
            on = on & ~fail
            has_work = has_work & ~fail
            if dispatch:
                ev = self._rec(ev, fail, Q.EV_LOST, t, s.w_ticket, 0)
            run = run & ok
            e_work = e_work + torch.where(run, take, 0.0)
            w_left = torch.where(run, w_left - take, w_left)
            e_step = torch.where(run, e_step - take, e_step)
            fin = run & (w_left <= 1e-18)
            w_units_done = w_units_done + fin
            w_left = torch.where(fin, 0.0, w_left)
            run = run & (e_step > 0) & (w_units_done < s.w_target)
        s = dataclasses.replace(s, v=v, on=on, has_work=has_work,
                                e_work=e_work, w_left=w_left,
                                w_units_done=w_units_done)
        return s, ev, emit_now

    def _emit(self, s: FleetState, finish, t: float, ev):
        p = self.p
        ec = self.EMITC[s.w_wl]
        v2, ok = self._draw(s.v, ec)
        efail = finish & ~ok
        esucc = finish & ok
        emit_acc_sum = s.emit_acc_sum
        if p.mode == "dispatch":
            ev = self._rec(ev, efail, Q.EV_LOST, t, s.w_ticket, 0)
            ev = self._rec(ev, esucc, Q.EV_EMIT, t, s.w_ticket,
                           s.w_units_done)
        else:
            emit_acc_sum = emit_acc_sum + torch.where(
                esucc,
                self.ACC[torch.clamp(s.w_units_done, 0, int(p.NU[0]))], 0.0)
        return dataclasses.replace(
            s, v=torch.where(finish, v2, s.v), on=s.on & ~efail,
            # volatile: a failed emission loses the work
            has_work=s.has_work & ~finish,
            e_work=s.e_work + torch.where(esucc, ec, 0.0),
            emit_count=s.emit_count + esucc,
            emit_units_sum=s.emit_units_sum + torch.where(
                esucc, s.w_units_done, 0),
            emit_acc_sum=emit_acc_sum), ev

    # -- fused serve loop ----------------------------------------------------

    def run_serve(self, fs: FleetState, sp: SchedParams, ss: SchedState,
                  arrivals: np.ndarray, *, i0: int = 0,
                  dispatch_every: int = 10
                  ) -> tuple[FleetState, SchedState]:
        """Serve ``arrivals.shape[0]`` ticks from trace index ``i0``.

        ``arrivals`` is the host (n_ticks, W) int64 matrix of per-tick
        arrival counts; ``fs``/``ss`` are the device states. Returns the
        final states (still on the device)."""
        p = self.p
        if p.mode != "dispatch":
            raise ValueError("run_serve needs a dispatch-mode fleet")
        quant = self.kernel != "f64"
        arrivals = np.asarray(arrivals, dtype=np.int64)
        spd = self._sched_params(sp)
        arr_dev = torch.as_tensor(arrivals, device=self.device)
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
                if quant:
                    # quanta -> joules: the reference's exact float64
                    # expression
                    budget_now = (capacitor_usable_q(fs.v, self.qp.E_OFF)
                                  .to(torch.float64) * p.quantum_j)
                else:
                    budget_now = self._usable(fs.v)
                pw_lags = S.power_lags(self.power, self.trace_index, i, p.T,
                                       spd.fc_order, phase=self.phase)
                budget_plan = S.plan_budget(spd, budget_now, pw_lags, p.eff)
                dispatchable = fs.on & ~fs.has_work & ~fs.p_pending
                ss, a = S.dispatch(spd, ss, dispatchable, budget_now,
                                   budget_plan, t)
                # the quantized state stamps int32 ticks, the float64 one
                # seconds
                cast = ((lambda x: x.to(i32)) if quant else (lambda x: x))
                fs = dataclasses.replace(
                    fs,
                    p_pending=fs.p_pending | a.mask,
                    p_wl=torch.where(a.mask, cast(a.wl), fs.p_wl),
                    p_units=torch.where(a.mask, cast(a.units), fs.p_units),
                    p_batch=torch.where(
                        a.mask, cast(torch.clamp(a.batch, min=1)),
                        fs.p_batch),
                    p_t_assigned=torch.where(a.mask, i if quant else t,
                                             fs.p_t_assigned))
            fs, ev = self.tick(fs, i)
            evc, _, _, evu = ev
            ss = S.collect(spd, ss, evc == Q.EV_EMIT, evc == Q.EV_LOST,
                           evu.to(torch.int64), t)
            if is_tick:
                ss, evm = S.evict(spd, ss, t)
                fs = dataclasses.replace(fs, p_pending=fs.p_pending & ~evm,
                                         has_work=fs.has_work & ~evm)
        return fs, SchedState(**ss._asdict())
