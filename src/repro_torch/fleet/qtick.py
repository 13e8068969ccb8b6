"""Quantized (int32) serve tick in plain PyTorch: the plain version of the
CUDA serve-tick kernel (``repro_torch.kernels.serve_tick``).

Counterpart of ``repro.fleet.qtick``: the capacitor's stored energy is held
in int32 quanta (``core.energy.quantize_energy``), so harvest, wake, draw
and brown-out are exact integer arithmetic. :func:`tick_q` is the
reference's ``tick_q`` under ``np_while`` written in eager torch: the
data-dependent unit loop is a masked whole-array ``while run.any()`` (one
host sync per iteration), the same global-convergence loop the reference
drives, so it iterates bit-identically. Every stage and mask mirrors the
reference line for line, approximate discipline (``persist="none"``) only.
int32 adds wrap at 2**31 as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.energy import (capacitor_draw_q, capacitor_harvest_q,
                                     capacitor_usable_q, quantize_energy)
from repro_torch.fleet.state import FleetParams

# event codes of the fixed-capacity per-worker log
EV_NONE, EV_EMIT, EV_LOST = 0, 1, 2

# +inf unit-cost padding maps to this sentinel: never affordable (the
# cant-start check adds EMITCQ, so it stays clear of int32 overflow)
BIG_Q = 2 ** 30

# the dispatch tick's read-write state fields (kernel argument order) and
# its read-only pending-assignment fields
RW_FIELDS = ("v", "on", "cycles", "acquired", "e_work", "e_harvest",
             "has_work", "w_ticket", "w_t_acq", "w_cycle_acq",
             "w_units_done", "w_left", "w_target", "w_tile", "w_wl",
             "w_batch", "p_pending", "emit_count", "emit_units_sum")
RO_FIELDS = ("p_ticket", "p_wl", "p_units", "p_batch")
BOOL_FIELDS = ("on", "has_work", "p_pending")


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Integer-quanta constants derived from a :class:`FleetParams` by
    :func:`quantize_fleet`: int32 multiples of ``quantum_j``, numpy on the
    host or tensors on a device (:func:`to_device`)."""

    quantum_j: float
    QH: np.ndarray  # (R, T) per-tick banked harvest, quanta
    E_ON: np.ndarray  # (N,) turn-on threshold 0.5 C v_on^2
    E_OFF: np.ndarray  # (N,) brown-out floor 0.5 C v_off^2
    E_MAX: np.ndarray  # (N,) capacitor ceiling 0.5 C v_max^2
    ESTEP: np.ndarray  # (N,) active draw per tick
    UCQ: np.ndarray  # (W, U_max) unit costs, BIG_Q beyond each table
    FIXQ: np.ndarray  # (W,) fixed acquisition cost
    EMITCQ: np.ndarray  # (W,) emission cost


def quantize_fleet(p: FleetParams) -> QuantParams:
    """Quantize every energy constant a dispatch tick reads, on the host,
    with the reference's one ``rint`` rule (identical integers)."""
    q = p.quantum_j
    C = np.asarray(p.C)
    UC = np.asarray(p.UC)
    ucq = np.where(np.isfinite(UC), np.rint(UC / q), float(BIG_Q))
    return QuantParams(
        quantum_j=q,
        QH=quantize_energy(p.eff * np.asarray(p.power) * p.dt, q),
        E_ON=quantize_energy(0.5 * C * p.v_on ** 2, q),
        E_OFF=quantize_energy(0.5 * C * p.v_off ** 2, q),
        E_MAX=quantize_energy(0.5 * C * np.asarray(p.v_max) ** 2, q),
        ESTEP=quantize_energy(np.asarray(p.active_power_w) * p.dt, q),
        UCQ=ucq.astype(np.int32),
        FIXQ=quantize_energy(p.FIX, q),
        EMITCQ=quantize_energy(p.EMITC, q))


def to_device(qp: QuantParams, device: torch.device | str) -> QuantParams:
    """The same pack with every array moved to ``device`` (dtypes kept)."""
    return dataclasses.replace(qp, **{
        f.name: torch.as_tensor(getattr(qp, f.name), device=device)
        for f in dataclasses.fields(qp) if f.name != "quantum_j"})


def harvest_row(p: FleetParams, qp: QuantParams, trace_index: torch.Tensor,
                phase: torch.Tensor | None, i: int) -> torch.Tensor:
    """This tick's (N,) banked quanta: the ``QH`` trace-bank gather."""
    if phase is None:
        return qp.QH[trace_index, i % p.T]
    return qp.QH[trace_index, (phase + i) % p.T]


def _rec(ev, mask, code, ti, ticket, units):
    """First event per worker per tick wins."""
    evc, evt, evtk, evu = ev
    new = mask & (evc == EV_NONE)
    return (torch.where(new, code, evc), torch.where(new, ti, evt),
            torch.where(new, ticket, evtk), torch.where(new, units, evu))


def tick_q(qp: QuantParams, s, qh: torch.Tensor, i: int):
    """One quantized dispatch-mode tick over the (N,) fields in ``s``.

    ``s`` is a :class:`FleetState` (or any object with the
    ``RW_FIELDS + RO_FIELDS`` attributes) in the quantized dtypes (int32,
    bool), ``qh`` this tick's (N,) int32 harvest, ``i`` the tick index.
    Returns ``(rw, ev)``: a new dict of the ``RW_FIELDS`` tensors and the
    4-tuple int32 event log (code / tick / ticket / units). The inputs
    are not modified."""
    i32 = torch.int32
    n = qh.shape[0]
    dev = qh.device
    u_max = qp.UCQ.shape[1]
    zero = torch.zeros(n, dtype=i32, device=dev)
    ev = (zero, zero, zero, zero)

    # 1. harvest: bank quanta, saturate at the capacitor ceiling
    e_harvest = s.e_harvest + qh
    E = capacitor_harvest_q(s.v, qh, qp.E_MAX)

    # 2. turn on at E_ON
    waking = ~s.on & (E >= qp.E_ON)
    on = s.on | waking
    cycles = s.cycles + waking.to(i32)
    working = on & s.has_work
    idle = on & ~s.has_work

    # 3. acquisition (dispatch): claim the pending assignment
    due = idle & s.p_pending
    us = capacitor_usable_q(E, qp.E_OFF)
    fixed = qp.FIXQ[s.p_wl.long()]
    E2, ok = capacitor_draw_q(E, torch.minimum(fixed, us), qp.E_OFF)
    E = torch.where(due, E2, E)
    fail = due & ~ok
    succ = due & ok
    on = on & ~fail
    p_pending = s.p_pending & ~due
    ev = _rec(ev, fail, EV_LOST, i, s.p_ticket, 0)
    e_work = s.e_work + torch.where(succ, fixed, 0)
    acquired = s.acquired + succ.to(i32)
    has_work = s.has_work | succ
    w_ticket = torch.where(succ, s.p_ticket, s.w_ticket)
    w_t_acq = torch.where(succ, i, s.w_t_acq)
    w_cycle_acq = torch.where(succ, cycles, s.w_cycle_acq)
    w_units_done = torch.where(succ, 0, s.w_units_done)
    w_left = torch.where(succ, 0, s.w_left)
    w_tile = torch.where(succ, s.p_units, s.w_tile)
    w_batch = torch.where(succ, s.p_batch, s.w_batch)
    w_target = torch.where(succ, s.p_units * s.p_batch, s.w_target)
    w_wl = torch.where(succ, s.p_wl, s.w_wl)

    # 4. progress in-flight work by one tick of active draw
    wl = w_wl.long()
    emitc_w = qp.EMITCQ[wl]
    e_step = torch.where(working, qp.ESTEP, 0)
    run = working & (w_units_done < w_target)
    emit_now = torch.zeros(n, dtype=torch.bool, device=dev)
    while bool(run.any()):
        # unit boundary: start the next unit only if unit + the emit
        # reserve (the BLE packet) are affordable now; "cant" emits the
        # partial result
        starting = run & (w_left <= 0)
        gidx = torch.where(w_tile > 0,
                           w_units_done % torch.clamp(w_tile, min=1),
                           w_units_done)
        nc = qp.UCQ[wl, torch.clamp(gidx, 0, u_max - 1).long()]
        us = capacitor_usable_q(E, qp.E_OFF)
        cant = starting & (us < nc + emitc_w)
        emit_now = emit_now | cant
        run = run & ~cant
        w_left = torch.where(starting & ~cant, nc, w_left)
        take = torch.minimum(e_step, w_left)
        E2, ok = capacitor_draw_q(E, take, qp.E_OFF)
        E = torch.where(run, E2, E)
        fail = run & ~ok
        # power failure mid-work: volatile by design; work lost
        on = on & ~fail
        has_work = has_work & ~fail
        ev = _rec(ev, fail, EV_LOST, i, w_ticket, 0)
        run = run & ok
        e_work = e_work + torch.where(run, take, 0)
        w_left = torch.where(run, w_left - take, w_left)
        e_step = torch.where(run, e_step - take, e_step)
        fin = run & (w_left <= 0)
        w_units_done = w_units_done + fin.to(i32)
        run = run & (e_step > 0) & (w_units_done < w_target)

    # 5. emission (BLE packet / host transfer)
    finish = (working & has_work & on
              & ((w_units_done >= w_target) | emit_now))
    E2, ok = capacitor_draw_q(E, emitc_w, qp.E_OFF)
    E = torch.where(finish, E2, E)
    efail = finish & ~ok
    esucc = finish & ok
    on = on & ~efail
    has_work = has_work & ~finish  # volatile: failed emission loses it
    ev = _rec(ev, efail, EV_LOST, i, w_ticket, 0)
    ev = _rec(ev, esucc, EV_EMIT, i, w_ticket, w_units_done)
    e_work = e_work + torch.where(esucc, emitc_w, 0)
    emit_count = s.emit_count + esucc.to(i32)
    emit_units_sum = s.emit_units_sum + torch.where(esucc, w_units_done, 0)
    rw = dict(v=E, on=on, cycles=cycles, acquired=acquired, e_work=e_work,
              e_harvest=e_harvest, has_work=has_work, w_ticket=w_ticket,
              w_t_acq=w_t_acq, w_cycle_acq=w_cycle_acq,
              w_units_done=w_units_done, w_left=w_left, w_target=w_target,
              w_tile=w_tile, w_wl=w_wl, w_batch=w_batch, p_pending=p_pending,
              emit_count=emit_count, emit_units_sum=emit_units_sum)
    return rw, ev
