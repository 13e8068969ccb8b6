"""Struct-of-arrays fleet state: the contract between the host and the device.

``FleetParams`` is everything static about a fleet run (trace bank, stacked
workload tables, capacitor constants, local-mode policy) and stays
host-side numpy, exactly as in ``repro.fleet.state``. ``FleetState`` holds
one length-N tensor per field on the run's device, in the float64 contract
(volts, joules, seconds, int64 counters) or the int32-quantized one of the
serve-tick kernel (``init_state``). ``SchedParams`` (numpy constants) and
``SchedState`` (tensors) are the control plane's.

``from_reference`` / ``to_numpy`` move the reference's numpy dataclasses in
and out with every dtype kept, so the differential tests feed both sides
the same state.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import policies
from repro_torch.core.budget import CostTable
from repro_torch.core.policies import Policy


@dataclasses.dataclass(frozen=True)
class FleetParams:
    """Static per-run configuration of a fleet (numpy)."""

    dt: float
    n: int  # workers
    T: int  # trace length (ticks)
    mode: str  # "local" | "dispatch"
    power: np.ndarray  # (R, T) harvested power, W
    trace_index: np.ndarray  # (N,) worker -> trace row
    phase: np.ndarray | None  # (N,) tick offset into the row, or None
    C: np.ndarray  # (N,) farads
    v_max: np.ndarray  # (N,)
    v_on: float
    v_off: float
    eff: float  # booster efficiency
    active_power_w: np.ndarray  # (N,) MCU active draw
    # stacked workload tables: (W, U_max) unit costs padded with +inf
    UC: np.ndarray
    FIX: np.ndarray  # (W,)
    EMITC: np.ndarray  # (W,)
    NU: np.ndarray  # (W,) int64
    tables: tuple[CostTable, ...]
    # local mode only
    P: float  # sampling period, s
    policy: Policy | None
    acc: np.ndarray | None  # (n_units + 1,) accuracy table
    # quantized serve tick (kernel "q32"/"cuda"): energies are int32
    # quanta of this many joules and FleetState.v holds the stored energy
    # E = 0.5 C v^2 in quanta. None: the float64 tick (volts, joules).
    quantum_j: float | None = None


@dataclasses.dataclass
class FleetState:
    """Everything one lockstep tick reads or writes; all fields (N,).

    Field set and order are the reference's (``repro.fleet.state``), so
    states convert both ways; the persistence fields ride along at zero
    in this slice."""

    # capacitor + lifecycle
    v: torch.Tensor
    on: torch.Tensor
    cycles: torch.Tensor
    acquired: torch.Tensor
    skipped: torch.Tensor
    e_work: torch.Tensor
    e_harvest: torch.Tensor
    # local-mode sampling
    next_sample_t: torch.Tensor
    sample_counter: torch.Tensor
    # in-flight work (volatile by design)
    has_work: torch.Tensor
    w_ticket: torch.Tensor
    w_t_acq: torch.Tensor
    w_cycle_acq: torch.Tensor
    w_units_done: torch.Tensor
    w_left: torch.Tensor
    w_target: torch.Tensor  # total units to run
    w_tile: torch.Tensor  # per-request units; 0 = absolute target
    w_wl: torch.Tensor
    w_batch: torch.Tensor
    # dispatch-mode pending assignment (not yet acquired)
    p_pending: torch.Tensor
    p_ticket: torch.Tensor
    p_wl: torch.Tensor
    p_units: torch.Tensor
    p_batch: torch.Tensor
    p_t_assigned: torch.Tensor
    # emission aggregates
    emit_count: torch.Tensor
    emit_units_sum: torch.Tensor
    emit_acc_sum: torch.Tensor
    # persistence plane (structurally zero under the approximate tick)
    need_restore: torch.Tensor
    ck_units: torch.Tensor
    e_persist: torch.Tensor
    persists: torch.Tensor
    restores: torch.Tensor


STATE_FIELDS: tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(FleetState))


def init_state(n: int, *, device: torch.device | str,
               quantized: bool = False) -> FleetState:
    """Fresh device state for ``n`` workers: discharged capacitors,
    everything off/idle, counters zero (the reference's ``init_state``
    dtypes). ``quantized=False`` is the float64 contract: ``v`` in volts,
    energies in joules, times in seconds, int64 counters.
    ``quantized=True`` is the serve-tick kernel's int32 contract: ``v``
    holds stored energy in quanta, and energies, counters and the
    acquisition tick stamps ``w_t_acq``/``p_t_assigned`` are int32."""
    i32, i64, f64 = torch.int32, torch.int64, torch.float64
    e_dt = i32 if quantized else f64  # energies
    c_dt = i32 if quantized else i64  # counters / ids
    t_dt = i32 if quantized else f64  # acquisition times

    def z(dt=c_dt):
        return torch.zeros(n, dtype=dt, device=device)

    def one():
        return torch.ones(n, dtype=c_dt, device=device)

    return FleetState(
        v=z(e_dt), on=z(torch.bool), cycles=z(), acquired=z(), skipped=z(),
        e_work=z(e_dt), e_harvest=z(e_dt), next_sample_t=z(f64),
        sample_counter=z(i64), has_work=z(torch.bool), w_ticket=z(),
        w_t_acq=z(t_dt), w_cycle_acq=z(), w_units_done=z(), w_left=z(e_dt),
        w_target=z(), w_tile=z(), w_wl=z(), w_batch=one(),
        p_pending=z(torch.bool), p_ticket=z(), p_wl=z(), p_units=z(),
        p_batch=one(), p_t_assigned=z(t_dt), emit_count=z(),
        emit_units_sum=z(), emit_acc_sum=z(f64),
        need_restore=z(torch.bool), ck_units=z(), e_persist=z(e_dt),
        persists=z(), restores=z())


# ---------------------------------------------------------------------------
# Scheduler control plane (repro_torch.fleet.sched)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchedParams:
    """Static control-plane configuration (numpy constants; the serve loop
    moves the arrays to the device once, ``sched.params_to``).

    Units: every cost table is in joules, power in watts, times in seconds,
    windows in ticks of ``dt`` seconds."""

    n: int  # workers
    W: int  # workloads
    Q: int  # queue ring capacity per workload (requests)
    B: int  # max batch per assignment (requests)
    max_queue: int  # global admission bound (queued requests)
    max_retries: int  # retries granted before a request counts as lost
    shed_after_s: float  # queue-age shedding threshold, seconds
    grace_s: float  # straggler grace period, seconds
    deadline_factor: float  # straggler deadline = grace + factor * est
    dt: float  # tick length, seconds
    CU: np.ndarray  # (W, U+2) cumulative cost incl. fixed+emit, J
    UCUM: np.ndarray  # (W, U+2) unit-cost prefix, J
    FIX: np.ndarray  # (W,) fixed acquisition cost, J
    EMITC: np.ndarray  # (W,) emission cost, J
    NU: np.ndarray  # (W,) int64 unit counts
    FULL: np.ndarray  # (W,) cost of all units, J (straggler estimate)
    ACC: np.ndarray  # (W, U+1) expected-accuracy tables
    P_REQ: np.ndarray  # (W,) SMART floor units (sched._BIG: unattainable)
    IS_SMART: np.ndarray  # (W,) bool; False -> greedy admission
    forecast: bool  # False -> reactive (instantaneous-charge) planning
    lookahead_ticks: int  # forecast window L, ticks
    forecaster: str  # forecaster selection mode (read by sched=forecast)
    fc_order: int  # lag window P the planners gather
    FC_MU: np.ndarray  # (N,) forecast tables (zero under reactive)
    FC_W: np.ndarray  # (N, P)
    FC_THRESH: np.ndarray  # (N,)
    FC_HI: np.ndarray  # (N,)
    FC_LO: np.ndarray  # (N,)
    FC_MODEL: np.ndarray  # (N,) int8
    ECAP: np.ndarray  # (N,) storable usable-energy ceiling, J
    ACTIVE_P: np.ndarray  # (N,) per-worker MCU active power, W
    lat_bins: int  # latency histogram bins
    lat_max_s: float  # latency histogram range, seconds
    quality: str  # table provenance: "proxy" in this slice
    value_order: bool  # sched="quality" queue order (False here)
    S_Q: np.ndarray  # (W,) int64 oracle samples per workload
    QTAB: np.ndarray  # (W, S_max, U+1) int64 0/1 per-sample correctness
    QJ_NJ: np.ndarray  # (W, U+1) int64 nanojoules per completed request
    QVALUE: np.ndarray  # (W,) marginal accuracy-per-joule
    WL_RANK: np.ndarray  # (W,) int64 queue order by QVALUE desc
    QTARGET: np.ndarray  # (W,) int64 smallest knob at max accuracy
    forecaster_fit: str = "full"


@dataclasses.dataclass
class SchedState:
    """Everything one scheduler tick reads or writes: queue ring buffers,
    per-worker in-flight assignments and aggregate accounting (0-d
    tensors for scalars)."""

    # per-workload FIFO ring buffers (front = oldest)
    q_t: torch.Tensor  # (W, Q) arrival times, float64 s
    q_r: torch.Tensor  # (W, Q) retry counts
    q_head: torch.Tensor  # (W,) physical index of the logical front
    q_len: torch.Tensor  # (W,)
    # per-worker in-flight assignment
    f_n: torch.Tensor  # (N,) requests in flight; 0 = none
    f_wl: torch.Tensor  # (N,)
    f_units: torch.Tensor  # (N,) per-request knob units
    f_t0: torch.Tensor  # (N,) assignment time
    f_arr: torch.Tensor  # (N, B) request arrival times
    f_retry: torch.Tensor  # (N, B) request retry counts
    # aggregate accounting
    submitted: torch.Tensor
    rejected: torch.Tensor
    shed: torch.Tensor
    lost: torch.Tensor
    evicted: torch.Tensor
    requeued: torch.Tensor
    completed: torch.Tensor
    completed_wl: torch.Tensor  # (W,)
    units_wl: torch.Tensor  # (W,)
    acc_wl: torch.Tensor  # (W,)
    lat_sum: torch.Tensor
    lat_hist: torch.Tensor  # (lat_bins,)
    batch_hist: torch.Tensor  # (B+1,) assignments by batch size
    # quality ledger: integer counters, bit-exact across backends
    meas_wl: torch.Tensor  # (W,) oracle-correct completed requests
    joules_nj_wl: torch.Tensor  # (W,) nanojoules spent on completions
    rebalanced: torch.Tensor  # cross-shard moves (0: unsharded)


SCHED_FIELDS: tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(SchedState))


def init_sched_state(sp: SchedParams, device: torch.device | str
                     ) -> SchedState:
    """Empty control-plane state sized for ``sp``: empty rings, nothing in
    flight, counters zero. Times are float64 seconds, counts int64."""
    def i(*s):
        return torch.zeros(s, dtype=torch.int64, device=device)

    def f(*s):
        return torch.zeros(s, dtype=torch.float64, device=device)

    return SchedState(
        q_t=f(sp.W, sp.Q), q_r=i(sp.W, sp.Q), q_head=i(sp.W),
        q_len=i(sp.W),
        f_n=i(sp.n), f_wl=i(sp.n), f_units=i(sp.n), f_t0=f(sp.n),
        f_arr=f(sp.n, sp.B), f_retry=i(sp.n, sp.B),
        submitted=i(), rejected=i(), shed=i(), lost=i(), evicted=i(),
        requeued=i(), completed=i(),
        completed_wl=i(sp.W), units_wl=i(sp.W), acc_wl=f(sp.W),
        lat_sum=f(), lat_hist=i(sp.lat_bins), batch_hist=i(sp.B + 1),
        meas_wl=i(sp.W), joules_nj_wl=i(sp.W), rebalanced=i())


def stack_cost_tables(workloads: Sequence[CostTable]
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Stack per-workload cost tables into ``(UC, FIX, EMITC, NU)``:
    (W, U_max) per-unit costs padded with +inf (never affordable), fixed
    and emission costs (J), and unit counts (int64)."""
    u_max = max(c.n_units for c in workloads)
    UC = np.full((len(workloads), u_max), np.inf)
    for w, c in enumerate(workloads):
        UC[w, :c.n_units] = c.unit_costs
    FIX = np.array([c.fixed_cost for c in workloads])
    EMITC = np.array([c.emit_cost for c in workloads])
    NU = np.array([c.n_units for c in workloads], dtype=np.int64)
    return UC, FIX, EMITC, NU


# ---------------------------------------------------------------------------
# Reference <-> port conversion
# ---------------------------------------------------------------------------


def _tensors(obj, cls, device):
    return cls(**{f.name: torch.as_tensor(np.asarray(getattr(obj, f.name)),
                                          device=device)
                  for f in dataclasses.fields(cls)})


def _arrays(obj, cls):
    return cls(**{f.name: getattr(obj, f.name).detach().cpu().numpy()
                  for f in dataclasses.fields(cls)})


def _port_policy(ref_policy):
    """The port's policy of the same class name and fields (None stays
    None)."""
    if ref_policy is None:
        return None
    cls = getattr(policies, type(ref_policy).__name__, None)
    if not (isinstance(cls, type) and issubclass(cls, Policy)
            and dataclasses.is_dataclass(cls)):
        raise NotImplementedError(
            f"policy {type(ref_policy).__name__} has no port")
    return cls(**{f.name: getattr(ref_policy, f.name)
                  for f in dataclasses.fields(cls)})


def from_reference(fleet_params=None, fleet_state=None, sched_params=None,
                   sched_state=None, *, device: torch.device | str):
    """Convert the reference's (``repro.fleet.state``) numpy dataclasses to
    the port's: ``(FleetParams, FleetState, SchedParams, SchedState)``.

    Arrays keep their dtypes exactly; states become tensors on ``device``,
    params stay numpy, and the cost tables and local-mode policy become
    the port's own classes. Any argument may be None (its slot returns
    None). What this slice serves converts: float64 or quantized fleets,
    local or dispatch mode, under the approximate discipline, and an
    unsharded control plane."""
    fp = fs = sp = ss = None
    if fleet_params is not None:
        if fleet_params.persist != "none":
            raise NotImplementedError(
                "only fleets with persist='none' are ported yet")
        fields = {f.name: getattr(fleet_params, f.name)
                  for f in dataclasses.fields(FleetParams)}
        fields["tables"] = tuple(
            CostTable(c.unit_costs, emit_cost=c.emit_cost,
                      fixed_cost=c.fixed_cost) for c in fields["tables"])
        fields["policy"] = _port_policy(fields["policy"])
        fp = FleetParams(**fields)
    if fleet_state is not None:
        fs = _tensors(fleet_state, FleetState, device)
    if sched_params is not None:
        if getattr(sched_params, "shards", 1) != 1 \
                or getattr(sched_params, "persist", "none") != "none":
            raise NotImplementedError(
                "sharded or persistent control planes are not ported yet")
        sp = SchedParams(**{f.name: getattr(sched_params, f.name)
                            for f in dataclasses.fields(SchedParams)})
    if sched_state is not None:
        ss = _tensors(sched_state, SchedState, device)
    return fp, fs, sp, ss


def to_numpy(fleet_state: FleetState | None = None,
             sched_state: SchedState | None = None):
    """Inverse of :func:`from_reference` for the states: the same
    dataclasses holding numpy arrays (dtypes kept), ``(fs, ss)``."""
    return (None if fleet_state is None else _arrays(fleet_state, FleetState),
            None if sched_state is None else _arrays(sched_state, SchedState))
