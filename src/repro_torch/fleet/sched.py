"""Array-native fleet control plane in PyTorch: scheduling as tensor ops.

Counterpart of ``repro.fleet.sched``: admission, stale-prefix shedding,
budget planning, routing and batching, collection (with the quality
ledger), retries and straggler eviction over the struct-of-arrays
``SchedState``, evaluated on the run's device. Every decision is integer
arithmetic or elementwise IEEE float64 ops in the reference's order, with
stable sorts, so the port agrees with the reference exactly on every
count; float metric accumulators (latency and accuracy sums) may differ by
reduction-order ulps.

The functions read no device value on the host: the reference's
skip-if-idle fast paths (``lax.cond`` in its fused scan) are identities, so
the masked bodies run on every tick, on every device, and a CUDA serve
loop never waits on the device. Scatters keep real indices unique and send
masked lanes to a dump slot.

This slice serves ``sched="reactive"``; forecast and quality routing,
sharding and rebalance come with later slices.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.forecast import FORECASTER_MODES, zero_row_forecast
from repro_torch.fleet.state import (SCHED_FIELDS, FleetParams, SchedParams,
                                     SchedState, init_sched_state)

SS = collections.namedtuple("SS", SCHED_FIELDS)

Assignment = collections.namedtuple("Assignment",
                                    ["mask", "wl", "units", "batch"])

SCHED_MODES = ("reactive", "forecast", "quality")
PORTED_SCHED_MODES = ("reactive",)

_BIG = np.int64(1) << 40  # sentinel: floor unattainable -> never afford

# synthetic oracle rows for workloads without a measured per-sample table:
# row s scores "correct" at u units iff s < round(accuracy[u] * _S_PROXY)
_S_PROXY = 64

# compiled forecast tables: the fields a causal refit may replace
FC_FIELDS = ("FC_MU", "FC_W", "FC_THRESH", "FC_HI", "FC_LO", "FC_MODEL")


# ---------------------------------------------------------------------------
# construction (host-side numpy, identical to the reference)
# ---------------------------------------------------------------------------


def make_sched_params(p: FleetParams, workloads: Sequence, *,
                      max_queue: int = 4096, shed_after_s: float = 30.0,
                      max_batch: int = 4, max_retries: int = 2,
                      grace_s: float = 20.0, deadline_factor: float = 1.5,
                      sched: str = "reactive", lookahead_s: float = 5.0,
                      forecaster: str = "ou",
                      forecaster_fit: str = "full",
                      lat_bins: int = 64) -> SchedParams:
    """Compile the control-plane constants for one fleet (see the
    reference's ``make_sched_params``): stacked cost/accuracy tables in
    joules, SMART floors, the proxy quality tables and the trivial
    forecast table reactive planning carries."""
    if sched not in SCHED_MODES:
        raise ValueError(f"unknown sched mode {sched!r}; "
                         f"choose from {SCHED_MODES}")
    if sched not in PORTED_SCHED_MODES:
        raise NotImplementedError(f"--sched {sched} is not ported yet")
    if forecaster not in FORECASTER_MODES:
        raise ValueError(f"unknown forecaster {forecaster!r}; "
                         f"choose from {FORECASTER_MODES}")
    if forecaster_fit not in ("full", "causal"):
        raise ValueError(f"unknown forecaster_fit {forecaster_fit!r}; "
                         "choose from ('full', 'causal')")
    W = len(workloads)
    u_max = max(w.costs.n_units for w in workloads)
    CU = np.full((W, u_max + 2), np.inf)
    UCUM = np.full((W, u_max + 2), np.inf)
    ACC = np.zeros((W, u_max + 1))
    FIX = np.zeros(W)
    EMITC = np.zeros(W)
    NU = np.zeros(W, dtype=np.int64)
    FULL = np.zeros(W)
    P_REQ = np.zeros(W, dtype=np.int64)
    IS_SMART = np.zeros(W, dtype=bool)
    S_Q = np.full(W, _S_PROXY, dtype=np.int64)
    QTAB = np.zeros((W, _S_PROXY, u_max + 1), dtype=np.int64)
    QJ_NJ = np.zeros((W, u_max + 1), dtype=np.int64)
    QVALUE = np.zeros(W)
    QTARGET = np.zeros(W, dtype=np.int64)
    for w, wk in enumerate(workloads):
        nu = wk.costs.n_units
        NU[w] = nu
        CU[w, :nu + 1] = wk.costs.cumulative()
        UCUM[w, :nu + 1] = np.concatenate(
            [[0.0], np.cumsum(wk.costs.unit_costs)])
        FULL[w] = UCUM[w, nu]
        ACC[w, :nu + 1] = wk.accuracy
        FIX[w] = wk.costs.fixed_cost
        EMITC[w] = wk.costs.emit_cost
        if wk.floor > 0:
            IS_SMART[w] = True
            ok = np.nonzero(wk.accuracy >= wk.floor)[0]
            P_REQ[w] = int(ok[0]) if ok.size else _BIG
        QTAB[w, :_S_PROXY, :nu + 1] = (
            np.arange(_S_PROXY)[:, None]
            < np.round(wk.accuracy[None, :] * _S_PROXY))
        QJ_NJ[w, :nu + 1] = np.round(CU[w, :nu + 1] * 1e9)
        u_eff = int(min(P_REQ[w] if IS_SMART[w] else nu, nu))
        QVALUE[w] = ((ACC[w, u_eff] - ACC[w, 0])
                     / max(CU[w, u_eff], 1e-300))
        QTARGET[w] = int(np.argmax(wk.accuracy))  # first knob at the max
    L = max(int(round(lookahead_s / p.dt)), 1)
    # reactive planning never reads the forecast: a zero table at order 1
    rf = zero_row_forecast(p.n)
    return SchedParams(
        n=p.n, W=W, Q=int(max_queue + p.n * max_batch), B=int(max_batch),
        max_queue=int(max_queue), max_retries=int(max_retries),
        shed_after_s=float(shed_after_s), grace_s=float(grace_s),
        deadline_factor=float(deadline_factor), dt=float(p.dt),
        CU=CU, UCUM=UCUM, FIX=FIX, EMITC=EMITC, NU=NU, FULL=FULL, ACC=ACC,
        P_REQ=P_REQ, IS_SMART=IS_SMART,
        forecast=False, lookahead_ticks=L,
        forecaster=str(forecaster), fc_order=int(rf.order),
        FC_MU=rf.MU, FC_W=rf.W, FC_THRESH=rf.THRESH, FC_HI=rf.HI,
        FC_LO=rf.LO, FC_MODEL=rf.model,
        ECAP=0.5 * p.C * (p.v_max * p.v_max - p.v_off * p.v_off),
        ACTIVE_P=np.asarray(p.active_power_w, dtype=np.float64),
        lat_bins=int(lat_bins),
        lat_max_s=2.0 * (float(shed_after_s) + float(grace_s)),
        quality="proxy", value_order=False,
        S_Q=S_Q, QTAB=QTAB, QJ_NJ=QJ_NJ, QVALUE=QVALUE,
        WL_RANK=np.argsort(-QVALUE, kind="stable").astype(np.int64),
        QTARGET=QTARGET, forecaster_fit=str(forecaster_fit))


def make_sched_state(sp: SchedParams, device: torch.device | str
                     ) -> SchedState:
    """Empty :class:`SchedState` sized for ``sp`` on ``device``."""
    return init_sched_state(sp, device)


def params_to(sp: SchedParams, device: torch.device | str) -> SchedParams:
    """``sp`` with every array field as a tensor on ``device`` (the form
    the control-plane functions below read)."""
    return dataclasses.replace(sp, **{
        f.name: torch.as_tensor(getattr(sp, f.name), device=device)
        for f in dataclasses.fields(sp)
        if isinstance(getattr(sp, f.name), np.ndarray)})


def sched_params_compatible(old: SchedParams | None,
                            new: SchedParams) -> bool:
    """True iff device tables uploaded for ``old`` stay valid for ``new``:
    only the ``FC_FIELDS`` forecast tables changed (same shapes and dtypes,
    re-uploaded), every other field is the same object or value."""
    if old is None:
        return False
    if old is new:
        return True
    for f in dataclasses.fields(SchedParams):
        a, b = getattr(old, f.name), getattr(new, f.name)
        if f.name in FC_FIELDS:
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape or a.dtype != b.dtype:
                return False
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            if a is not b:
                return False
        elif a != b:
            return False
    return True


def power_lags(power: torch.Tensor, trace_index: torch.Tensor, i: int,
               T: int, order: int, phase: torch.Tensor | None = None
               ) -> torch.Tensor:
    """The (N, order) harvested-power lag window (watts) the forecast
    planners read: column j is each worker's power at trace tick
    ``i - j`` (cyclic in ``T``, shifted by ``phase`` when given)."""
    cols = []
    for j in range(order):
        c = ((i - j) % T) if phase is None else (phase + (i - j)) % T
        cols.append(power[trace_index, c])
    return torch.stack(cols, dim=1)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``minimum(maximum(x, lo), hi)`` as numpy/jnp ``clip`` evaluate it;
    bounds are scalars or tensors."""
    # a scalar bound stays a kernel argument (a tensor made from it would
    # be a host-to-device copy that waits for the stream)
    x = (torch.maximum(x, lo) if isinstance(lo, torch.Tensor)
         else torch.clamp(x, min=lo))
    return (torch.minimum(x, hi) if isinstance(hi, torch.Tensor)
            else torch.clamp(x, max=hi))


def _row(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a 0-d device index, without a host read."""
    return table.index_select(0, idx.reshape(1))[0]


# ---------------------------------------------------------------------------
# intake
# ---------------------------------------------------------------------------


def admit(sp: SchedParams, ss: SS, counts: torch.Tensor, t: float) -> SS:
    """Admit this tick's (W,) arrival ``counts`` up to the global backlog
    bound (cumulative clip in workload order), reject the rest; admitted
    requests are stamped with arrival time ``t`` (seconds) at each ring's
    tail. Callers skip ticks with no arrivals (an identity)."""
    counts = counts.to(torch.int64)
    backlog = ss.q_len.sum()
    space = torch.clamp(sp.max_queue - backlog, min=0)
    cum = torch.cumsum(counts, 0)
    adm = _clip(space - (cum - counts), 0, counts)
    slot = torch.arange(sp.Q, device=counts.device)[None, :]
    pos = (slot - ss.q_head[:, None]) % sp.Q  # logical index per slot
    new = (pos >= ss.q_len[:, None]) & (pos < (ss.q_len + adm)[:, None])
    return ss._replace(
        q_t=torch.where(new, t, ss.q_t),
        q_r=torch.where(new, 0, ss.q_r),
        q_len=ss.q_len + adm,
        submitted=ss.submitted + counts.sum(),
        rejected=ss.rejected + (counts - adm).sum())


def shed(sp: SchedParams, ss: SS, t: float) -> SS:
    """Drop the stale prefix of each queue (age ``t - arrival`` beyond
    ``shed_after_s``); prefix, not filter, so rings stay contiguous."""
    j = torch.arange(sp.Q, device=ss.q_t.device)[None, :]
    phys = (ss.q_head[:, None] + j) % sp.Q
    log_t = torch.gather(ss.q_t, 1, phys)
    stale = (j < ss.q_len[:, None]) & (t - log_t > sp.shed_after_s)
    n_shed = torch.cumprod(stale.to(torch.int64), dim=1).sum(dim=1)
    return ss._replace(
        q_head=(ss.q_head + n_shed) % sp.Q,
        q_len=ss.q_len - n_shed,
        shed=ss.shed + n_shed.sum())


# ---------------------------------------------------------------------------
# routing / batching
# ---------------------------------------------------------------------------


def plan_budget(sp: SchedParams, budget_now: torch.Tensor,
                pw_lags: torch.Tensor, eff: float) -> torch.Tensor:
    """The (N,) budget (J) routing and batching plan against: under
    reactive planning, the instantaneous usable energy itself."""
    if sp.forecast:
        raise NotImplementedError("forecast planning is not ported yet")
    return budget_now


def dispatch(sp: SchedParams, ss: SS, dispatchable: torch.Tensor,
             budget_now: torch.Tensor, budget_plan: torch.Tensor,
             t: float) -> tuple[SS, Assignment]:
    """Route queued requests to capable workers (see the reference's
    ``dispatch``): workers ranked richest-first by ``budget_plan`` (stable
    sort), queues served oldest-head-first; per worker SMART admission on
    ``budget_now``, batch size on ``budget_plan``, greedy knob refinement;
    queue consumption is a cumulative-sum slice per workload. Returns the
    updated state and the per-worker :class:`Assignment`."""
    i64 = torch.int64
    dev = budget_now.device
    n, B, W = sp.n, sp.B, sp.W
    score = torch.where(dispatchable, budget_plan, -torch.inf)
    order = torch.argsort(-score, stable=True)  # rank -> worker id
    elig = dispatchable[order]
    bn = budget_now[order]
    bp = budget_plan[order]
    head_t = torch.where(
        ss.q_len > 0, torch.gather(ss.q_t, 1, ss.q_head[:, None])[:, 0],
        torch.inf)
    wl_order = torch.argsort(head_t, stable=True)
    q_head, q_len = ss.q_head, ss.q_len
    taken = torch.zeros(n, dtype=torch.bool, device=dev)
    a_wl = torch.zeros(n, dtype=i64, device=dev)
    a_units = torch.zeros(n, dtype=i64, device=dev)
    a_batch = torch.zeros(n, dtype=i64, device=dev)
    g_arr = torch.zeros((n, B), dtype=torch.float64, device=dev)
    g_retry = torch.zeros((n, B), dtype=i64, device=dev)
    jB = torch.arange(B, device=dev)[None, :]
    w_ids = torch.arange(W, device=dev)
    for k in range(W):  # one pass per workload queue
        wl = wl_order[k]
        cu = _row(sp.CU, wl)
        ucum = _row(sp.UCUM, wl)
        nu = _row(sp.NU, wl)
        overhead = _row(sp.FIX, wl) + _row(sp.EMITC, wl)
        qrem = _row(q_len, wl)
        head = _row(q_head, wl)
        # admission: largest knob the instantaneous budget affords (-1:
        # even fixed+emit does not fit), SMART floor for floored workloads
        k_aff = torch.searchsorted(cu, bn, right=True) - 1
        p_req = torch.where(_row(sp.IS_SMART, wl), _row(sp.P_REQ, wl),
                            torch.clamp(k_aff, min=0))
        afford = (k_aff >= p_req) & (k_aff >= 0)
        # batch size on the planning budget, knob refinement on the
        # instantaneous budget
        spend_plan = bp - overhead
        spend_now = bn - overhead
        cpb = ucum[_clip(p_req, 0, ucum.shape[0] - 1)]
        b_want = torch.where(
            cpb > 0,
            torch.floor_divide(spend_plan, torch.clamp(cpb, min=1e-300)),
            float(B))
        b_want = _clip(b_want, 1, B).to(i64)
        u_want = _clip(
            torch.searchsorted(ucum, spend_now / torch.clamp(b_want, min=1),
                               right=True) - 1, p_req, nu)
        ok = elig & ~taken & afford & (u_want > 0)
        b = torch.where(ok, b_want, 0)
        c = torch.cumsum(b, 0)
        start = c - b
        actual = _clip(qrem - start, 0, b)
        got = ok & (actual > 0)
        u = _clip(
            torch.searchsorted(ucum, spend_now / torch.clamp(actual, min=1),
                               right=True) - 1, p_req, nu)
        # consume the queue front: gather each worker's request slice
        phys = (head + start[:, None] + jB) % sp.Q
        row_t = _row(ss.q_t, wl)
        row_r = _row(ss.q_r, wl)
        take_mask = got[:, None] & (jB < actual[:, None])
        g_arr = torch.where(take_mask, row_t[phys], g_arr)
        g_retry = torch.where(take_mask, row_r[phys], g_retry)
        consumed = actual.sum()
        onehot = w_ids == wl
        q_head = torch.where(onehot, (q_head + consumed) % sp.Q, q_head)
        q_len = torch.where(onehot, q_len - consumed, q_len)
        taken = taken | got
        a_wl = torch.where(got, wl, a_wl)
        a_units = torch.where(got, u, a_units)
        a_batch = torch.where(got, actual, a_batch)
    # rank space -> worker space (order is a permutation: unique indices)
    batch_w = torch.empty_like(a_batch).index_copy_(0, order, a_batch)
    mask_w = batch_w > 0
    wl_w = torch.empty_like(a_wl).index_copy_(0, order, a_wl)
    units_w = torch.empty_like(a_units).index_copy_(0, order, a_units)
    arr_w = torch.empty_like(g_arr).index_copy_(0, order, g_arr)
    retry_w = torch.empty_like(g_retry).index_copy_(0, order, g_retry)
    ss = ss._replace(
        q_head=q_head, q_len=q_len,
        f_n=torch.where(mask_w, batch_w, ss.f_n),
        f_wl=torch.where(mask_w, wl_w, ss.f_wl),
        f_units=torch.where(mask_w, units_w, ss.f_units),
        f_t0=torch.where(mask_w, t, ss.f_t0),
        f_arr=torch.where(mask_w[:, None], arr_w, ss.f_arr),
        f_retry=torch.where(mask_w[:, None], retry_w, ss.f_retry),
        batch_hist=ss.batch_hist + (
            (batch_w[:, None] == torch.arange(B + 1, device=dev)[None, :])
            & mask_w[:, None]).sum(dim=0))
    return ss, Assignment(mask_w, wl_w, units_w, batch_w)


# ---------------------------------------------------------------------------
# completion / loss / eviction
# ---------------------------------------------------------------------------


def _requeue(sp: SchedParams, ss: SS, slots: torch.Tensor) -> SS:
    """Grant retries to the in-flight request ``slots`` ((N, B) mask):
    past the retry budget a request is lost; otherwise it re-enters its
    workload queue at the front, in (worker, slot) order, with its
    original arrival time."""
    newr = ss.f_retry + 1
    give_up = slots & (newr > sp.max_retries)
    keep = slots & ~give_up
    q_t, q_r, q_head, q_len = ss.q_t, ss.q_r, ss.q_head, ss.q_len
    dev = q_t.device
    flat_keep = keep.reshape(-1)
    flat_t = ss.f_arr.reshape(-1)
    flat_r = newr.reshape(-1)
    flat_wl = ss.f_wl[:, None].expand(keep.shape).reshape(-1)
    w_ids = torch.arange(sp.W, device=dev)
    for w in range(sp.W):  # one front-insert pass per queue
        m = flat_keep & (flat_wl == w)
        mi = m.to(torch.int64)
        kcount = mi.sum()
        rank = torch.cumsum(mi, 0) - 1
        headnew = (q_head[w] - kcount) % sp.Q
        phys = torch.where(m, (headnew + rank) % sp.Q, sp.Q)  # Q: dump
        ext_t = torch.cat([q_t[w], torch.zeros(1, dtype=q_t.dtype,
                                               device=dev)])
        ext_t[phys] = torch.where(m, flat_t, 0.0)
        ext_r = torch.cat([q_r[w], torch.zeros(1, dtype=q_r.dtype,
                                               device=dev)])
        ext_r[phys] = torch.where(m, flat_r, 0)
        onehot = w_ids == w
        q_t = torch.where(onehot[:, None], ext_t[None, :sp.Q], q_t)
        q_r = torch.where(onehot[:, None], ext_r[None, :sp.Q], q_r)
        q_head = torch.where(onehot, headnew, q_head)
        q_len = torch.where(onehot, q_len + kcount, q_len)
    return ss._replace(
        q_t=q_t, q_r=q_r, q_head=q_head, q_len=q_len,
        lost=ss.lost + give_up.sum(),
        requeued=ss.requeued + keep.sum())


def collect(sp: SchedParams, ss: SS, emit: torch.Tensor, lost: torch.Tensor,
            units_done: torch.Tensor, t: float) -> SS:
    """Retire this tick's device outcomes: an emitting worker completes
    ``units_done // u`` full requests of its batch plus one partial
    (anytime semantics); the unfinished tail and every request of a
    browned-out worker go through the retry path. Completions feed the
    latency histogram and the integer quality ledger."""
    dev = emit.device
    i64 = torch.int64
    W = sp.W
    act = ss.f_n > 0
    em = emit & act
    lo = lost & act
    b = ss.f_n
    u = ss.f_units
    safe_u = torch.clamp(u, min=1)
    full = torch.where(u > 0, units_done // safe_u, b)
    part = torch.where(u > 0, units_done % safe_u, 0)
    nfull = torch.minimum(full, b)
    haspart = (part > 0) & (full < b)
    jB = torch.arange(sp.B, device=dev)[None, :]
    slotv = jB < b[:, None]
    compfull = em[:, None] & slotv & (jB < nfull[:, None])
    comppart = (em[:, None] & slotv & (jB == nfull[:, None])
                & haspart[:, None])
    comp = compfull | comppart
    unfinished = (em[:, None] & slotv & ~comp) | (lo[:, None] & slotv)
    units_slot = torch.where(compfull, u[:, None],
                             torch.where(comppart, part[:, None], 0))
    lat = t - ss.f_arr
    # fixed-bin latency histogram; non-completions go to dump slots past
    # the bins, one per (worker, slot) lane (one shared dump bin would
    # take N*B contended atomic adds on one address per tick on a GPU)
    binw = sp.lat_max_s / sp.lat_bins
    idx = _clip((lat / binw).to(i64), 0, sp.lat_bins - 1)
    lanes = torch.arange(comp.numel(), device=dev)
    idx = torch.where(comp.reshape(-1), idx.reshape(-1), sp.lat_bins + lanes)
    hist_ext = torch.zeros(sp.lat_bins + comp.numel(), dtype=i64,
                           device=dev)
    hist_ext.index_add_(0, idx, torch.ones_like(idx))
    # per-workload aggregates via the small one-hot W axis
    w_ids = torch.arange(W, device=dev)
    wl1h = ss.f_wl[:, None, None] == w_ids[None, None, :]
    compc = (comp[:, :, None] & wl1h).to(i64)
    Uw = sp.ACC.shape[1]
    accv = sp.ACC.reshape(-1)[ss.f_wl[:, None] * Uw
                              + _clip(units_slot, 0, Uw - 1)]
    # quality ledger: completions numbered per workload in flat (worker,
    # slot) order continuing completed_wl, cycling mod the oracle set
    cc2 = compc.reshape(-1, W)  # (N*B, W)
    # running count per workload along N*B: one flat scan of the (W, N*B)
    # transpose less each row's starting total (a scan along a dim of
    # W = 3 rows or columns runs only a few threads over N*B elements)
    flat = torch.cumsum(cc2.T.reshape(-1), 0).reshape(W, -1)
    start = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    rank = (flat - start[:, None]).T
    sample = ((ss.completed_wl[None, :] + rank - cc2) % sp.S_Q[None, :])
    Smax, Uq = sp.QTAB.shape[1], sp.QTAB.shape[2]
    uq = _clip(units_slot, 0, Uq - 1)
    qv = sp.QTAB.reshape(-1)[(w_ids[None, :] * Smax + sample) * Uq
                             + uq.reshape(-1)[:, None]]
    jnj = sp.QJ_NJ.reshape(-1)[ss.f_wl[:, None] * Uq + uq]
    ss = ss._replace(
        completed=ss.completed + comp.sum(),
        completed_wl=ss.completed_wl + compc.sum(dim=(0, 1)),
        units_wl=ss.units_wl + (units_slot[:, :, None] * compc).sum(
            dim=(0, 1)),
        acc_wl=ss.acc_wl + (torch.where(comp, accv, 0.0)[:, :, None]
                            * compc).sum(dim=(0, 1)),
        meas_wl=ss.meas_wl + (qv * cc2).sum(dim=0),
        joules_nj_wl=ss.joules_nj_wl + (
            jnj.reshape(-1)[:, None] * cc2).sum(dim=0),
        lat_sum=ss.lat_sum + torch.where(comp, lat, 0.0).sum(),
        lat_hist=ss.lat_hist + hist_ext[:sp.lat_bins])
    ss = _requeue(sp, ss, unfinished)
    return ss._replace(f_n=torch.where(em | lo, 0, ss.f_n))


def evict(sp: SchedParams, ss: SS, t: float) -> tuple[SS, torch.Tensor]:
    """Straggler pass: revoke assignments older than the deadline
    ``grace_s + deadline_factor * est`` (``est`` prices the batch at the
    worker's own MCU active power) and requeue them. Returns ``(ss, ev)``
    with ``ev`` the (N,) evicted mask the caller clears on the device."""
    act = ss.f_n > 0
    est = (sp.FIX[ss.f_wl] + sp.EMITC[ss.f_wl]
           + ss.f_n * sp.FULL[ss.f_wl]) / sp.ACTIVE_P
    ev = act & (t - ss.f_t0 > sp.grace_s + sp.deadline_factor * est)
    slots = ev[:, None] & (torch.arange(sp.B, device=ev.device)[None, :]
                           < ss.f_n[:, None])
    ss = ss._replace(evicted=ss.evicted + torch.where(ev, ss.f_n, 0).sum())
    ss = _requeue(sp, ss, slots)
    return ss._replace(f_n=torch.where(ev, 0, ss.f_n)), ev
