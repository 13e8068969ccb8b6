"""Fleet-level accounting: request lifecycle counters + energy books.

Counterpart of ``repro.fleet.metrics.sched_summary``: the same summary dict,
key for key, built on the host from numpy copies of the final states
(``state.to_numpy``). Energy ledgers are summed on the host, as in the
reference, so they agree exactly across implementations.
"""
from __future__ import annotations

import numpy as np


def _energy_block(fs, quantum_j: float | None, completed: int) -> dict:
    """Energy ledger of a pool state (numpy), in joules: a quantized
    state's integer quanta are scaled by ``quantum_j``, a float64 state
    (``quantum_j`` None) already holds joules."""
    e_scale = 1.0 if quantum_j is None else quantum_j
    harvested = float(fs.e_harvest.sum()) * e_scale
    work = float(fs.e_work.sum()) * e_scale
    # approximate runtime: structurally 0.0 (no NVM state machine)
    nvm = float(np.asarray(fs.e_persist).sum()) * e_scale
    return {
        "harvested_j": harvested,
        "work_j": work,
        "nvm_j": nvm,
        "sleep_j": 0.0,
        "persists": int(np.asarray(fs.persists).sum()),
        "restores": int(np.asarray(fs.restores).sum()),
        "j_per_completed": ((work + nvm) / completed if completed
                            else float("inf")),
        # harvested >= work + nvm: nothing comes from thin air
        "conservation_ok": bool(harvested + 1e-9 >= work + nvm),
    }


def quality_block(sp, ss) -> dict:
    """Fleet-wide measured accuracy, the proxy-vs-measured gap and the
    ledgered spend, from the control plane's integer counters."""
    completed = int(np.asarray(ss.completed_wl).sum())
    correct = int(np.asarray(ss.meas_wl).sum())
    joules = float(np.asarray(ss.joules_nj_wl).sum()) * 1e-9
    proxy = float(np.asarray(ss.acc_wl).sum()) / max(completed, 1)
    measured = correct / max(completed, 1)
    return {
        "tables": sp.quality,
        "measured_correct": correct,
        "mean_measured_accuracy": measured,
        "proxy_minus_measured": proxy - measured,
        "ledger_joules": joules,
        "j_per_completed_ledger": joules / max(completed, 1),
    }


def _hist_percentile(hist: np.ndarray, lat_max_s: float, q: float) -> float:
    """Percentile estimate from the fixed-bin latency histogram (bin
    centers), skipping leading empty bins."""
    total = int(hist.sum())
    if total == 0:
        return 0.0
    cum = np.cumsum(hist)
    rank = max(q * total, np.finfo(np.float64).tiny)
    b = int(np.searchsorted(cum, rank))
    return (min(b, hist.shape[0] - 1) + 0.5) * lat_max_s / hist.shape[0]


def latency_bin_edges_s(sp) -> list[float]:
    """The ``lat_bins + 1`` edges of the latency histogram, seconds."""
    return [float(x) for x in
            np.linspace(0.0, sp.lat_max_s, sp.lat_bins + 1)]


def sched_summary(sp, ss, duration_s: float, fs=None, quantum_j=None,
                  workload_names: list[str] | None = None) -> dict:
    """Summary dict from the control plane's numpy counters (``sp`` /
    ``ss``: SchedParams / numpy SchedState), plus the energy block of the
    numpy pool state ``fs`` (energies in quanta of ``quantum_j``, or in
    joules when that is None) when given."""
    completed = int(ss.completed)
    out: dict = {
        "submitted": int(ss.submitted),
        "completed": completed,
        "rejected": int(ss.rejected),
        "shed": int(ss.shed),
        "lost": int(ss.lost),
        "evicted": int(ss.evicted),
        "requeued": int(ss.requeued),
        "rebalanced": int(np.asarray(ss.rebalanced).sum()),
        "throughput_rps": completed / max(duration_s, 1e-9),
        "latency_mean_s": float(ss.lat_sum) / max(completed, 1),
        "latency_p50_s": _hist_percentile(np.asarray(ss.lat_hist),
                                          sp.lat_max_s, 0.50),
        "latency_p95_s": _hist_percentile(np.asarray(ss.lat_hist),
                                          sp.lat_max_s, 0.95),
        "latency_p99_s": _hist_percentile(np.asarray(ss.lat_hist),
                                          sp.lat_max_s, 0.99),
        "latency_bin_edges_s": latency_bin_edges_s(sp),
        "mean_units": float(ss.units_wl.sum()) / max(completed, 1),
        "mean_expected_accuracy": (float(ss.acc_wl.sum())
                                   / max(completed, 1)),
        "batch_hist": [int(x) for x in np.asarray(ss.batch_hist)],
    }
    out["quality"] = quality_block(sp, ss)
    out["per_workload"] = {}
    for w in range(sp.W):
        c = int(ss.completed_wl[w])
        if c == 0:
            continue
        name = workload_names[w] if workload_names else str(w)
        out["per_workload"][name] = {
            "completed": c,
            "mean_units": float(ss.units_wl[w]) / c,
            "mean_expected_accuracy": float(ss.acc_wl[w]) / c,
            "mean_measured_accuracy": float(ss.meas_wl[w]) / c,
            "ledger_joules": float(ss.joules_nj_wl[w]) * 1e-9,
        }
    if fs is not None:
        out["energy"] = _energy_block(fs, quantum_j, completed)
    return out
