"""Port's float64 local-mode pool vs the reference's NumPy pool.

``repro_torch.fleet.worker.FleetWorkerPool(mode="local", kernel="f64",
device="cpu")`` against ``repro.fleet.worker.FleetWorkerPool(
backend="numpy")`` on the acceptance grid of
``tests/test_fleet_backends.py:72-175``: one worker over 300 s on single
traces, 256 workers over 60 s of mixed traces under three policies,
heterogeneous capacitors and MCU classes. Required (the reference's own
backend contract, ``_assert_agreement``): exact counts (emitted, skipped,
acquired, power cycles, per-worker cycles, emit counts and units), drawn
energy ``e_work`` bit-equal, voltages and ``emit_acc_sum`` within rtol
1e-12 (they come out bit-equal). Also pinned: every policy's closed form
against the reference's on budgets at and one ulp around each cumulative
cost, the floor division of the sampling clock at exact multiples of the
period and one ulp either side, and the ``TypeError`` of a policy without
a closed form.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import policies as RP
from repro.core.budget import CostTable as RefCostTable
from repro.core.energy import get_trace, power_matrix
from repro.fleet import backend_numpy as RB
from repro.fleet.worker import FleetWorkerPool as RefPool
from repro.fleet.worker import stack_traces
from repro.launch.fleet import WORKLOAD_FACTORIES as REF_WL
from repro.launch.fleet import hetero_capacitors, hetero_mcu

from repro_torch.core import policies as PP
from repro_torch.core.budget import CostTable
from repro_torch.fleet.backend_torch import TorchFleetBackend
from repro_torch.fleet.state import FleetState, from_reference, to_numpy
from repro_torch.fleet.worker import FleetWorkerPool as PortPool
from repro_torch.launch.fleet import WORKLOAD_FACTORIES as PORT_WL

DT = 0.01
RTOL = 1e-12
COST_ARGS = (np.full(40, 2e-4), 1.2e-4, 1e-4)  # unit costs, emit, fixed


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _acc41():
    return np.linspace(1 / 6, 0.9, 41)


def _port_policy(ref_policy):
    cls = getattr(PP, type(ref_policy).__name__)
    return cls(**{f.name: getattr(ref_policy, f.name)
                  for f in dataclasses.fields(cls)})


def _local_pair(power, n_workers, policy, *, duration_ticks=None, seed=0,
                **kw):
    """The same local-mode fleet on both sides, run for the trace (or
    ``duration_ticks``); returns ``(ref_pool, port_pool, ref_stats,
    port_stats)``."""
    rng = np.random.default_rng(seed)
    common = dict(accuracy_table=_acc41(), mode="local",
                  sampling_period_s=10.0, n_workers=n_workers,
                  trace_index=np.arange(n_workers) % power.shape[0],
                  phase=rng.integers(0, power.shape[1], n_workers), **kw)
    u, e, f = COST_ARGS
    ref = RefPool(power, DT, workloads=[RefCostTable(u, e, f)],
                  policy=policy, backend="numpy", **common)
    port = PortPool(power, DT, workloads=[CostTable(u, e, f)],
                    policy=_port_policy(policy), kernel="f64", device="cpu",
                    **common)
    return ref, port, ref.run(duration_ticks), port.run(duration_ticks)


def _assert_agreement(ref, port, sr, sp):
    for k in ("emitted", "skipped", "acquired", "power_cycles"):
        assert getattr(sr, k) == getattr(sp, k), k
    assert sr.energy_harvested_j == sp.energy_harvested_j
    assert sr.energy_on_work_j == sp.energy_on_work_j
    assert sp.duration_s == sr.duration_s
    s, _ = to_numpy(port.state)
    for f in ("cycles", "emit_count", "emit_units_sum", "skipped",
              "acquired", "e_work", "sample_counter", "w_ticket"):
        a, b = getattr(ref.state, f), getattr(s, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("v", "emit_acc_sum"):
        np.testing.assert_allclose(getattr(s, f), getattr(ref.state, f),
                                   rtol=RTOL, atol=0, err_msg=f)
    # every field, every dtype: the float64 contract (expected bit-equal)
    for f in dataclasses.fields(FleetState):
        a, b = getattr(ref.state, f.name), getattr(s, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


@pytest.mark.parametrize("tname,policy", [
    ("RF", RP.Greedy()),
    ("SIR", RP.Smart(0.6)),
    ("SOM", RP.Greedy()),
])
def test_local_pool_matches_numpy_single_worker(tname, policy):
    tr = get_trace(tname, duration_s=300.0)
    ref, port, sr, sp = _local_pair(stack_traces([tr]), 1, policy)
    _assert_agreement(ref, port, sr, sp)
    assert sr.emitted > 0 or sr.skipped > 0  # the trace exercises it


@pytest.mark.parametrize("policy", [RP.Greedy(), RP.Smart(0.8),
                                    RP.Fixed(10)])
def test_local_pool_matches_numpy_256_workers(policy):
    power = power_matrix(["RF", "SOM", "SIM", "SOR", "SIR"], 16, 60.0, DT,
                         seed=7)
    ref, port, sr, sp = _local_pair(power, 256, policy, seed=7)
    _assert_agreement(ref, port, sr, sp)
    assert sr.emitted > 0 or sr.skipped > 0  # not a vacuous agreement


def test_local_pool_hetero_capacitors_match_numpy():
    power = power_matrix(["SOM", "RF", "SIR"], 8, 90.0, DT, seed=11)
    C, vmax = hetero_capacitors(64, seed=11)
    ref, port, sr, sp = _local_pair(power, 64, RP.Greedy(), capacitance_f=C,
                                    v_max=vmax, seed=11)
    _assert_agreement(ref, port, sr, sp)
    assert sr.emitted > 0


def test_local_pool_mcu_classes_match_numpy():
    power = power_matrix(["SOM", "RF", "SIR"], 6, 90.0, DT, seed=13)
    ap = hetero_mcu(48, seed=13)
    ref, port, sr, sp = _local_pair(power, 48, RP.Greedy(),
                                    active_power_w=ap, seed=13)
    _assert_agreement(ref, port, sr, sp)
    assert sr.emitted > 0
    assert len(np.unique(port.params.active_power_w)) > 1  # classes mixed


def test_local_pool_reset_and_macro_steps_replay():
    """reset() + run() replays the run; two macro-steps equal one."""
    power = power_matrix(["SOM", "SOR"], 4, 30.0, DT, seed=3)
    ref, port, sr, sp = _local_pair(power, 16, RP.Greedy(), seed=3)
    first, _ = to_numpy(port.state)
    port.reset()
    assert port.steps_done == 0 and port.emitted_count == 0
    port.step_macro(0, 1000)
    port.step_macro(1000, power.shape[1] - 1000)
    again, _ = to_numpy(port.state)
    for f in dataclasses.fields(FleetState):
        assert np.array_equal(getattr(first, f.name),
                              getattr(again, f.name)), f.name
    assert port.emitted_count == sr.emitted > 0


# ---------------------------------------------------------------------------
# policies: closed forms on exact cost boundaries
# ---------------------------------------------------------------------------


def _budget_grid(cum):
    """Every cumulative cost, one ulp either side, the gaps between, and
    budgets below and far above the table."""
    fin = cum[np.isfinite(cum)]
    pts = [fin, np.nextafter(fin, -np.inf), np.nextafter(fin, np.inf),
           (fin[:-1] + fin[1:]) / 2, [0.0, fin[0] / 2, fin[-1] * 4]]
    return np.concatenate([np.asarray(x, dtype=np.float64) for x in pts])


@pytest.mark.parametrize("policy", [
    RP.Greedy(), RP.Smart(0.8), RP.Smart(0.6), RP.Smart(0.9999),
    RP.Fixed(0), RP.Fixed(10), RP.Fixed(1000), RP.Continuous()])
@pytest.mark.parametrize("table", ["costs40", "har", "harris", "lm"])
def test_policy_closed_forms_equal_reference(policy, table):
    if table == "costs40":
        ref_costs, acc = RefCostTable(*COST_ARGS), _acc41()
        port_costs = CostTable(*COST_ARGS)
    else:
        rw, pw = REF_WL[table](), PORT_WL[table]()
        ref_costs, acc, port_costs = rw.costs, rw.accuracy, pw.costs
    budgets = _budget_grid(ref_costs.cumulative())
    want_i, want_r = policy.decide_batch(budgets, ref_costs, acc)
    got_i, got_r = _port_policy(policy).decide_batch(
        torch.as_tensor(budgets), port_costs, acc)
    assert got_i.dtype == torch.int64 and got_r.dtype == torch.bool
    assert np.array_equal(got_i.numpy(), want_i)
    assert np.array_equal(got_r.numpy(), want_r)
    # the per-budget scalar rule agrees too (the reference's definition)
    for j in range(0, budgets.shape[0], 7):
        d = policy.decide(float(budgets[j]), ref_costs, acc)
        assert (int(got_i[j]), bool(got_r[j])) == (d.initial_units,
                                                   d.refine_greedily)


def test_policy_without_closed_form_raises_type_error():
    class Loop(PP.Policy):  # no decide_batch override
        pass

    power = power_matrix(["SOM"], 1, 5.0, DT)
    pool = PortPool(power, DT, workloads=[CostTable(*COST_ARGS)],
                    policy=Loop(), accuracy_table=_acc41(), mode="local",
                    kernel="f64", device="cpu")
    with pytest.raises(TypeError, match="closed form"):
        pool.run(10)
    with pytest.raises(TypeError, match="closed form"):
        Loop().decide_batch(torch.zeros(3, dtype=torch.float64),
                            CostTable(*COST_ARGS), _acc41())


# ---------------------------------------------------------------------------
# the sampling clock: floor division at the period's multiples
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("period", [10.0, 2.56, 0.3, 7.0])
def test_floor_division_matches_numpy_at_multiples(period):
    k = np.arange(0, 200, dtype=np.float64)
    exact = k * period
    d = np.concatenate([exact, np.nextafter(exact, -np.inf),
                        np.nextafter(exact, np.inf), -exact[1:5]])
    got = torch.div(torch.as_tensor(d), period, rounding_mode="floor")
    assert np.array_equal(got.numpy(), d // period)


def test_acquire_local_sample_clock_matches_numpy():
    """One acquisition pass from a state whose sample clocks sit at
    ``t - k*P`` and a few ulps either side: sample counters, tickets and
    next sample times equal the reference's."""
    n, P = 240, 10.0
    power = power_matrix(["SOM"], 1, 300.0, DT, seed=2)
    u, e, f = COST_ARGS
    ref = RefPool(power, DT, workloads=[RefCostTable(u, e, f)],
                  policy=RP.Greedy(), accuracy_table=_acc41(), mode="local",
                  sampling_period_s=P, n_workers=n, backend="numpy")
    i = 12345
    t = i * DT
    rng = np.random.default_rng(4)
    base = t - P * rng.integers(0, 12, n)
    ulps = np.tile(np.arange(-4, 4), n // 8)
    nst = base.copy()
    for j in range(n):
        for _ in range(abs(ulps[j])):
            nst[j] = np.nextafter(nst[j], np.sign(ulps[j]) * np.inf)
    s = ref.state
    s.next_sample_t = nst
    s.on[:] = True
    s.v[:] = rng.uniform(1.7, 3.6, n)
    delta = t - nst
    assert (np.fmod(delta, P) == 0).any()  # exact multiples present
    assert (np.fmod(np.nextafter(delta, np.inf), P) == 0).any()
    assert (np.fmod(np.nextafter(delta, -np.inf), P) == 0).any()
    # a copy: on the CPU the converted tensors would share s's memory
    fp, fs, _, _ = from_reference(ref.params, copy.deepcopy(s),
                                  device="cpu")
    backend = TorchFleetBackend(fp, kernel="f64", device="cpu")
    idle = torch.as_tensor(s.on & ~s.has_work)
    got, _ = to_numpy(backend._acquire_local(fs, idle, t))
    RB._acquire_local(ref.params, s, s.on & ~s.has_work, t)
    for name in ("sample_counter", "next_sample_t", "w_ticket", "skipped",
                 "acquired", "v", "on", "has_work", "w_target", "e_work"):
        assert np.array_equal(getattr(s, name), getattr(got, name)), name
    assert s.acquired.sum() > 0 and (s.sample_counter > 1).any()
