"""Port's float64 serve and independent baseline vs the reference's NumPy.

The slice as a whole, on the CPU:

- ``repro_torch.launch.fleet.run_scheduled(kernel="f64")`` against the
  reference's ``run_scheduled(backend="numpy", kernel="xla")`` at N in
  {1, 256} over 20 s of RF + SOM with the har, harris and lm workloads,
  and a bursty KIN + RF fleet with tight shedding and retry budgets;
- one dispatch tick from fuzzed states piled at the brown-out floor, so
  that acquisitions, mid-unit draws and emissions fail: the float64 LOST
  events of each site against the reference's event tuples;
- ``run_independent`` (one float64 local-mode pool per workload) against
  the reference's at N = 256 over 60 s;
- ``main --scheduler both --kernel f64`` against the reference's ``main
  --scheduler both --backend numpy``: both blocks and
  ``speedup_completed``.

Tolerance: every counter, histogram, energy ledger and final state field
exact (the float64 tick is bit-equal to the NumPy reference); only the
float64 accumulators ``acc_wl`` and ``lat_sum`` (and the means derived
from them), which the control plane sums in another order, within rel
1e-12. ``p_t_assigned`` is in seconds on both sides.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro.fleet import backend_numpy as RB
from repro.fleet.scheduler import FleetScheduler as RefScheduler
from repro.fleet.scheduler import RequestStream as RefStream
from repro.fleet.scheduler import run_fleet as ref_run_fleet
from repro.launch import fleet as RL

from repro_torch.fleet import qtick as PQ
from repro_torch.fleet import scheduler as PSch
from repro_torch.fleet.backend_torch import TorchFleetBackend
from repro_torch.fleet.state import (FleetState, SchedState, from_reference,
                                     to_numpy)
from repro_torch.kernels import harvest_step as PK
from repro_torch.launch import fleet as PL

DT = 0.01
DURATION_S = 20.0
N_STEPS = int(DURATION_S / DT)
WORKLOADS = ("har", "harris", "lm")
MIX = np.array([0.4, 0.3, 0.3])
COUNT_KEYS = ("submitted", "completed", "rejected", "shed", "lost",
              "evicted", "requeued")
# float64 sums accumulated in another order than the reference's
FLOAT_SUM_KEYS = ("latency_mean_s", "mean_expected_accuracy",
                  "proxy_minus_measured")
FLOAT_SUM_FIELDS = ("acc_wl", "lat_sum")
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _power(n):
    return RL.make_power_matrix(["RF", "SOM"], min(4, n), DURATION_S, DT, 0)


def _rate(n):
    return max(n / 10.0, 0.5)


def _assert_summary_equal(ref, got, key=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), key
        for k in ref:
            _assert_summary_equal(ref[k], got[k], k)
    elif key in FLOAT_SUM_KEYS:
        assert got == pytest.approx(ref, rel=RTOL, abs=RTOL), key
    else:
        assert got == ref, key


def _assert_states_equal(ref_fs, ref_ss, pool, sched):
    fs, ss = to_numpy(pool.state, sched.state)
    for f in (f.name for f in dataclasses.fields(FleetState)):
        want, got = np.asarray(getattr(ref_fs, f)), getattr(fs, f)
        assert want.dtype == got.dtype and np.array_equal(want, got), f
    for f in (f.name for f in dataclasses.fields(SchedState)):
        want, got = np.asarray(getattr(ref_ss, f)), getattr(ss, f)
        assert want.dtype == got.dtype and want.shape == got.shape, f
        if f in FLOAT_SUM_FIELDS:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
        else:
            assert np.array_equal(want, got), f


@pytest.fixture(scope="module")
def reference():
    """The reference's float64 serve per fleet size: ``run_scheduled``'s
    body kept open so the final states can be read."""
    out = {}
    for n in (1, 256):
        wls = [RL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS]
        pool = RL.build_dispatch_pool(_power(n), DT, n, wls, 0,
                                      backend="numpy", kernel="xla")
        sched = RefScheduler(pool, wls)
        stream = RefStream(_rate(n), MIX, N_STEPS, DT, seed=1)
        summary = ref_run_fleet(pool, sched, stream, N_STEPS)
        out[n] = (summary, pool.state, sched.state)
    return out


@pytest.mark.parametrize("n", [1, 256])
def test_run_scheduled_f64_equals_reference(n, reference):
    ref, _, _ = reference[n]
    got = PL.run_scheduled(
        _power(n), DT, n, [PL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS],
        rate_rps=_rate(n), mix=MIX, n_steps=N_STEPS, seed=0, kernel="f64",
        device="cpu")
    assert got["kernel"] == "f64"
    for k in ("mode", "sched", "persist", "forecaster", "n_workers",
              "backend", "kernel", "mesh_fleet"):
        got.pop(k)
    assert {k: got[k] for k in COUNT_KEYS} == {k: ref[k] for k in COUNT_KEYS}
    if n == 256:  # the run exercises the whole lifecycle
        assert ref["completed"] > 100 and ref["per_workload"].keys() == set(
            WORKLOADS)
    _assert_summary_equal(ref, got)


@pytest.mark.parametrize("n", [1, 256])
def test_f64_final_state_equals_reference(n, reference):
    ref_summary, ref_fs, ref_ss = reference[n]
    pool, sched, stream = PL.build_scheduled(
        _power(n), DT, n, [PL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS],
        rate_rps=_rate(n), mix=MIX, n_steps=N_STEPS, seed=0, kernel="f64",
        device="cpu")
    launches = PK.harvest_step.launches
    summary = PSch.run_fleet(pool, sched, stream, N_STEPS)
    assert PK.harvest_step.launches == launches  # CPU tensors: no launch
    _assert_summary_equal(ref_summary, summary)
    assert pool.params.quantum_j is None
    stats = pool.stats()
    assert stats.energy_harvested_j == summary["energy"]["harvested_j"]
    assert stats.energy_on_work_j == summary["energy"]["work_j"]
    assert stats.duration_s == pytest.approx(DURATION_S)
    _assert_states_equal(ref_fs, ref_ss, pool, sched)
    # the unit loop's fleet-wide test is read on the host once per
    # iteration, at least once per tick
    assert pool._torch.host_syncs >= N_STEPS


def test_f64_serve_under_shedding_and_retry_budgets():
    """Bursty KIN + RF harvest, a 10 s shedding horizon, a 2 s straggler
    grace and one retry (``tests/test_fleet_backends.py:262-273`` with
    reactive routing): every counter and final state equal."""
    wl_names = ("har", "lm")
    mix = np.array([0.5, 0.5])
    power = RL.make_power_matrix(["KIN", "RF"], 4, 60.0, DT, seed=21)
    n_steps = int(60.0 / DT)
    kw = dict(shed_after_s=10.0, grace_s=2.0, max_retries=1,
              sched="reactive")
    wls = [RL.WORKLOAD_FACTORIES[k]() for k in wl_names]
    ref_pool = RL.build_dispatch_pool(power, DT, 24, wls, 21,
                                      backend="numpy", kernel="xla")
    ref_sched = RefScheduler(ref_pool, wls, **kw)
    ref = ref_run_fleet(ref_pool, ref_sched,
                        RefStream(6.0, mix, n_steps, DT, seed=22), n_steps)
    assert ref["shed"] + ref["lost"] + ref["requeued"] > 0  # paths taken
    pwls = [PL.WORKLOAD_FACTORIES[k]() for k in wl_names]
    pool = PL.build_dispatch_pool(power, DT, 24, pwls, 21, kernel="f64",
                                  device="cpu")
    sched = PSch.FleetScheduler(pool, pwls, **kw)
    got = PSch.run_fleet(pool, sched,
                         PSch.RequestStream(6.0, mix, n_steps, DT, seed=22),
                         n_steps)
    _assert_summary_equal(ref, got)
    _assert_states_equal(ref_pool.state, ref_sched.state, pool, sched)


def _fuzz_dispatch_state(s, p, rng):
    """A float64 dispatch state with voltages piled just above the
    brown-out floor, random in-flight work and pending assignments."""
    n = p.n
    W = p.FIX.shape[0]
    v = rng.uniform(p.v_off - 0.02, p.v_off + 0.15, n)
    high = rng.random(n) < 0.3
    s.v = np.where(high, rng.uniform(p.v_off, 3.6, n), v)
    s.on = rng.random(n) < 0.9
    s.has_work = s.on & (rng.random(n) < 0.5)
    s.w_wl = rng.integers(0, W, n)
    s.w_tile = rng.integers(1, 4, n)
    s.w_batch = rng.integers(1, 3, n)
    s.w_target = s.w_tile * s.w_batch
    s.w_units_done = rng.integers(0, 7, n)
    s.w_left = np.where(rng.random(n) < 0.5, 0.0,
                        rng.uniform(0.0, 2e-4, n))
    s.w_ticket = rng.integers(0, 1000, n)
    s.p_pending = ~s.has_work & (rng.random(n) < 0.7)
    s.p_wl = rng.integers(0, W, n)
    s.p_units = rng.integers(1, 4, n)
    s.p_batch = rng.integers(1, 3, n)
    s.p_ticket = rng.integers(1000, 2000, n)
    return s


def test_f64_dispatch_tick_lost_events_equal_reference():
    """One float64 dispatch tick from states at the brown-out floor: the
    port's event lanes equal the reference's event tuples, LOST at
    acquisition, mid-unit and at emission, and every state field equal."""
    n = 3000
    wls = [RL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS]
    power = RL.make_power_matrix(["RF", "SOM"], 8, 10.0, DT, seed=3)
    ref_pool = RL.build_dispatch_pool(power, DT, n, wls, 3,
                                      backend="numpy", kernel="xla")
    p = ref_pool.params
    rng = np.random.default_rng(3)
    sites = {"acquire": 0, "progress": 0, "emit": 0}
    for trial in range(4):
        s = _fuzz_dispatch_state(copy.deepcopy(ref_pool.state), p, rng)
        i = int(rng.integers(0, 900))
        # a copy: on the CPU the converted tensors share s's memory
        fp, fs, _, _ = from_reference(p, copy.deepcopy(s), device="cpu")
        backend = TorchFleetBackend(fp, kernel="f64", device="cpu")
        got_fs, ev = backend.tick(fs, i)
        events = []
        RB.tick(p, s, i, None, events)
        code, ev_t, ticket, units = (x.numpy() for x in ev)
        hit = np.nonzero(code != PQ.EV_NONE)[0]
        got = sorted(
            (("emit", float(ev_t[w]), int(w), int(ticket[w]), int(units[w]))
             if code[w] == PQ.EV_EMIT else
             ("lost", float(ev_t[w]), int(w), int(ticket[w])))
            for w in hit)
        want = sorted(e[:5] if e[0] == RB.EMIT else e for e in events)
        assert got == want
        fs_np, _ = to_numpy(got_fs)
        for f in dataclasses.fields(FleetState):
            a, b = getattr(s, f.name), getattr(fs_np, f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        # which site lost each request: assignments claimed this tick,
        # work that ran out of energy mid-unit, and failed emissions
        pre, _ = to_numpy(fs)
        lost = code == PQ.EV_LOST
        was_pending = pre.p_pending & pre.on & ~pre.has_work
        sites["acquire"] += int((lost & was_pending).sum())
        sites["emit"] += int((lost & pre.has_work & pre.on
                              & (pre.w_units_done >= pre.w_target)).sum())
        sites["progress"] += int((lost & pre.has_work & pre.on
                                  & (pre.w_units_done < pre.w_target)).sum())
    assert all(sites.values()), sites


def test_run_independent_equals_reference():
    n, dur = 256, 60.0
    power = RL.make_power_matrix(["RF", "SOM", "SIM", "SOR", "SIR"], 32, dur,
                                 DT, 0)
    kw = dict(mix=MIX, period_s=10.0, n_steps=int(dur / DT), seed=0)
    ref = RL.run_independent(
        power, DT, n, [RL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS],
        backend="numpy", **kw)
    got = PL.run_independent(
        power, DT, n, [PL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS],
        device="cpu", **kw)
    assert got.pop("backend") == "torch"
    ref.pop("backend")
    assert got == ref
    assert ref["completed"] > 0 and ref["skipped"] > 0
    assert len(ref["per_workload"]) == 3


def test_main_scheduler_both_equals_reference():
    args = ["--workers", "16", "--duration", "30", "--scheduler", "both"]
    ref = RL.main(args + ["--backend", "numpy"])
    got = PL.main(args + ["--kernel", "f64", "--device", "cpu"])
    assert set(got) == set(ref) == {"config", "scheduled", "independent",
                                    "speedup_completed"}
    for block, keys in (("scheduled", ("backend", "kernel")),
                        ("independent", ("backend",))):
        for k in keys:
            ref[block].pop(k)
            got[block].pop(k)
        _assert_summary_equal(ref[block], got[block])
    assert got["speedup_completed"] == ref["speedup_completed"]
    assert ref["scheduled"]["completed"] > 0
    assert ref["independent"]["completed"] > 0
