"""Port's fused serve vs the reference's NumPy q32 serve, end to end.

The slice as a whole: ``repro_torch.launch.fleet.run_scheduled`` on the CPU
against ``repro.launch.fleet.run_scheduled(backend="numpy", kernel="q32")``
(which ``tests/test_quant_kernel.py`` pins equal to the Pallas launch), at
N in {1, 256} over 20 s of RF + SOM traces with the har, harris and lm
workloads. Every lifecycle counter, per-workload count, the latency and
batch histograms, the quality ledger, the energy ledger and the final
device and control-plane states must be equal. Tolerance: exact, except
the float64 accumulators ``acc_wl`` and ``lat_sum`` (and the means derived
from them), which sum in another order: rel 1e-12.

``kernel="cuda"`` on CPU tensors runs the wrapper's plain version, so the
same comparison also pins the kernel path's plumbing (in-place state,
event lanes) short of the launch itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.fleet.scheduler import FleetScheduler as RefScheduler
from repro.fleet.scheduler import RequestStream as RefStream
from repro.fleet.scheduler import run_fleet as ref_run_fleet
from repro.launch import fleet as RL

from repro_torch.fleet import scheduler as PSch
from repro_torch.fleet.state import FleetState, SchedState, to_numpy
from repro_torch.kernels import serve_tick as PK
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


@pytest.fixture(scope="module")
def reference():
    """The reference serve per fleet size: ``run_scheduled``'s body
    (pool, scheduler, stream seeded ``seed + 1``, ``run_fleet``) kept
    open so the final states can be read."""
    out = {}
    for n in (1, 256):
        wls = [RL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS]
        pool = RL.build_dispatch_pool(_power(n), DT, n, wls, 0,
                                      backend="numpy", kernel="q32")
        sched = RefScheduler(pool, wls)
        stream = RefStream(_rate(n), MIX, N_STEPS, DT, seed=1)
        summary = ref_run_fleet(pool, sched, stream, N_STEPS)
        out[n] = (summary, pool.state, sched.state)
    return out


def _assert_summary_equal(ref, got, key=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), key
        for k in ref:
            _assert_summary_equal(ref[k], got[k], k)
    elif key in FLOAT_SUM_KEYS:
        assert got == pytest.approx(ref, rel=RTOL, abs=RTOL), key
    else:
        assert got == ref, key


@pytest.mark.parametrize("n", [1, 256])
def test_run_scheduled_equals_reference(n, reference):
    ref, _, _ = reference[n]
    got = PL.run_scheduled(
        _power(n), DT, n, [PL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS],
        rate_rps=_rate(n), mix=MIX, n_steps=N_STEPS, seed=0, kernel="q32",
        device="cpu")
    for k in ("mode", "sched", "persist", "forecaster", "n_workers",
              "backend", "kernel", "mesh_fleet"):
        got.pop(k)
    assert {k: got[k] for k in COUNT_KEYS} == {k: ref[k] for k in COUNT_KEYS}
    if n == 256:  # the run exercises the whole lifecycle
        assert ref["completed"] > 100 and ref["per_workload"].keys() == set(
            WORKLOADS)
    _assert_summary_equal(ref, got)


@pytest.mark.parametrize("kernel", ["q32", "cuda"])
@pytest.mark.parametrize("n", [1, 256])
def test_final_state_equals_reference(n, kernel, reference):
    ref_summary, ref_fs, ref_ss = reference[n]
    pool, sched, stream = PL.build_scheduled(
        _power(n), DT, n, [PL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS],
        rate_rps=_rate(n), mix=MIX, n_steps=N_STEPS, seed=0, kernel=kernel,
        device="cpu")
    launches = PK.serve_tick.launches
    summary = PSch.run_fleet(pool, sched, stream, N_STEPS)
    assert PK.serve_tick.launches == launches  # CPU tensors: no launch
    _assert_summary_equal(ref_summary, summary)
    stats = pool.stats()
    assert stats.energy_harvested_j == summary["energy"]["harvested_j"]
    assert stats.duration_s == pytest.approx(DURATION_S)
    fs, ss = to_numpy(pool.state, sched.state)
    assert stats.emitted == int(fs.emit_count.sum())
    for f in (f.name for f in dataclasses.fields(FleetState)):
        want, got = np.asarray(getattr(ref_fs, f)), getattr(fs, f)
        if f == "p_t_assigned":
            # the reference's host driver stamps seconds, the fused
            # serve (like the JAX scan) integer ticks
            got = got.astype(np.float64) * DT
        assert np.array_equal(want, got), f
    for f in (f.name for f in dataclasses.fields(SchedState)):
        want, got = np.asarray(getattr(ref_ss, f)), getattr(ss, f)
        assert want.dtype == got.dtype and want.shape == got.shape, f
        if f in FLOAT_SUM_FIELDS:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
        else:
            assert np.array_equal(want, got), f
