"""Port (``repro_torch``) vs reference (``repro``): host-side construction.

Everything the serve path builds on the host from a seed must equal the
reference's array for array: power matrices of every trace family,
workload cost/accuracy tables, the quantized fleet constants, the reactive
control-plane params and the power lag window. Also pinned here: the port
imports neither jax nor ``repro``, and asks for a GPU it does not have
loudly instead of moving to the CPU.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.fleet import qtick as RQ
from repro.fleet import sched as RS
from repro.launch import fleet as RL

from repro_torch.core.policies import Greedy, Smart
from repro_torch.fleet import qtick as PQ
from repro_torch.fleet import sched as PS
from repro_torch.fleet.state import from_reference
from repro_torch.fleet.worker import FleetWorkerPool as PortPool
from repro_torch.launch import fleet as PL

DT = 0.01
FAMILIES = ("RF", "SOM", "SIM", "SOR", "SIR", "KIN", "ECL")
WORKLOADS = ("har", "harris", "lm")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def _one_thread():
    # tiny tensors: the intra-op thread pool only costs wake-ups
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


COST_FIELDS = ("unit_costs", "emit_cost", "fixed_cost")


def _assert_fields_equal(ref, port, names):
    for f in names:
        a, b = getattr(ref, f), getattr(port, f)
        if f == "tables":  # each side's own CostTable class
            assert len(a) == len(b), f
            for ta, tb in zip(a, b):
                _assert_fields_equal(ta, tb, COST_FIELDS)
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert np.array_equal(a, b), f
        else:
            assert a == b, f


def _pools(n, seed=0, hetero=False):
    power = RL.make_power_matrix(["RF", "SOM", "SIR"], min(6, n), 5.0, DT,
                                 seed)
    kw = {}
    if hetero:
        kw["capacitance_f"], kw["v_max"] = RL.hetero_capacitors(n, seed)
        kw["active_power_w"] = RL.hetero_mcu(n, seed)
    ref = RL.build_dispatch_pool(
        power, DT, n, [RL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS], seed,
        kernel="q32", **kw)
    port = PL.build_dispatch_pool(
        power, DT, n, [PL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS], seed,
        kernel="q32", device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("family", FAMILIES)
def test_power_matrix_equals_reference(family):
    """Every trace family synthesizes bit-identically from the same seed."""
    ref = RL.make_power_matrix([family], 3, 4.0, DT, seed=7)
    port = PL.make_power_matrix([family], 3, 4.0, DT, seed=7)
    assert ref.dtype == port.dtype and np.array_equal(ref, port)


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_tables_equal_reference(name):
    ref = RL.WORKLOAD_FACTORIES[name]()
    port = PL.WORKLOAD_FACTORIES[name]()
    assert ref.name == port.name and ref.floor == port.floor
    assert np.array_equal(ref.accuracy, port.accuracy)
    _assert_fields_equal(ref.costs, port.costs, COST_FIELDS)
    assert np.array_equal(ref.costs.cumulative(), port.costs.cumulative())


def test_hetero_helpers_equal_reference():
    for a, b in zip(RL.hetero_capacitors(64, 3), PL.hetero_capacitors(64, 3)):
        assert np.array_equal(a, b)
    assert np.array_equal(RL.hetero_mcu(64, 3), PL.hetero_mcu(64, 3))


@pytest.mark.parametrize("n,hetero", [(1, False), (64, False), (64, True)])
def test_fleet_params_and_quantization_equal_reference(n, hetero):
    ref, port = _pools(n, hetero=hetero)
    fp, _, _, _ = from_reference(ref.params, device="cpu")
    names = [f.name for f in dataclasses.fields(fp)]
    _assert_fields_equal(ref.params, port.params, names)
    _assert_fields_equal(fp, port.params, names)
    rq = RQ.quantize_fleet(ref.params)
    pq = PQ.quantize_fleet(port.params)
    _assert_fields_equal(rq, pq, [f.name for f in dataclasses.fields(pq)])


def test_local_fleet_params_convert_from_reference():
    """A float64 local-mode fleet converts with its cost table and its
    policy as the port's own classes, equal field for field."""
    from repro.core.policies import Smart as RefSmart
    from repro.fleet.worker import FleetWorkerPool as RefPool
    power = RL.make_power_matrix(["SOM", "SIR"], 2, 5.0, DT, 1)
    ref_wl, port_wl = RL.WORKLOAD_FACTORIES["har"](), PL.WORKLOAD_FACTORIES[
        "har"]()
    kw = dict(mode="local", n_workers=8, accuracy_table=ref_wl.accuracy,
              sampling_period_s=7.5, phase=np.arange(8) * 37)
    ref = RefPool(power, DT, workloads=[ref_wl.costs],
                  policy=RefSmart(0.7), backend="numpy", **kw)
    port = PortPool(power, DT, workloads=[port_wl.costs], policy=Smart(0.7),
                    kernel="f64", device="cpu", **kw)
    fp, fs, _, _ = from_reference(ref.params, ref.state, device="cpu")
    names = [f.name for f in dataclasses.fields(fp)]
    _assert_fields_equal(ref.params, port.params,
                         [f for f in names if f != "policy"])
    _assert_fields_equal(fp, port.params, names)
    assert fp.quantum_j is None and fp.mode == "local"
    assert type(fp.policy) is Smart and fp.policy.min_accuracy == 0.7
    assert fs.v.dtype == torch.float64 and fs.cycles.dtype == torch.int64


@pytest.mark.parametrize("n", [1, 64])
def test_reactive_sched_params_equal_reference(n):
    ref_pool, port_pool = _pools(n)
    kw = dict(max_batch=3, grace_s=15.0, shed_after_s=25.0, lookahead_s=2.0)
    ref = RS.make_sched_params(
        ref_pool.params, [RL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS],
        sched="reactive", **kw)
    port = PS.make_sched_params(
        port_pool.params, [PL.WORKLOAD_FACTORIES[k]() for k in WORKLOADS],
        sched="reactive", **kw)
    _assert_fields_equal(ref, port,
                         [f.name for f in dataclasses.fields(port)])
    _, _, conv, _ = from_reference(sched_params=ref, device="cpu")
    assert PS.sched_params_compatible(conv, conv)
    assert not PS.sched_params_compatible(None, conv)
    refit = dataclasses.replace(conv, FC_MU=conv.FC_MU + 1.0)
    assert PS.sched_params_compatible(conv, refit)
    assert not PS.sched_params_compatible(
        conv, dataclasses.replace(conv, grace_s=1.0))


def test_power_lags_equal_reference():
    ref_pool, port_pool = _pools(64)
    p = ref_pool.params
    for i in (0, 3, 499):
        want = RS.power_lags(p.power, p.trace_index, i, p.T, 3,
                             phase=p.phase)
        got = PS.power_lags(torch.as_tensor(p.power),
                            torch.as_tensor(p.trace_index), i, p.T, 3,
                            phase=torch.as_tensor(p.phase))
        assert np.array_equal(want, got.numpy())


def test_request_stream_equals_reference():
    from repro.fleet.scheduler import RequestStream as RefStream
    from repro_torch.fleet.scheduler import RequestStream as PortStream
    mix = np.array([0.4, 0.3, 0.3])
    ref = RefStream(25.6, mix, 500, DT, seed=5).counts_matrix(3)
    port = PortStream(25.6, mix, 500, DT, seed=5).counts_matrix(3)
    assert np.array_equal(ref, port)


def test_port_imports_no_jax_and_no_reference():
    """With jax blocked, every port module imports and no ``repro``
    module is loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "import repro_torch.launch.fleet\n"
        "import repro_torch.core.policies\n"
        "import repro_torch.kernels.harvest_step\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert {'repro_torch.core.policies', "
        "'repro_torch.kernels.harvest_step'} <= set(sys.modules)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not "
        "None and (m == 'repro' or m.startswith(('repro.', 'jax'))))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_requested_without_gpu_raises(monkeypatch):
    """The default device is CUDA; without a GPU the entry points raise
    rather than quietly serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    power = PL.make_power_matrix(["SOM"], 1, 1.0, DT)
    wls = [PL.WORKLOAD_FACTORIES["har"]()]
    for kernel in ("cuda", "q32", "f64"):
        with pytest.raises(RuntimeError, match="cuda"):
            PL.run_scheduled(power, DT, 4, wls, rate_rps=1.0,
                             mix=np.array([1.0]), n_steps=10,
                             kernel=kernel)
    with pytest.raises(RuntimeError, match="cuda"):
        PL.run_independent(power, DT, 4, wls, mix=np.array([1.0]),
                           period_s=10.0, n_steps=10)
    with pytest.raises(RuntimeError, match="cuda"):
        PortPool(power, DT, workloads=[wls[0].costs], n_workers=2)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Without nvcc the CUDA build raises; nothing is written."""
    from repro_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "CUDA_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["serve_tick"])
    assert not (tmp_path / "kernels").exists()


def test_unported_values_raise():
    power = PL.make_power_matrix(["SOM"], 1, 1.0, DT)
    wls = [PL.WORKLOAD_FACTORIES["har"]()]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        PortPool(power, DT, workloads=[wls[0].costs], n_workers=2,
                 kernel="pallas", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        PortPool(power, DT, workloads=[wls[0].costs], n_workers=2,
                 persist="ckpt", kernel="f64", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        PL.run_scheduled(power, DT, 2, wls, rate_rps=1.0,
                         mix=np.array([1.0]), n_steps=10, sched="forecast",
                         kernel="q32", device="cpu")
    for flags in (["--kernel", "xla"], ["--kernel", "pallas"],
                  ["--backend", "numpy"], ["--stream"],
                  ["--mesh-fleet", "2"], ["--persist", "ckpt"],
                  ["--obs", "tele"], ["--sched", "forecast"]):
        with pytest.raises(SystemExit):
            PL.main(flags + ["--device", "cpu", "--workers", "2"])


def test_kernel_xla_exits_naming_f64(capsys):
    """The reference's ``--kernel xla`` is not a second name for the
    float64 tick: it exits and names the port's ``f64``."""
    with pytest.raises(SystemExit):
        PL.main(["--kernel", "xla", "--device", "cpu", "--workers", "2"])
    assert "--kernel f64" in capsys.readouterr().err


def test_quantized_kernels_refuse_local_mode():
    power = PL.make_power_matrix(["SOM"], 1, 1.0, DT)
    har = PL.WORKLOAD_FACTORIES["har"]()
    for kernel in ("q32", "cuda"):
        with pytest.raises(ValueError, match="local mode stays float64"):
            PortPool(power, DT, workloads=[har.costs], n_workers=2,
                     mode="local", policy=Greedy(),
                     accuracy_table=har.accuracy, kernel=kernel,
                     device="cpu")
    with pytest.raises(ValueError, match="local mode needs"):
        PortPool(power, DT, workloads=[har.costs], n_workers=2,
                 mode="local", kernel="f64", device="cpu")


def test_cli_serves_on_cpu(tmp_path):
    out = tmp_path / "s.json"
    res = PL.main(["--workers", "8", "--duration", "2", "--traces", "SOR",
                   "--kernel", "q32", "--device", "cpu",
                   "--json", str(out)])
    assert out.exists()
    s = res["scheduled"]
    assert s["submitted"] > 0 and s["kernel"] == "q32"
    assert s["energy"]["conservation_ok"]
