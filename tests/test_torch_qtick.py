"""Port's int32 serve tick vs the reference's, on adversarial states.

``repro_torch.kernels.serve_tick`` on CPU tensors runs its plain version
(``repro_torch.fleet.qtick.tick_q``). It must be bit-exact against both
reference evaluations of the same tick: the NumPy driver
``repro.fleet.qtick.tick_q(xp=np, while_loop=np_while)`` and the Pallas
megakernel ``repro.kernels.serve_tick.serve_tick`` in interpret mode —
every read-write field, the four event lanes and the eight ledger-lane
totals. States are piled near the E_ON / E_OFF thresholds (the recipe of
``tests/test_quant_kernel.py``) and enter the port through
``from_reference``. Tolerance: none (integer path).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.energy import quantize_energy
from repro.fleet import qtick as RQ
from repro.fleet.state import STATE_FIELDS, init_state
from repro.fleet.worker import FleetWorkerPool
from repro.kernels import serve_tick as RK
from repro.launch.fleet import WORKLOAD_FACTORIES, make_power_matrix

from repro_torch.fleet import qtick as PQ
from repro_torch.fleet.state import from_reference, to_numpy
from repro_torch.kernels import serve_tick as PK

DT = 0.01
WORKLOADS = ("har", "harris", "lm")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_pool(n, power_w=None, seed=0):
    if power_w is None:
        power = make_power_matrix(["SOM"], 4, 10.0, DT, 0)
    else:
        power = np.full((1, 1000), power_w)
    rng = np.random.default_rng(seed)
    return FleetWorkerPool(
        power, DT, workloads=[WORKLOAD_FACTORIES[k]().costs
                              for k in WORKLOADS],
        mode="dispatch", n_workers=n,
        trace_index=np.arange(n) % power.shape[0],
        phase=rng.integers(0, power.shape[1], n),
        backend="numpy", kernel="q32")


def _fuzz_state(s, qp, W, rng, n):
    """tests/test_quant_kernel.py's recipe: states near the thresholds."""
    s.v = rng.integers(0, np.asarray(qp.E_MAX) + 1, n).astype(np.int32)
    near = rng.random(n) < 0.5
    base = np.where(rng.random(n) < 0.5, np.asarray(qp.E_ON),
                    np.asarray(qp.E_OFF))
    s.v = np.where(near, (base + rng.integers(-2, 3, n))
                   .clip(0).astype(np.int32), s.v).astype(np.int32)
    s.on = rng.random(n) < 0.7
    s.has_work = s.on & (rng.random(n) < 0.5)
    s.w_wl = rng.integers(0, W, n).astype(np.int32)
    s.w_tile = rng.integers(0, 4, n).astype(np.int32)
    s.w_batch = rng.integers(1, 4, n).astype(np.int32)
    s.w_target = (s.w_tile * s.w_batch).astype(np.int32)
    s.w_units_done = rng.integers(0, 5, n).astype(np.int32)
    s.w_left = rng.integers(0, 30000, n).astype(np.int32)
    s.w_ticket = rng.integers(0, 100, n).astype(np.int32)
    s.p_pending = (~s.has_work) & (rng.random(n) < 0.6)
    s.p_wl = rng.integers(0, W, n).astype(np.int32)
    s.p_units = rng.integers(0, 4, n).astype(np.int32)
    s.p_batch = rng.integers(1, 4, n).astype(np.int32)
    s.p_ticket = rng.integers(100, 200, n).astype(np.int32)
    return s


def _pallas(p, qp, s, qh, i):
    """The reference megakernel in interpret mode: (rw, ev, ledger totals)."""
    u_max = int(p.UC.shape[1])
    W = qp.FIXQ.shape[0]
    pad8 = lambda k: -(-k // 8) * 8  # noqa: E731
    tables = dict(
        uc=RK.replicate_table(np.asarray(qp.UCQ).reshape(-1),
                              pad8(W * u_max)),
        fix=RK.replicate_table(qp.FIXQ, pad8(W)),
        emitc=RK.replicate_table(qp.EMITCQ, pad8(W)))
    consts = dict(e_on=jnp.asarray(qp.E_ON), e_off=jnp.asarray(qp.E_OFF),
                  e_max=jnp.asarray(qp.E_MAX), estep=jnp.asarray(qp.ESTEP))
    rw = {f: jnp.asarray(np.asarray(getattr(s, f))) for f in RK.RW_FIELDS}
    ro = {f: jnp.asarray(np.asarray(getattr(s, f))) for f in RK.RO_FIELDS}
    rw_out, ev, led = RK.serve_tick(rw, ro, consts, tables,
                                    jnp.asarray(qh, jnp.int32), jnp.int32(i),
                                    u_max=u_max, interpret=True)
    return ({f: np.asarray(x) for f, x in rw_out.items()},
            tuple(np.asarray(x) for x in ev),
            np.asarray(led).astype(np.int64).sum(axis=0)[:8])


def _port(p, s, qh, i):
    """The port's wrapper on CPU tensors: (rw, ev, ledger), in place."""
    fp, fs, _, _ = from_reference(p, s, device="cpu")
    qp = PQ.to_device(PQ.quantize_fleet(fp), "cpu")
    launches = PK.serve_tick.launches
    ev, led = PK.serve_tick(fs, qp, torch.as_tensor(qh), i)
    assert PK.serve_tick.launches == launches  # CPU: plain version
    out, _ = to_numpy(fs)
    return ({f: getattr(out, f) for f in PQ.RW_FIELDS},
            tuple(x.numpy() for x in ev), led.numpy().astype(np.int64))


def _assert_three_way(p, qp, s, qh, i):
    st = tuple(np.asarray(getattr(s, f)) for f in STATE_FIELDS)
    z = lambda: np.zeros(p.n, dtype=np.int32)  # noqa: E731
    st_ref, ev_ref = RQ.tick_q(p, qp, st, (z(), z(), z(), z()), qh, i, np,
                               RQ.np_while)
    ref = dict(zip(STATE_FIELDS, st_ref))
    k_rw, k_ev, k_led = _pallas(p, qp, s, qh, i)
    t_rw, t_ev, t_led = _port(p, s, qh, i)
    for f in PQ.RW_FIELDS:
        want = np.asarray(ref[f])
        assert t_rw[f].dtype == want.dtype, f
        assert np.array_equal(t_rw[f], want), f
        assert np.array_equal(t_rw[f].astype(np.int64),
                              k_rw[f].astype(np.int64)), f
    for a, b, c in zip(ev_ref, k_ev, t_ev):
        assert c.dtype == np.int32
        assert np.array_equal(a, c) and np.array_equal(b, c)
    assert np.array_equal(k_led, t_led), (k_led, t_led)
    evc = np.asarray(ev_ref[0])
    assert t_led[0] == int((evc == RQ.EV_EMIT).sum())
    assert t_led[1] == int((evc == RQ.EV_LOST).sum())
    assert t_led[5] == int(np.asarray(qh).sum())
    return evc


@pytest.mark.parametrize("n", [1, 64, 300])
def test_tick_matches_reference_fuzz(n):
    pool = _ref_pool(n, seed=n)
    p = pool.params
    qp = RQ.quantize_fleet_cached(p)
    rng = np.random.default_rng(n)
    seen = set()
    for _ in range(6):
        s = _fuzz_state(init_state(n, quantized=True), qp, len(WORKLOADS),
                        rng, n)
        i = int(rng.integers(0, 900))
        qh = RQ.harvest_row(p, qp, p.trace_index, p.phase, i, np)
        seen |= set(_assert_three_way(p, qp, s, qh, i).tolist())
    if n >= 64:  # the fuzz reaches emissions and losses, not just no-ops
        assert {RQ.EV_EMIT, RQ.EV_LOST} <= seen


def test_wake_at_half_quantum_boundaries():
    """A float64 state within half a quantum of v_on quantizes to E_ON
    and wakes; just beyond half a quantum below stays off — in the port
    as in both reference evaluations."""
    pool = _ref_pool(3, power_w=0.0)
    p = pool.params
    qp = RQ.quantize_fleet_cached(p)
    e_on_j = 0.5 * float(p.C[0]) * float(p.v_on) ** 2
    s = init_state(3, quantized=True)
    s.v = np.array([int(quantize_energy(e_on_j + dj))
                    for dj in (+0.4e-9, -0.4e-9, -0.6e-9)], np.int32)
    qh = np.zeros(3, np.int32)
    _assert_three_way(p, qp, s, qh, 0)
    fp, fs, _, _ = from_reference(p, s, device="cpu")
    PK.serve_tick(fs, PQ.to_device(PQ.quantize_fleet(fp), "cpu"),
                  torch.as_tensor(qh), 0)
    assert fs.on.tolist() == [True, True, False]
    assert fs.cycles.tolist() == [1, 1, 0]


def test_state_round_trip_keeps_dtypes():
    s = init_state(5, quantized=True)
    _, fs, _, _ = from_reference(fleet_state=s, device="cpu")
    back, _ = to_numpy(fs)
    for f in STATE_FIELDS:
        a, b = getattr(s, f), getattr(back, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_wrapper_rejects_what_the_kernel_cannot_take():
    """Shape, dtype and device checks run before any CUDA launch."""
    pool = _ref_pool(4)
    fp, fs, _, _ = from_reference(pool.params,
                                  init_state(4, quantized=True),
                                  device="cpu")
    qp = PQ.to_device(PQ.quantize_fleet(fp), "cpu")
    qh = torch.zeros(4, dtype=torch.int32)
    fs.v = fs.v.to(torch.int64)
    with pytest.raises(ValueError, match="v must be"):
        PK._check(fs, qp, qh)
    fs.v = fs.v.to(torch.int32)
    with pytest.raises(ValueError, match="qh must be"):
        PK._check(fs, qp, qh[None])
    with pytest.raises(ValueError, match=r"v must be a contiguous \(3,\)"):
        PK._check(fs, qp, torch.zeros(3, dtype=torch.int32))
    assert PK._check(fs, qp, qh) == (4, 3, fp.UC.shape[1])
