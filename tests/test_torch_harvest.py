"""The float64 harvest kernel's plain version vs the reference, on the CPU.

``repro_torch.kernels.harvest_step.harvest_step_plain`` (what the wrapper
runs for CPU tensors, and what the CUDA kernel is held to on the card)
against ``repro.core.energy.capacitor_harvest`` (the NumPy expression the
reference's float64 tick runs): bit-exact, at N in {1, 1000}, with
heterogeneous capacitors, voltages at 0 and past saturation, and power
over [0, 1e-2] W. Against the Pallas TPU kernel in interpret mode
(``repro.kernels.fleet_step.harvest_step`` under a scoped
``jax.enable_x64``): rtol 1e-12, because XLA contracts a multiply-add into
an FMA there (2.6e-16 relative seen). Also pinned: the port's capacitor
helpers equal the reference's bit for bit, the wrapper launches nothing
for CPU tensors, and it refuses a wrong dtype, shape or device mix.
"""
from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

from repro.core import energy as RE
from repro.kernels.fleet_step import harvest_step as pallas_harvest
from repro.launch.fleet import hetero_capacitors

from repro_torch.core import energy as PE
from repro_torch.kernels import harvest_step as PK

EFF, DT = 0.8, 0.01


def _inputs(n, seed=0):
    """(v, p, C, v_max) float64 numpy: heterogeneous capacitors, v from 0
    to past each worker's v_max, power over [0, 1e-2] W."""
    rng = np.random.default_rng(seed)
    C, v_max = hetero_capacitors(n, seed)
    v = rng.uniform(0.0, 4.2, n)
    p = rng.uniform(0.0, 1e-2, n)
    if n > 1:
        v[0] = 0.0  # empty capacitor
        p[1] = 0.0  # no harvest
        v[2] = v_max[2]  # at the ceiling
        v[3] = v_max[3] + 0.1  # past it: saturates back to v_max
    return v, p, C, v_max


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


@pytest.mark.parametrize("n", [1, 1000])
def test_plain_equals_reference_bit_exact(n):
    v, p, C, v_max = _inputs(n)
    want = RE.capacitor_harvest(v, p, DT, capacitance_f=C, booster_eff=EFF,
                                v_max=v_max)
    got = PK.harvest_step_plain(*_t(v, p, C, v_max), eff=EFF, dt=DT)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)
    if n > 1:
        assert want[3] == v_max[3]  # saturation exercised
        assert (want == v_max).sum() >= 2


@pytest.mark.parametrize("n", [1, 1000])
def test_plain_equals_pallas_interpret(n):
    v, p, C, v_max = _inputs(n, seed=3)
    with jax.enable_x64(True):
        want = np.asarray(pallas_harvest(v, p, C, v_max, eff=EFF, dt=DT,
                                         interpret=True))
    assert want.dtype == np.float64
    got = PK.harvest_step_plain(*_t(v, p, C, v_max), eff=EFF, dt=DT)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_sqrt_rn_is_correctly_rounded():
    """The CPU branch of ``sqrt_rn`` is IEEE round-to-nearest (what the
    reference's numpy and CUDA's double sqrt compute)."""
    x = np.random.default_rng(1).uniform(0.0, 20.0, 20000)
    got = PE.sqrt_rn(torch.as_tensor(x)).numpy()
    assert np.array_equal(got, np.array([math.sqrt(a) for a in x]))


def test_capacitor_helpers_equal_reference():
    v, p, C, _ = _inputs(1000, seed=5)
    amount = np.random.default_rng(5).uniform(0.0, 2e-3, 1000)
    for v_off in (1.8, 2.0):
        want = RE.capacitor_usable_energy(v, capacitance_f=C, v_off=v_off)
        got = PE.capacitor_usable_energy(torch.as_tensor(v),
                                         capacitance_f=torch.as_tensor(C),
                                         v_off=v_off)
        assert np.array_equal(got.numpy(), want)
        want_v, want_ok = RE.capacitor_draw(v, amount, capacitance_f=C,
                                            v_off=v_off)
        got_v, got_ok = PE.capacitor_draw(*_t(v, amount),
                                          capacitance_f=torch.as_tensor(C),
                                          v_off=v_off)
        assert np.array_equal(got_v.numpy(), want_v)
        assert np.array_equal(got_ok.numpy(), want_ok)
        assert 0 < want_ok.sum() < want_ok.size  # both outcomes


def test_wrapper_runs_plain_for_cpu_tensors_without_launch():
    v, p, C, v_max = _t(*_inputs(1000))
    launches = PK.harvest_step.launches
    got = PK.harvest_step(v, p, C, v_max, eff=EFF, dt=DT)
    assert PK.harvest_step.launches == launches
    want = PK.harvest_step_plain(v, p, C, v_max, eff=EFF, dt=DT)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "length", "stride",
                                 "device", "empty"])
def test_wrapper_rejects_bad_inputs(bad):
    v, p, C, v_max = _t(*_inputs(8))
    if bad == "dtype":
        p = p.to(torch.float32)
    elif bad == "shape":
        C = C[:, None]
    elif bad == "length":
        v_max = v_max[:7]
    elif bad == "stride":
        v = torch.stack([v, v], 1)[:, 0]
    elif bad == "device":
        v_max = v_max.to("meta")
    else:
        v, p, C, v_max = (x[:0] for x in (v, p, C, v_max))
    launches = PK.harvest_step.launches
    with pytest.raises(ValueError, match="harvest_step"):
        PK.harvest_step(v, p, C, v_max, eff=EFF, dt=DT)
    assert PK.harvest_step.launches == launches
