"""The float64 harvest stage of the fleet tick as one CUDA kernel launch.

Replaces the Pallas TPU kernel ``repro/kernels/fleet_step.py:harvest_step``:
charge N capacitors by one trace tick, ``v' = min(sqrt(2 e / C), v_max)``
with ``e = 0.5 C v^2 + eff p dt``. The kernel (``csrc/harvest_step.cu``)
runs one thread per worker with every operation rounded on its own, so it
is bit-equal to its plain version, :func:`harvest_step_plain` (the torch
expression of ``core.energy.capacitor_harvest``). :func:`harvest_step`
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.energy import capacitor_harvest


def harvest_step_plain(v: torch.Tensor, power_w: torch.Tensor,
                       capacitance_f: torch.Tensor, v_max: torch.Tensor, *,
                       eff: float, dt: float) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the (N,) new voltages."""
    return capacitor_harvest(v, power_w, dt, capacitance_f=capacitance_f,
                             booster_eff=eff, v_max=v_max)


def _check(v, power_w, capacitance_f, v_max) -> int:
    n = v.shape[0] if isinstance(v, torch.Tensor) and v.dim() == 1 else -1
    for name, t in (("v", v), ("power_w", power_w),
                    ("capacitance_f", capacitance_f), ("v_max", v_max)):
        if (not isinstance(t, torch.Tensor) or n < 1
                or t.dtype != torch.float64 or tuple(t.shape) != (n,)
                or t.device != v.device or not t.is_contiguous()):
            raise ValueError(
                f"harvest_step: {name} must be a contiguous (N,) float64 "
                f"tensor on the device of v, N >= 1; got "
                f"{getattr(t, 'dtype', type(t))} "
                f"{tuple(getattr(t, 'shape', ()))} on "
                f"{getattr(t, 'device', None)} (v: "
                f"{tuple(getattr(v, 'shape', ()))} on "
                f"{getattr(v, 'device', None)})")
    return n


@functools.cache
def _library():
    from repro_torch.kernels import build
    fn = build.load("harvest_step").harvest_step_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_double, ctypes.c_double,
                                           ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_args(v: torch.Tensor, power_w: torch.Tensor,
                capacitance_f: torch.Tensor, v_max: torch.Tensor, *,
                eff: float, dt: float):
    """Check the CUDA inputs and allocate the output of one launch.
    Returns ``(launch, args, out)``: ``launch(*args)`` enqueues the kernel
    on the current stream and returns its ``cudaError_t``."""
    n = _check(v, power_w, capacitance_f, v_max)
    if v.device.type != "cuda":
        raise ValueError(f"harvest_step: the CUDA kernel needs CUDA "
                         f"tensors, got {v.device}")
    out = torch.empty_like(v)
    args = (v.data_ptr(), power_w.data_ptr(), capacitance_f.data_ptr(),
            v_max.data_ptr(), out.data_ptr(), float(eff), float(dt), n,
            torch.cuda.current_stream(v.device).cuda_stream)
    return _library(), args, out


def harvest_step(v: torch.Tensor, power_w: torch.Tensor,
                 capacitance_f: torch.Tensor, v_max: torch.Tensor, *,
                 eff: float, dt: float) -> torch.Tensor:
    """One harvest tick for N capacitors; all tensor arguments are
    contiguous (N,) float64 on one device. Returns the new (N,) voltages
    in a fresh tensor (the inputs are not modified).

    CUDA tensors launch the kernel on the current stream (no
    synchronisation; a refused launch raises); CPU tensors run
    :func:`harvest_step_plain`. ``harvest_step.launches`` counts
    launches."""
    if isinstance(v, torch.Tensor) and v.device.type == "cpu":
        _check(v, power_w, capacitance_f, v_max)
        return harvest_step_plain(v, power_w, capacitance_f, v_max,
                                  eff=eff, dt=dt)
    launch, args, out = launch_args(v, power_w, capacitance_f, v_max,
                                    eff=eff, dt=dt)
    err = launch(*args)
    if err != 0:
        raise RuntimeError(f"harvest_step launch failed: cudaError_t {err}")
    harvest_step.launches += 1
    return out


harvest_step.launches = 0
