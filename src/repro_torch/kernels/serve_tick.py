"""The quantized serve tick as one CUDA kernel launch per tick.

Replaces the Pallas TPU kernel ``repro/kernels/serve_tick.py:serve_tick``
(the whole int32 dispatch tick of ``repro.fleet.qtick``, per worker). The
kernel (``csrc/serve_tick.cu``) runs one thread per worker and updates the
19 read-write state fields of a :class:`FleetState` in place; its plain
version, :func:`serve_tick_plain`, runs ``repro_torch.fleet.qtick.tick_q``.
:func:`serve_tick` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other.

Ledger totals wrap mod 2**32 like the reference's int32 sums (``torch.sum``
would widen int32 to int64, so the plain version wraps explicitly).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.fleet.qtick import (BOOL_FIELDS, EV_LOST, RO_FIELDS,
                                     RW_FIELDS, QuantParams, tick_q)
from repro_torch.fleet.state import FleetState

# ledger lanes of the (8,) int32 total
LEDGER_SLOTS = ("n_emit", "n_lost", "units_emitted", "n_wake",
                "n_acquired", "qh_quanta", "e_work_quanta", "reserved")

# per-worker thresholds and the workload tables the kernel reads
CONST_FIELDS = ("E_ON", "E_OFF", "E_MAX", "ESTEP")
TABLE_FIELDS = ("UCQ", "FIXQ", "EMITCQ")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Sum of an integer tensor wrapped to int32 (mod 2**32)."""
    total = x.to(torch.int64).sum()
    return ((total + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def serve_tick_plain(fs: FleetState, qp: QuantParams, qh: torch.Tensor,
                     i: int):
    """The plain PyTorch version of the kernel, same contract as
    :func:`serve_tick`: updates ``fs`` in place, returns ``(ev, ledger)``."""
    before = {f: getattr(fs, f) for f in
              ("cycles", "acquired", "e_work", "emit_count",
               "emit_units_sum")}
    rw, ev = tick_q(qp, fs, qh, i)
    lanes = dict(
        n_emit=rw["emit_count"] - before["emit_count"],
        n_lost=ev[0] == EV_LOST,
        units_emitted=rw["emit_units_sum"] - before["emit_units_sum"],
        n_wake=rw["cycles"] - before["cycles"],
        n_acquired=rw["acquired"] - before["acquired"],
        qh_quanta=qh,
        e_work_quanta=rw["e_work"] - before["e_work"],
        reserved=torch.zeros(1, dtype=torch.int32, device=qh.device))
    ledger = torch.stack([_wrap32(lanes[k]) for k in LEDGER_SLOTS])
    for f in RW_FIELDS:
        getattr(fs, f).copy_(rw[f])
    return ev, ledger


def _check(fs: FleetState, qp: QuantParams, qh: torch.Tensor):
    dev = qh.device
    n = qh.shape[0]
    if qh.dim() != 1 or n < 1:
        raise ValueError(f"qh must be (N,) with N >= 1, got {tuple(qh.shape)}")
    per_worker = [(f, getattr(fs, f)) for f in RW_FIELDS + RO_FIELDS]
    per_worker += [(f, getattr(qp, f)) for f in CONST_FIELDS]
    per_worker.append(("qh", qh))
    for f, t in per_worker:
        want = torch.bool if f in BOOL_FIELDS else torch.int32
        if (not isinstance(t, torch.Tensor) or t.device != dev
                or t.dtype != want or tuple(t.shape) != (n,)
                or not t.is_contiguous()):
            raise ValueError(
                f"serve_tick: {f} must be a contiguous ({n},) {want} tensor "
                f"on {dev}, got {getattr(t, 'dtype', type(t))} "
                f"{tuple(getattr(t, 'shape', ()))} on "
                f"{getattr(t, 'device', None)}")
    w, u_max = qp.UCQ.shape
    for f, shape in (("UCQ", (w, u_max)), ("FIXQ", (w,)), ("EMITCQ", (w,))):
        t = getattr(qp, f)
        if (t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"serve_tick: {f} must be a contiguous {shape} "
                             f"int32 tensor on {dev}")
    if w < 1 or u_max < 1:
        raise ValueError("serve_tick: empty workload tables")
    return n, w, u_max


@functools.cache
def _library():
    from repro_torch.kernels import build
    fn = build.load("serve_tick").serve_tick_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_args(fs: FleetState, qp: QuantParams, qh: torch.Tensor, i: int):
    """Check the inputs and allocate the outputs of one CUDA launch.
    Returns ``(launch, args, ev, ledger)``: ``launch(*args)`` enqueues the
    kernel on the current stream and returns its ``cudaError_t``; ``args``
    holds the pointer array alive. The kernel allocates nothing."""
    if qh.device.type != "cuda":
        raise ValueError(f"the CUDA serve tick needs CUDA tensors, got "
                         f"{qh.device}")
    if not 0 <= i < 2 ** 31:
        raise ValueError(f"tick index {i} outside int32")
    n, w, u_max = _check(fs, qp, qh)
    dev = qh.device
    ev = tuple(torch.empty(n, dtype=torch.int32, device=dev)
               for _ in range(4))
    ledger = torch.zeros(8, dtype=torch.int32, device=dev)
    tensors = ([getattr(fs, f) for f in RW_FIELDS + RO_FIELDS] + [qh]
               + [getattr(qp, f) for f in CONST_FIELDS + TABLE_FIELDS]
               + list(ev) + [ledger])
    ptrs = (ctypes.c_uint64 * len(tensors))(*[t.data_ptr() for t in tensors])
    args = (ptrs, len(tensors), n, w, u_max, int(i),
            torch.cuda.current_stream(dev).cuda_stream)
    return _library(), args, ev, ledger


def serve_tick(fs: FleetState, qp: QuantParams, qh: torch.Tensor, i: int):
    """One quantized dispatch tick for N workers.

    ``fs`` is the quantized :class:`FleetState` (its ``RW_FIELDS`` are
    updated in place), ``qp`` the device :class:`QuantParams` (per-worker
    ``E_ON``/``E_OFF``/``E_MAX``/``ESTEP``, tables ``UCQ``/``FIXQ``/
    ``EMITCQ``), ``qh`` this tick's (N,) int32 harvest quanta and ``i`` the
    tick index. Returns ``(ev, ledger)``: the 4 int32 (N,) event lanes
    (code / tick / ticket / units, first event wins) and the (8,) int32
    ``LEDGER_SLOTS`` totals.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation; a refused launch raises); CPU tensors run
    :func:`serve_tick_plain`. ``serve_tick.launches`` counts launches."""
    if qh.device.type == "cpu":
        return serve_tick_plain(fs, qp, qh, i)
    launch, args, ev, ledger = launch_args(fs, qp, qh, i)
    err = launch(*args)
    if err != 0:
        raise RuntimeError(f"serve_tick launch failed: cudaError_t {err}")
    serve_tick.launches += 1
    return ev, ledger


serve_tick.launches = 0
