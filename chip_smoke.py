#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc. It
builds every kernel of the serve path from ``src/repro_torch/csrc`` with
nvcc for ``sm_90a``, then:

1. prints the card (name, power limit) and the torch / CUDA / nvcc versions;
2. builds the kernels, one nvcc per source, all started together, and
   prints what ptxas reports (registers, spills);
3. holds each kernel against its plain PyTorch version on the card:
   ``serve_tick`` on fuzzed states piled near the E_ON / E_OFF thresholds at
   N in {1, 300, 131072} over several ticks; every read-write field, the
   four event lanes and the eight ledger totals must be bit-exact;
4. serves the main path at full width through the port's entry points
   (``build_scheduled`` and ``run_fleet``, the two calls ``run_scheduled``
   makes, so the final states stay readable): 131072 workers x
   3000 ticks (30 s at dt 0.01) of RF/SOM/SIM/SOR/SIR harvest over 32
   trace rows, har/harris/lm at mix 0.4/0.3/0.3, workers/10 requests per
   second, batches of 4, dispatch every 10 ticks, reactive routing, seed 0
   -- once with ``kernel="cuda"`` (launch counts reset just before, read
   just after: every kernel of the path must have launched) and once with
   the plain ``kernel="q32"``; every counter, per-workload record and the
   final device and scheduler states must agree;
5. times the warm serve and one kernel launch (CUDA events over 200
   launches) beside its plain version and its bound.

It prints the kernels' record as one JSON line before the last line, and
as the last line ``{"ok": true, "device": {...}}``. Any failing phase
raises and exits non-zero; without a CUDA device it exits 1 and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12

N_FULL = 131072
DT = 0.01
DURATION_S = 30.0
TRACES = ["RF", "SOM", "SIM", "SOR", "SIR"]
TRACE_ROWS = 32
WORKLOADS = ("har", "harris", "lm")
MIX = np.array([0.4, 0.3, 0.3])
MAX_BATCH = 4
DISPATCH_EVERY = 10
SEED = 0
COUNT_KEYS = ("submitted", "completed", "rejected", "shed", "lost",
              "evicted", "requeued")
# float64 sums (latency, expected accuracy) are the only values allowed to
# differ, by rel 1e-12: the card does not promise one reduction order
FLOAT_SUM_KEYS = ("latency_mean_s", "mean_expected_accuracy",
                  "proxy_minus_measured")
FLOAT_SUM_FIELDS = ("acc_wl", "lat_sum")
RTOL = 1e-12


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fuzz_state(fs, qp_host, rng, n):
    """States piled near the thresholds (tests/test_quant_kernel.py's
    recipe), written into the device state ``fs``."""
    W = qp_host.FIXQ.shape[0]
    e_max = np.asarray(qp_host.E_MAX)
    v = rng.integers(0, e_max + 1, n).astype(np.int32)
    near = rng.random(n) < 0.5
    base = np.where(rng.random(n) < 0.5, qp_host.E_ON, qp_host.E_OFF)
    v = np.where(near, (base + rng.integers(-2, 3, n)).clip(0), v)
    on = rng.random(n) < 0.7
    has_work = on & (rng.random(n) < 0.5)
    w_tile = rng.integers(0, 4, n)
    w_batch = rng.integers(1, 4, n)
    vals = dict(
        v=v, on=on, has_work=has_work,
        w_wl=rng.integers(0, W, n), w_tile=w_tile, w_batch=w_batch,
        w_target=w_tile * w_batch, w_units_done=rng.integers(0, 5, n),
        w_left=rng.integers(0, 30000, n), w_ticket=rng.integers(0, 100, n),
        p_pending=(~has_work) & (rng.random(n) < 0.6),
        p_wl=rng.integers(0, W, n), p_units=rng.integers(0, 4, n),
        p_batch=rng.integers(1, 4, n), p_ticket=rng.integers(100, 200, n))
    for f, x in vals.items():
        t = getattr(fs, f)
        t.copy_(torch.as_tensor(np.asarray(x).astype(
            np.bool_ if t.dtype == torch.bool else np.int32)))
    return fs


def copy_state(fs):
    return dataclasses.replace(fs, **{
        f.name: getattr(fs, f.name).clone() for f in dataclasses.fields(fs)})


def max_abs_diff(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def build_fleet(n, kernel, duration_s, power=None):
    """The fleet ``run_scheduled`` serves, through the launcher's own
    ``build_scheduled``: (pool, scheduler, stream, n_steps)."""
    from repro_torch.launch import fleet as L
    if power is None:
        power = L.make_power_matrix(TRACES, min(TRACE_ROWS, n), duration_s,
                                    DT, SEED)
    n_steps = int(round(duration_s / DT))
    pool, sched, stream = L.build_scheduled(
        power, DT, n, [L.WORKLOAD_FACTORIES[k]() for k in WORKLOADS],
        rate_rps=n / 10.0, mix=MIX, n_steps=n_steps, seed=SEED,
        max_batch=MAX_BATCH, kernel=kernel, device="cuda")
    return pool, sched, stream, n_steps


def phase_kernel_vs_plain(sizes=(1, 300, N_FULL), ticks=4) -> int:
    """serve_tick (CUDA) vs serve_tick_plain on the card; returns the
    largest absolute difference seen (must be 0)."""
    from repro_torch.fleet import qtick as Q
    from repro_torch.kernels.serve_tick import serve_tick, serve_tick_plain
    worst = 0
    for n in sizes:
        pool, _, _, _ = build_fleet(n, "cuda", 10.0)
        p = pool.params
        qp_host = Q.quantize_fleet(p)
        qp = Q.to_device(qp_host, "cuda")
        ti = torch.as_tensor(p.trace_index, device="cuda")
        ph = torch.as_tensor(p.phase, device="cuda")
        rng = np.random.default_rng(n)
        events = {Q.EV_EMIT: 0, Q.EV_LOST: 0}
        for trial in range(3):
            k_fs = fuzz_state(copy_state(pool.state), qp_host, rng, n)
            p_fs = copy_state(k_fs)
            i0 = int(rng.integers(0, 900))
            for i in range(i0, i0 + ticks):
                qh = Q.harvest_row(p, qp, ti, ph, i)
                k_ev, k_led = serve_tick(k_fs, qp, qh, i)
                p_ev, p_led = serve_tick_plain(p_fs, qp, qh, i)
                torch.cuda.synchronize()
                for f in Q.RW_FIELDS:
                    d = max_abs_diff(getattr(k_fs, f), getattr(p_fs, f))
                    worst = max(worst, d)
                    if d:
                        raise AssertionError(
                            f"serve_tick N={n} tick {i}: field {f} differs "
                            f"by up to {d}")
                for lane, (a, b) in enumerate(zip(k_ev, p_ev)):
                    d = max_abs_diff(a, b)
                    worst = max(worst, d)
                    if d:
                        raise AssertionError(
                            f"serve_tick N={n} tick {i}: event lane {lane}")
                d = max_abs_diff(k_led, p_led)
                worst = max(worst, d)
                if d:
                    raise AssertionError(
                        f"serve_tick N={n} tick {i}: ledger "
                        f"{k_led.tolist()} vs {p_led.tolist()}")
                for code in events:
                    events[code] += int((p_ev[0] == code).sum())
        log(f"  serve_tick == plain at N={n}: {3 * ticks} ticks, "
            f"emits {events[Q.EV_EMIT]}, losses {events[Q.EV_LOST]}")
        if n >= 300 and not all(events.values()):
            raise AssertionError("fuzz reached no emission or no loss")
    return worst


def summaries_agree(ref: dict, got: dict, key: str = "") -> None:
    if isinstance(ref, dict):
        if set(ref) != set(got):
            raise AssertionError(f"summary keys differ under {key!r}")
        for k in ref:
            summaries_agree(ref[k], got[k], k)
    elif key in FLOAT_SUM_KEYS:
        if abs(got - ref) > RTOL * max(abs(ref), 1e-300):
            raise AssertionError(f"{key}: {got} vs {ref}")
    elif got != ref:
        raise AssertionError(f"{key}: {got} vs {ref}")


def states_agree(a_pool, a_sched, b_pool, b_sched) -> None:
    from repro_torch.fleet.state import to_numpy
    fa, sa = to_numpy(a_pool.state, a_sched.state)
    fb, sb = to_numpy(b_pool.state, b_sched.state)
    for f in dataclasses.fields(fa):
        if not np.array_equal(getattr(fa, f.name), getattr(fb, f.name)):
            raise AssertionError(f"final FleetState.{f.name} differs")
    for f in dataclasses.fields(sa):
        x, y = getattr(sa, f.name), getattr(sb, f.name)
        if f.name in FLOAT_SUM_FIELDS:
            ok = np.allclose(x, y, rtol=RTOL, atol=0)
        else:
            ok = np.array_equal(x, y)
        if not ok:
            raise AssertionError(f"final SchedState.{f.name} differs")


def serve(kernel, power):
    from repro_torch.fleet.scheduler import run_fleet
    pool, sched, stream, n_steps = build_fleet(N_FULL, kernel, DURATION_S,
                                               power)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = run_fleet(pool, sched, stream, n_steps,
                        dispatch_every=DISPATCH_EVERY)
    torch.cuda.synchronize()
    return summary, pool, sched, time.perf_counter() - t0, n_steps


def time_kernel(pool, reps=200):
    """Mean device time of one serve_tick launch and of one call of its
    plain version, on a copy of the served state. Each call is timed by
    its own pair of CUDA events with the 50 MB L2 flushed before it, as
    the serve loop's control plane leaves it between ticks. Returns
    ``(ms, plain_ms, bytes, bound_ms)``."""
    from repro_torch.fleet import qtick as Q
    from repro_torch.kernels.serve_tick import (CONST_FIELDS, TABLE_FIELDS,
                                                launch_args,
                                                serve_tick_plain)
    p = pool.params
    qp = Q.to_device(Q.quantize_fleet(p), "cuda")
    ti = torch.as_tensor(p.trace_index, device="cuda")
    ph = torch.as_tensor(p.phase, device="cuda")
    i0 = pool.steps_done
    qhs = [Q.harvest_row(p, qp, ti, ph, i0 + k) for k in range(reps)]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timed(call, count):
        pairs = []
        for k in range(count):
            flush.zero_()
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            call(k)
            pair[1].record()
            pairs.append(pair)
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / count

    fs = copy_state(pool.state)
    prepared = [launch_args(fs, qp, qhs[k], i0 + k) for k in range(reps)]

    def kernel(k):
        launch, args, _, _ = prepared[k]
        err = launch(*args)
        if err != 0:
            raise RuntimeError(f"serve_tick launch failed: {err}")

    timed(kernel, 3)  # warm
    ms = timed(kernel, reps)
    fs_plain = copy_state(pool.state)
    plain_ms = timed(
        lambda k: serve_tick_plain(fs_plain, qp, qhs[k], i0 + k), 20)
    n = p.n
    # each input read once, each output written once
    moved = sum(2 * getattr(fs, f).element_size() * n for f in Q.RW_FIELDS)
    moved += sum(getattr(fs, f).element_size() * n for f in Q.RO_FIELDS)
    moved += 4 * n  # qh
    moved += sum(getattr(qp, f).numel() * 4 for f in CONST_FIELDS)
    moved += sum(getattr(qp, f).numel() * 4 for f in TABLE_FIELDS)
    moved += 4 * 4 * n + 8 * 4  # event lanes + ledger
    return ms, plain_ms, moved, moved / HBM_BYTES_PER_S * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import KERNELS, build
    from repro_torch.kernels.serve_tick import serve_tick

    # 1. the card
    card = card_line()
    log(card)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{nvcc[-1]}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")

    # 2. build every kernel from the sources in the checkout
    t0 = time.perf_counter()
    logs = build.build(tuple(KERNELS))
    log(f"built {sorted(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "spill" in line):
                log(f"  {name}: {line.strip()}")

    # 3. each kernel against its plain version on the card
    err = phase_kernel_vs_plain()
    log(f"kernel vs plain: max abs err {err}")

    # 4. the main path at full width
    from repro_torch.launch import fleet as L
    power = L.make_power_matrix(TRACES, TRACE_ROWS, DURATION_S, DT, SEED)
    warm_pool, warm_sched, warm_stream, _ = build_fleet(N_FULL, "cuda", 1.0)
    from repro_torch.fleet.scheduler import run_fleet
    run_fleet(warm_pool, warm_sched, warm_stream, 100,
              dispatch_every=DISPATCH_EVERY)  # warm-up: allocator, library
    torch.cuda.synchronize()
    serve_tick.launches = 0
    got, pool, sched, wall, n_steps = serve("cuda", power)
    launches = serve_tick.launches
    if launches != n_steps:
        raise AssertionError(f"serve_tick launched {launches} times in "
                             f"{n_steps} ticks")
    log(f"serve cuda: {N_FULL} workers x {n_steps} ticks in {wall:.3f} s "
        f"warm = {N_FULL * n_steps / wall:.4g} worker-ticks/s [{card}]")
    log("  counters: " + json.dumps({k: got[k] for k in COUNT_KEYS}))
    log("  per_workload completed: " + json.dumps(
        {k: v["completed"] for k, v in got["per_workload"].items()}))
    if got["completed"] <= 0 or not got["energy"]["conservation_ok"]:
        raise AssertionError("serve completed nothing or broke energy "
                             "conservation")
    ref, ref_pool, ref_sched, ref_wall, _ = serve("q32", power)
    log(f"serve q32 (plain): {ref_wall:.3f} s [{card}]")
    summaries_agree(ref, got)
    states_agree(ref_pool, ref_sched, pool, sched)
    log("serve cuda == serve q32: every counter, per-workload record and "
        "final state")

    # 5. one launch at full width beside its plain version and bound
    ms, plain_ms, moved, bound_ms = time_kernel(pool)
    log(f"serve_tick at N={N_FULL}: {ms:.5f} ms/launch (plain "
        f"{plain_ms:.4f} ms), bound {bound_ms:.5f} ms = {moved} B / 3.35 "
        f"TB/s [{card}]")
    record = {"kernels": [{
        "name": "serve_tick", "route": "cuda",
        "source": "src/repro_torch/csrc/serve_tick.cu",
        "replaces": "src/repro/kernels/serve_tick.py:285",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
