#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc. It
builds every kernel of the port from ``src/repro_torch/csrc`` with nvcc
for ``sm_90a``, then:

1. prints the card (name, power limit) and the torch / CUDA / nvcc versions;
2. builds the kernels, one nvcc per source, all started together, and
   prints what ptxas reports (registers, spills);
3. holds each kernel against its plain PyTorch version on the card:
   ``serve_tick`` on fuzzed states piled near the E_ON / E_OFF thresholds at
   N in {1, 300, 131072} over several ticks (every read-write field, the
   four event lanes and the eight ledger totals bit-exact), and
   ``harvest_step`` at N in {1, 1000, 131072} on heterogeneous capacitors
   with voltages from 0 to past v_max and power over [0, 1e-2] W (bit-exact:
   max abs err 0; the worst ulp distance is printed);
4. serves slice 1's main path at full width through the port's entry points
   (``build_scheduled`` and ``run_fleet``, the two calls ``run_scheduled``
   makes, so the final states stay readable): 131072 workers x
   3000 ticks (30 s at dt 0.01) of RF/SOM/SIM/SOR/SIR harvest over 32
   trace rows, har/harris/lm at mix 0.4/0.3/0.3, workers/10 requests per
   second, batches of 4, dispatch every 10 ticks, reactive routing, seed 0
   -- once with ``kernel="cuda"`` (launch counts reset just before, read
   just after: every kernel of the path must have launched) and once with
   the plain ``kernel="q32"``; every counter, per-workload record and the
   final device and scheduler states must agree;
5. serves slice 2's main path, the same fleet with ``kernel="f64"`` (the
   float64 tick, its harvest stage the ``harvest_step`` kernel): counts
   reset just before, ``harvest_step`` must launch once per tick; then the
   independent-workers baseline (``run_independent``, one local-mode
   float64 pool per workload) at the same width, ``harvest_step`` once per
   tick per pool, and prints ``speedup_completed``;
6. runs the float64 serve and the baseline at 1024 workers x 2000 ticks on
   the card and on the CPU: every counter, per-workload record and final
   state field must be equal (float64 sums of latency and expected
   accuracy within rel 1e-12, as in step 4);
7. times the warm serves and one launch of each kernel (CUDA events, L2
   flushed before each of 200 launches) beside its plain version and its
   bound.

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

# published H100 SXM rates (NVIDIA data sheet): device memory, bytes/s,
# and float64 outside the tensor cores, operations/s
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

N_FULL = 131072
DT = 0.01
DURATION_S = 30.0
N_SMALL, SMALL_TICKS = 1024, 2000  # the card-vs-CPU comparison
PERIOD_S = 10.0  # independent workers' sampling period (workers/10 rps)
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


def ulp_distance(a, b) -> int:
    """Largest distance in float64 ulps between two tensors of values of
    one sign (the bit patterns as integers)."""
    a = a.to(torch.float64).contiguous().view(torch.int64)
    b = b.to(torch.float64).contiguous().view(torch.int64)
    return int((a - b).abs().max()) if a.numel() else 0


def reset_launches():
    from repro_torch.kernels.harvest_step import harvest_step
    from repro_torch.kernels.serve_tick import serve_tick
    serve_tick.launches = 0
    harvest_step.launches = 0


def build_fleet(n, kernel, duration_s, power=None, device="cuda"):
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
        max_batch=MAX_BATCH, kernel=kernel, device=device)
    return pool, sched, stream, n_steps


def independent(n, power, n_steps, device="cuda"):
    """The independent-workers baseline through ``run_independent``."""
    from repro_torch.launch import fleet as L
    return L.run_independent(
        power, DT, n, [L.WORKLOAD_FACTORIES[k]() for k in WORKLOADS],
        mix=MIX, period_s=PERIOD_S, n_steps=n_steps, seed=SEED,
        device=device)


def harvest_inputs(n, seed):
    """(v, p, C, v_max) on the card: heterogeneous capacitors, v from 0 to
    past each worker's v_max, power over [0, 1e-2] W."""
    from repro_torch.launch import fleet as L
    rng = np.random.default_rng(seed)
    C, v_max = L.hetero_capacitors(n, seed)
    v = rng.uniform(0.0, 4.2, n)
    p = rng.uniform(0.0, 1e-2, n)
    v[:: 7] = 0.0
    p[1:: 11] = 0.0
    v[2:: 13] = v_max[2:: 13] + 0.1
    return tuple(torch.as_tensor(x, device="cuda") for x in (v, p, C, v_max))


def phase_harvest_vs_plain(sizes=(1, 1000, N_FULL)) -> tuple[float, int]:
    """harvest_step (CUDA) vs harvest_step_plain on the card, and vs the
    plain version on the CPU; returns (max abs err, worst ulp distance),
    both required 0."""
    from repro_torch.kernels.harvest_step import (harvest_step,
                                                  harvest_step_plain)
    err, ulps = 0.0, 0
    for n in sizes:
        args = harvest_inputs(n, seed=n)
        kw = dict(eff=0.8, dt=DT)
        got = harvest_step(*args, **kw)
        want = harvest_step_plain(*args, **kw)
        cpu = harvest_step_plain(*(a.cpu() for a in args), **kw)
        torch.cuda.synchronize()
        d = max(float((got - want).abs().max()),
                float((got.cpu() - cpu).abs().max()))
        u = max(ulp_distance(got, want), ulp_distance(got.cpu(), cpu))
        saturated = int((got == args[3]).sum())
        log(f"  harvest_step == plain at N={n}: max abs err {d}, worst "
            f"{u} ulp, {saturated} saturated at v_max")
        err, ulps = max(err, d), max(ulps, u)
        if d or u:
            raise AssertionError(f"harvest_step N={n}: max abs err {d}, "
                                 f"{u} ulp")
    return err, ulps


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
        x, y = getattr(fa, f.name), getattr(fb, f.name)
        if not np.array_equal(x, y):
            if x.dtype == np.float64 == y.dtype:
                log(f"  FleetState.{f.name}: worst "
                    f"{ulp_distance(torch.as_tensor(x), torch.as_tensor(y))}"
                    " ulp")
            raise AssertionError(f"final FleetState.{f.name} differs")
    for f in dataclasses.fields(sa):
        x, y = getattr(sa, f.name), getattr(sb, f.name)
        if f.name in FLOAT_SUM_FIELDS:
            ok = np.allclose(x, y, rtol=RTOL, atol=0)
        else:
            ok = np.array_equal(x, y)
        if not ok:
            raise AssertionError(f"final SchedState.{f.name} differs")


def serve(kernel, power, n=N_FULL, duration_s=DURATION_S, device="cuda"):
    from repro_torch.fleet.scheduler import run_fleet
    pool, sched, stream, n_steps = build_fleet(n, kernel, duration_s,
                                               power, device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = run_fleet(pool, sched, stream, n_steps,
                        dispatch_every=DISPATCH_EVERY)
    if device == "cuda":
        torch.cuda.synchronize()
    return summary, pool, sched, time.perf_counter() - t0, n_steps


def warm(kernel):
    """A short serve that loads the kernel's library and warms the
    allocator before a timed serve."""
    from repro_torch.fleet.scheduler import run_fleet
    pool, sched, stream, _ = build_fleet(N_FULL, kernel, 1.0)
    run_fleet(pool, sched, stream, 100, dispatch_every=DISPATCH_EVERY)
    torch.cuda.synchronize()


def phase_card_vs_cpu() -> None:
    """The float64 serve and the baseline at N_SMALL x SMALL_TICKS, once
    on the card and once on the CPU: equal on every counter, record and
    final state field."""
    from repro_torch.launch import fleet as L
    duration = SMALL_TICKS * DT
    power = L.make_power_matrix(TRACES, TRACE_ROWS, duration, DT, SEED)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small tensors: one thread is fastest
    try:
        walls = {}
        runs = {}
        for device in ("cuda", "cpu"):
            runs[device] = serve("f64", power, N_SMALL, duration, device)
            t0 = time.perf_counter()
            runs[device] += (independent(N_SMALL, power, SMALL_TICKS,
                                         device),)
            walls[device] = (runs[device][3], time.perf_counter() - t0)
    finally:
        torch.set_num_threads(threads)
    (g, g_pool, g_sched, _, _, g_ind) = runs["cuda"]
    (c, c_pool, c_sched, _, _, c_ind) = runs["cpu"]
    summaries_agree(c, g)
    states_agree(c_pool, c_sched, g_pool, g_sched)
    summaries_agree(c_ind, g_ind)
    if g["completed"] <= 0 or g_ind["completed"] <= 0:
        raise AssertionError("the small runs completed nothing")
    log(f"f64 card == CPU at {N_SMALL} workers x {SMALL_TICKS} ticks: "
        f"scheduled completed {g['completed']}, independent completed "
        f"{g_ind['completed']}; every counter, record and final state field "
        f"equal, voltages bit-equal (serve / baseline wall s: card "
        f"{walls['cuda'][0]:.3f} / {walls['cuda'][1]:.3f}, CPU "
        f"{walls['cpu'][0]:.3f} / {walls['cpu'][1]:.3f})")


def time_harvest(pool, reps=200):
    """Mean device time of one harvest_step launch at the served fleet's
    width (its final voltages, the next tick's power row) and of one call
    of its plain version; CUDA events around each call with the 50 MB L2
    flushed before it. Returns ``(ms, plain_ms, bytes, ops, bound_ms,
    bound_by)``."""
    from repro_torch.kernels.harvest_step import (harvest_step_plain,
                                                  launch_args)
    be = pool._torch
    p = pool.params
    v = pool.state.v
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    pws = [be.power[be.trace_index, (be.phase + pool.steps_done + k) % p.T]
           for k in range(reps)]
    prepared = [launch_args(v, pws[k], be.C, be.v_max, eff=p.eff, dt=p.dt)
                for k in range(reps)]

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

    def kernel(k):
        launch, args, _ = prepared[k]
        err = launch(*args)
        if err != 0:
            raise RuntimeError(f"harvest_step launch failed: {err}")

    timed(kernel, 3)  # warm
    ms = timed(kernel, reps)
    plain_ms = timed(lambda k: harvest_step_plain(
        v, pws[k], be.C, be.v_max, eff=p.eff, dt=p.dt), 20)
    n = p.n
    moved = 5 * 8 * n  # v, p, C, v_max read once; v' written once
    ops = 10 * n  # 6 mul, 1 add, 1 div, 1 sqrt, 1 min per worker
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP64_OPS_PER_S * 1e3
    return (ms, plain_ms, moved, ops, max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


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
    t_start = time.perf_counter()
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
    log(f"serve_tick vs plain: max abs err {err}")
    h_err, h_ulps = phase_harvest_vs_plain()
    log(f"harvest_step vs plain: max abs err {h_err}, worst {h_ulps} ulp")

    # 4. slice 1's main path at full width (the int32 serve-tick kernel)
    from repro_torch.kernels.harvest_step import harvest_step
    from repro_torch.launch import fleet as L
    power = L.make_power_matrix(TRACES, TRACE_ROWS, DURATION_S, DT, SEED)
    warm("cuda")  # allocator, library
    reset_launches()
    got, pool, sched, wall, n_steps = serve("cuda", power)
    launches = serve_tick.launches
    if launches != n_steps or harvest_step.launches != 0:
        raise AssertionError(f"serve_tick launched {launches} times in "
                             f"{n_steps} ticks (harvest_step "
                             f"{harvest_step.launches})")
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
    del ref_pool, ref_sched

    # 5. slice 2's main path at full width (the float64 tick, its harvest
    # stage the harvest_step kernel), then the independent baseline
    warm("f64")
    reset_launches()
    f64, f_pool, _, f_wall, _ = serve("f64", power)
    h_launches = harvest_step.launches
    if h_launches != n_steps or serve_tick.launches != 0:
        raise AssertionError(f"harvest_step launched {h_launches} times in "
                             f"{n_steps} ticks (serve_tick "
                             f"{serve_tick.launches})")
    syncs = f_pool._torch.host_syncs / n_steps
    log(f"serve f64: {N_FULL} workers x {n_steps} ticks in {f_wall:.3f} s "
        f"warm = {N_FULL * n_steps / f_wall:.4g} worker-ticks/s, "
        f"{syncs:.3f} host syncs/tick [{card}]")
    log("  counters: " + json.dumps({k: f64[k] for k in COUNT_KEYS}))
    log("  per_workload completed: " + json.dumps(
        {k: v["completed"] for k, v in f64["per_workload"].items()}))
    if f64["completed"] <= 0 or not f64["energy"]["conservation_ok"]:
        raise AssertionError("f64 serve completed nothing or broke energy "
                             "conservation")
    reset_launches()
    t0 = time.perf_counter()
    ind = independent(N_FULL, power, n_steps)
    torch.cuda.synchronize()
    i_wall = time.perf_counter() - t0
    pools = len(ind["per_workload"])
    i_launches = harvest_step.launches
    if i_launches != n_steps * pools or ind["completed"] <= 0:
        raise AssertionError(f"independent: harvest_step launched "
                             f"{i_launches} times for {pools} pools x "
                             f"{n_steps} ticks, completed "
                             f"{ind['completed']}")
    speedup = f64["completed"] / max(ind["completed"], 1)
    log(f"independent f64: {N_FULL} workers in {pools} pools x {n_steps} "
        f"ticks in {i_wall:.3f} s, completed {ind['completed']}, skipped "
        f"{ind['skipped']}; speedup_completed (scheduled f64 / independent) "
        f"{speedup:.6f} [{card}]")

    # 6. the float64 path on the card equals the CPU
    phase_card_vs_cpu()

    # 7. one launch of each kernel at full width beside its plain version
    # and its bound
    ms, plain_ms, moved, bound_ms = time_kernel(pool)
    log(f"serve_tick at N={N_FULL}: {ms:.5f} ms/launch (plain "
        f"{plain_ms:.4f} ms), bound {bound_ms:.5f} ms = {moved} B / 3.35 "
        f"TB/s [{card}]")
    h_ms, h_plain_ms, h_moved, h_ops, h_bound_ms, h_by = time_harvest(f_pool)
    log(f"harvest_step at N={N_FULL}: {h_ms:.5f} ms/launch (plain "
        f"{h_plain_ms:.5f} ms), bound {h_bound_ms:.6f} ms by {h_by} "
        f"({h_moved} B / 3.35 TB/s; {h_ops} float64 ops / 34 TFLOP/s) "
        f"[{card}]")
    record = {"kernels": [{
        "name": "serve_tick", "route": "cuda",
        "source": "src/repro_torch/csrc/serve_tick.cu",
        "replaces": "src/repro/kernels/serve_tick.py:285",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None}, {
        "name": "harvest_step", "route": "cuda",
        "source": "src/repro_torch/csrc/harvest_step.cu",
        "replaces": "src/repro/kernels/fleet_step.py:53",
        "launches": h_launches, "max_abs_err": h_err, "ms": h_ms,
        "plain_ms": h_plain_ms, "bound_ms": h_bound_ms, "bound_by": h_by,
        "library_ms": None}]}
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the "
        f"check for a card to here [{card}]")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
