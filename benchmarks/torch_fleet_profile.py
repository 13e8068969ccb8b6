#!/usr/bin/env python3
"""Where the time goes in the port's serve loop, on one CUDA GPU.

    python3 benchmarks/torch_fleet_profile.py [--workers 131072] \\
        [--ticks 200] [--kernel cuda|q32|f64] [--trace out.json]

Builds the fleet of ``chip_smoke.py``'s main paths (RF/SOM/SIM/SOR/SIR over
32 trace rows, har/harris/lm at 0.4/0.3/0.3, workers/10 requests per
second, batches of 4, dispatch every 10 ticks, reactive routing, seed 0)
with the chosen device tick (the int32 serve-tick kernel, its plain
version, or the float64 tick with the harvest kernel), serves a warm-up
window, then serves ``--ticks`` more under
``torch.profiler`` and prints: wall time per tick, device busy time (the
sum of the CUDA kernels' self time) and the device idle share of the
window, kernel launches per tick, host synchronisations per tick, and the
top operators by device and by host time. A last window of ``--audit``
ticks runs under ``torch.cuda.set_sync_debug_mode("warn")`` and lists
every synchronising call it catches. Imports only the port.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workers", type=int, default=131072)
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--audit", type=int, default=20)
    ap.add_argument("--kernel", choices=("cuda", "q32", "f64"),
                    default="cuda")
    ap.add_argument("--trace", default="",
                    help="also write a Chrome trace of the window here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fleet_profile: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import fleet as L

    n, dt = args.workers, 0.01
    n_steps = args.warmup + args.ticks + args.audit
    power = L.make_power_matrix(["RF", "SOM", "SIM", "SOR", "SIR"],
                                min(32, n), n_steps * dt, dt, 0)
    pool, sched, stream = L.build_scheduled(
        power, dt, n, [L.WORKLOAD_FACTORIES[k]() for k in
                       ("har", "harris", "lm")],
        rate_rps=n / 10.0, mix=np.array([0.4, 0.3, 0.3]), n_steps=n_steps,
        seed=0, max_batch=4, kernel=args.kernel, device="cuda")
    arrivals = stream.counts_matrix(sched.params.W)
    pool.run_serve(sched, arrivals[:args.warmup])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pool.run_serve(sched, arrivals[args.warmup:args.warmup + args.ticks])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pool.run_serve(sched, arrivals[args.warmup + args.ticks:])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync_sites = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message))
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(device_us(e) for e in events if e.device_type.name
                  == "CUDA")
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    syncs = sum(e.count for e in events
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}: {n} workers, {args.ticks} ticks, kernel={args.kernel}")
    print(f"wall {wall * 1e3 / args.ticks:.4f} ms/tick; device busy "
          f"{busy_us / 1e3 / args.ticks:.4f} ms/tick; idle share "
          f"{1 - busy_us / 1e6 / wall:.4f}; {launches / args.ticks:.1f} "
          f"kernel launches/tick; {syncs / args.ticks:.2f} host syncs/tick")
    print(f"sync debug mode, {args.audit} ticks: "
          f"{sum(sync_sites.values())} synchronising calls "
          f"{dict(sync_sites)}")
    print(events.table(sort_by="self_cuda_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=10))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
