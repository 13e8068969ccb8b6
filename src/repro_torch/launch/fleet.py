"""Fleet serving launcher of the port: scheduled vs independent workers.

    PYTHONPATH=src python -m repro_torch.launch.fleet --workers 131072 \\
        --duration 30 --scheduler on --kernel cuda
    PYTHONPATH=src python -m repro_torch.launch.fleet --workers 32 \\
        --duration 60 --scheduler both --kernel f64 --device cpu

Builds a harvest-powered worker fleet over a mix of energy-trace families
and serves one global HAR + Harris + LM request stream through the
array-native control plane (``--scheduler on``), or as independent
self-sampling workers, the no-scheduler baseline (``off``), or both
(``both``, the default, which also prints ``speedup_completed``), then
prints the summary as JSON. The scheduled fleet's device tick is the CUDA
serve-tick kernel (``--kernel cuda``, the default), its plain PyTorch
twin (``q32``) or the float64 tick (``f64``, the reference's
``--kernel xla``, whose harvest stage is the CUDA ``harvest_step``
kernel); the independent baseline always runs the float64 tick, as in
the reference. Flags are the reference's (``python -m repro.launch.fleet``);
a value this port does not serve yet (forecast or quality routing,
streaming, sharding, persistence, observability) exits with "not ported
yet". ``--device`` (default ``cuda``) selects where the state lives.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core.energy import (TRACE_FACTORIES, Capacitor,
                                     McuEnergyModel, get_trace)
from repro_torch.core.forecast import FORECASTER_MODES
from repro_torch.core.policies import Greedy, Smart
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.fleet.sched import SCHED_MODES
from repro_torch.fleet.scheduler import (FleetScheduler, RequestStream,
                                         run_fleet)
from repro_torch.fleet.state import to_numpy
from repro_torch.fleet.worker import FleetWorkerPool, stack_traces
from repro_torch.fleet.workloads import (FleetWorkload, har_workload,
                                         harris_workload, lm_workload)

WORKLOAD_FACTORIES = {
    "har": har_workload,
    "harris": harris_workload,
    "lm": lm_workload,
}

# reference flags whose other values this port does not serve yet
PORTED_VALUES = {
    "scheduler": ("on", "off", "both"),
    "backend": ("torch",),
    "kernel": ("q32", "cuda", "f64"),
    "mesh_fleet": (1,),
    "rebalance_every": (0.0,),
    "fleet_placement": ("auto",),
    "sched": ("reactive",),
    "quality": ("proxy",),
    "stream": (False,),
    "chunk_ticks": (0,),
    "refit_every": (0.0,),
    "slo_p95": (0.0,),
    "persist": ("none",),
    "obs": ("off",),
    "trace_out": ("",),
}


def trace_family_labels(trace_names: list[str], n_rows: int) -> list[str]:
    """Per-row family labels matching :func:`make_power_matrix`'s cycling."""
    return [trace_names[r % len(trace_names)] for r in range(n_rows)]


def make_power_matrix(trace_names: list[str], n_rows: int,
                      duration_s: float, dt: float = 0.01,
                      seed: int = 0) -> np.ndarray:
    """(n_rows, T) harvested-power matrix cycling through the families,
    row r seeded ``seed + r`` (bit-identical to the reference's)."""
    rows = [get_trace(fam, seed=seed + r, duration_s=duration_s, dt=dt)
            for r, fam in enumerate(trace_family_labels(trace_names,
                                                        n_rows))]
    return stack_traces(rows)


def hetero_capacitors(n_workers: int, seed: int = 0,
                      cap: Capacitor | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Per-worker ``(capacitance_f, v_max)``: capacitance log-uniform in
    [0.5x, 2x] of the reference buffer, v_max jittered within 0.2 V."""
    cap = cap or Capacitor()
    rng = np.random.default_rng(seed)
    C = cap.capacitance_f * np.exp(rng.uniform(np.log(0.5), np.log(2.0),
                                               n_workers))
    v_max = cap.v_max + rng.uniform(0.0, 0.2, n_workers)
    return C, v_max


def hetero_mcu(n_workers: int, seed: int = 0,
               mcu: McuEnergyModel | None = None) -> np.ndarray:
    """Per-worker active power: one of {0.5x, 1x, 2x} the reference MCU."""
    mcu = mcu or McuEnergyModel()
    rng = np.random.default_rng(seed + 1)
    classes = mcu.active_power_w * np.array([0.5, 1.0, 2.0])
    return rng.choice(classes, size=n_workers)


def build_dispatch_pool(power: np.ndarray, dt: float, n_workers: int,
                        workloads: list[FleetWorkload],
                        seed: int = 0, *,
                        capacitance_f: np.ndarray | None = None,
                        v_max: np.ndarray | None = None,
                        active_power_w: np.ndarray | None = None,
                        kernel: str = "cuda",
                        persist: str = "none",
                        device: str = DEFAULT_DEVICE) -> FleetWorkerPool:
    rng = np.random.default_rng(seed)
    return FleetWorkerPool(
        power, dt, workloads=[w.costs for w in workloads], mode="dispatch",
        n_workers=n_workers,
        trace_index=np.arange(n_workers) % power.shape[0],
        phase=rng.integers(0, power.shape[1], n_workers),
        capacitance_f=capacitance_f, v_max=v_max,
        active_power_w=active_power_w, kernel=kernel, persist=persist,
        device=device)


def build_scheduled(power: np.ndarray, dt: float, n_workers: int,
                    workloads: list[FleetWorkload], *, rate_rps: float,
                    mix: np.ndarray, n_steps: int, seed: int = 0,
                    max_batch: int = 4, shed_after_s: float = 30.0,
                    sched: str = "reactive", lookahead_s: float = 5.0,
                    forecaster: str = "ou", forecaster_fit: str = "full",
                    capacitance_f: np.ndarray | None = None,
                    v_max: np.ndarray | None = None,
                    active_power_w: np.ndarray | None = None,
                    kernel: str = "cuda", persist: str = "none",
                    grace_s: float = 20.0, device: str = DEFAULT_DEVICE
                    ) -> tuple[FleetWorkerPool, FleetScheduler,
                               RequestStream]:
    """The scheduled fleet :func:`run_scheduled` serves: the dispatch
    pool, its scheduler and the request stream (seeded ``seed + 1``),
    ready for ``run_fleet``; their states stay readable after the serve."""
    pool = build_dispatch_pool(power, dt, n_workers, workloads, seed,
                               capacitance_f=capacitance_f, v_max=v_max,
                               active_power_w=active_power_w,
                               kernel=kernel, persist=persist, device=device)
    scheduler = FleetScheduler(pool, workloads, max_batch=max_batch,
                               grace_s=grace_s, shed_after_s=shed_after_s,
                               sched=sched, lookahead_s=lookahead_s,
                               forecaster=forecaster,
                               forecaster_fit=forecaster_fit)
    stream = RequestStream(rate_rps, mix, n_steps, dt, seed=seed + 1)
    return pool, scheduler, stream


def run_scheduled(power: np.ndarray, dt: float, n_workers: int,
                  workloads: list[FleetWorkload], *, rate_rps: float,
                  mix: np.ndarray, n_steps: int, seed: int = 0,
                  max_batch: int = 4, shed_after_s: float = 30.0,
                  dispatch_every: int = 10,
                  sched: str = "reactive", lookahead_s: float = 5.0,
                  forecaster: str = "ou", forecaster_fit: str = "full",
                  capacitance_f: np.ndarray | None = None,
                  v_max: np.ndarray | None = None,
                  active_power_w: np.ndarray | None = None,
                  kernel: str = "cuda", persist: str = "none",
                  grace_s: float = 20.0,
                  device: str = DEFAULT_DEVICE) -> dict:
    """Serve one request stream through the scheduled fleet and return the
    summary dict (the reference's ``run_scheduled`` on this slice)."""
    pool, scheduler, stream = build_scheduled(
        power, dt, n_workers, workloads, rate_rps=rate_rps, mix=mix,
        n_steps=n_steps, seed=seed, max_batch=max_batch,
        shed_after_s=shed_after_s, sched=sched, lookahead_s=lookahead_s,
        forecaster=forecaster, forecaster_fit=forecaster_fit,
        capacitance_f=capacitance_f, v_max=v_max,
        active_power_w=active_power_w, kernel=kernel, persist=persist,
        grace_s=grace_s, device=device)
    summary = run_fleet(pool, scheduler, stream, n_steps,
                        dispatch_every=dispatch_every)
    summary["mode"] = "scheduled"
    summary["sched"] = sched
    summary["persist"] = persist
    summary["forecaster"] = forecaster
    summary["n_workers"] = n_workers
    summary["backend"] = "torch"
    summary["kernel"] = kernel
    summary["mesh_fleet"] = 1
    return summary


def run_independent(power: np.ndarray, dt: float, n_workers: int,
                    workloads: list[FleetWorkload], *, mix: np.ndarray,
                    period_s: float, n_steps: int, seed: int = 0,
                    capacitance_f: np.ndarray | None = None,
                    v_max: np.ndarray | None = None,
                    active_power_w: np.ndarray | None = None,
                    device: str = DEFAULT_DEVICE) -> dict:
    """No-scheduler baseline: workers are pinned to a workload (by the
    request mix) and self-sample every ``period_s``, the same offered load
    as a ``rate_rps = n_workers / period_s`` stream with no routing. One
    local-mode pool per workload runs the float64 tick (quantized kernels
    are dispatch-only); the accounting sums the pools' counters on the
    host."""
    counts = (np.asarray(mix) / np.sum(mix) * n_workers).astype(int)
    counts[0] += n_workers - counts.sum()
    completed = 0
    units_sum = 0.0
    acc_sum = 0.0
    harvested = 0.0
    work = 0.0
    skipped = 0
    per_wl = {}
    rng = np.random.default_rng(seed)
    start = 0
    for wl, cnt in zip(workloads, counts):
        if cnt == 0:
            continue
        sl = slice(start, start + cnt)
        start += cnt
        pool = FleetWorkerPool(
            power, dt, workloads=[wl.costs], mode="local", n_workers=cnt,
            policy=Smart(wl.floor) if wl.floor > 0 else Greedy(),
            accuracy_table=wl.accuracy,
            sampling_period_s=period_s,
            trace_index=np.arange(cnt) % power.shape[0],
            phase=rng.integers(0, power.shape[1], cnt),
            capacitance_f=(None if capacitance_f is None
                           else capacitance_f[sl]),
            v_max=None if v_max is None else v_max[sl],
            active_power_w=(None if active_power_w is None
                            else active_power_w[sl]),
            kernel="f64", device=device)
        st = pool.run(n_steps)
        s, _ = to_numpy(pool.state)
        completed += st.emitted
        skipped += st.skipped
        units_sum += float(s.emit_units_sum.sum())
        acc_sum += float(s.emit_acc_sum.sum())
        harvested += st.energy_harvested_j
        work += st.energy_on_work_j
        per_wl[wl.name] = {"workers": int(cnt), "completed": st.emitted}
    return {
        "mode": "independent",
        "n_workers": n_workers,
        "backend": "torch",
        "completed": completed,
        "skipped": skipped,
        "throughput_rps": completed / (n_steps * dt),
        "mean_units": units_sum / max(completed, 1),
        "mean_expected_accuracy": acc_sum / max(completed, 1),
        "per_workload": per_wl,
        "energy": {"harvested_j": harvested, "work_j": work,
                   "j_per_completed": work / max(completed, 1),
                   "conservation_ok": bool(harvested + 1e-9 >= work)},
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workers", type=int, default=256)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--traces", default="RF,SOM,SIM,SOR,SIR")
    ap.add_argument("--trace-rows", type=int, default=0,
                    help="distinct trace rows (0: min(32, workers))")
    ap.add_argument("--workloads", default="har,harris,lm")
    ap.add_argument("--mix", default="0.4,0.3,0.3")
    ap.add_argument("--period", type=float, default=10.0,
                    help="per-worker sampling period; the request rate is "
                         "workers/period so both modes see the same load")
    ap.add_argument("--scheduler", choices=("on", "off", "both"),
                    default="both")
    ap.add_argument("--backend", choices=("numpy", "jax", "torch"),
                    default="torch")
    ap.add_argument("--kernel", choices=("xla", "q32", "pallas", "cuda",
                                         "f64"),
                    default="cuda",
                    help="scheduled fleet's tick: the int32 CUDA serve-tick "
                         "kernel (cuda), its plain PyTorch twin (q32), or "
                         "the float64 tick with the CUDA harvest kernel "
                         "(f64, the reference's xla)")
    ap.add_argument("--mesh-fleet", type=int, default=1)
    ap.add_argument("--rebalance-every", type=float, default=0.0)
    ap.add_argument("--fleet-placement",
                    choices=("auto", "mesh", "single"), default="auto")
    ap.add_argument("--hetero", action="store_true",
                    help="heterogeneous fleet: per-worker capacitance/v_max")
    ap.add_argument("--hetero-mcu", action="store_true",
                    help="MCU-class mixing: per-worker active power")
    ap.add_argument("--sched", choices=SCHED_MODES, default="reactive")
    ap.add_argument("--quality", choices=("proxy", "measured"),
                    default="proxy")
    ap.add_argument("--oracle-bank", type=float, default=1.0)
    ap.add_argument("--lookahead", type=float, default=5.0)
    ap.add_argument("--forecaster", choices=FORECASTER_MODES, default="ou")
    ap.add_argument("--forecaster-fit", choices=("full", "causal"),
                    default="full")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--chunk-ticks", type=int, default=0)
    ap.add_argument("--refit-every", type=float, default=0.0)
    ap.add_argument("--slo-p95", type=float, default=0.0)
    ap.add_argument("--persist", choices=("none", "ckpt", "undolog"),
                    default="none")
    ap.add_argument("--grace", type=float, default=20.0,
                    help="straggler-eviction grace in seconds")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--shed-after", type=float, default=30.0)
    ap.add_argument("--obs", choices=("off", "tele", "trace"),
                    default="off")
    ap.add_argument("--obs-window", type=float, default=1.0)
    ap.add_argument("--trace-out", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="", help="write summary to this path")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device holding the fleet (default cuda)")
    args = ap.parse_args(argv)

    if args.kernel == "xla":
        ap.error("--kernel xla is the reference's name for the float64 "
                 "tick; the port calls it --kernel f64")
    for name, ok in PORTED_VALUES.items():
        value = getattr(args, name)
        if value not in ok:
            ap.error(f"--{name.replace('_', '-')} {value} is not ported "
                     f"yet (ported: {', '.join(map(str, ok))})")
    names = args.traces.split(",")
    unknown = [n for n in names if n not in TRACE_FACTORIES]
    if unknown:
        ap.error(f"unknown trace family(ies) {unknown}; "
                 f"choose from {sorted(TRACE_FACTORIES)}")
    wl_names = args.workloads.split(",")
    unknown = [n for n in wl_names if n not in WORKLOAD_FACTORIES]
    if unknown:
        ap.error(f"unknown workload(s) {unknown}; "
                 f"choose from {sorted(WORKLOAD_FACTORIES)}")
    workloads = [WORKLOAD_FACTORIES[n]() for n in wl_names]
    mix = np.array([float(x) for x in args.mix.split(",")])
    if mix.shape[0] != len(workloads):
        ap.error(f"--mix has {mix.shape[0]} entries for "
                 f"{len(workloads)} workloads")
    n_rows = args.trace_rows or min(32, args.workers)
    power = make_power_matrix(names, n_rows, args.duration, args.dt,
                              args.seed)
    n_steps = int(args.duration / args.dt)
    cf = vm = ap_w = None
    if args.hetero:
        cf, vm = hetero_capacitors(args.workers, args.seed)
    if args.hetero_mcu:
        ap_w = hetero_mcu(args.workers, args.seed)
    out: dict = {"config": vars(args)}
    if args.scheduler in ("on", "both"):
        out["scheduled"] = run_scheduled(
            power, args.dt, args.workers, workloads,
            rate_rps=args.workers / args.period, mix=mix, n_steps=n_steps,
            seed=args.seed, max_batch=args.max_batch,
            shed_after_s=args.shed_after, sched=args.sched,
            lookahead_s=args.lookahead, forecaster=args.forecaster,
            forecaster_fit=args.forecaster_fit, capacitance_f=cf, v_max=vm,
            active_power_w=ap_w, kernel=args.kernel, persist=args.persist,
            grace_s=args.grace, device=args.device)
    if args.scheduler in ("off", "both"):
        out["independent"] = run_independent(
            power, args.dt, args.workers, workloads, mix=mix,
            period_s=args.period, n_steps=n_steps, seed=args.seed,
            capacitance_f=cf, v_max=vm, active_power_w=ap_w,
            device=args.device)
    if "scheduled" in out and "independent" in out:
        out["speedup_completed"] = (
            out["scheduled"]["completed"]
            / max(out["independent"]["completed"], 1))
    print(json.dumps(out, indent=1, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return out


if __name__ == "__main__":
    main()
