"""Fleet dispatcher: a thin host frontend over the torch control plane.

Counterpart of ``repro.fleet.scheduler``: :class:`RequestStream` draws the
deterministic Poisson arrivals (numpy, seeded as in the reference),
:class:`FleetScheduler` holds the control-plane params (numpy) and state
(tensors on the pool's device), and :func:`run_fleet` hands the whole
arrival-count matrix to the pool's fused serve loop
(``backend_torch.TorchFleetBackend.run_serve``). Chunked streaming,
causal refits and sharding come with later slices.
"""
from __future__ import annotations

import numpy as np

from repro_torch.fleet import sched as _sched
from repro_torch.fleet.metrics import sched_summary
from repro_torch.fleet.state import to_numpy
from repro_torch.fleet.worker import FleetWorkerPool
from repro_torch.fleet.workloads import FleetWorkload

# the straggler deadline multiplier (repro.runtime.straggler's default)
DEADLINE_FACTOR = 1.5


class RequestStream:
    """Deterministic Poisson arrivals with a workload mix."""

    def __init__(self, rate_rps: float, mix: np.ndarray, n_steps: int,
                 dt: float, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.counts = rng.poisson(rate_rps * dt, size=n_steps)
        total = int(self.counts.sum())
        mix = np.asarray(mix, dtype=np.float64)
        self.wl = rng.choice(mix.shape[0], size=total, p=mix / mix.sum())

    def counts_matrix(self, n_workloads: int) -> np.ndarray:
        """(n_steps, W) per-tick arrival counts, the serve loop's input."""
        n_steps = self.counts.shape[0]
        out = np.zeros((n_steps, n_workloads), dtype=np.int64)
        step = np.repeat(np.arange(n_steps), self.counts)
        np.add.at(out, (step, self.wl), 1)
        return out


class FleetScheduler:
    """Host handle over (``SchedParams``, ``SchedState``) for one pool."""

    def __init__(self, pool: FleetWorkerPool,
                 workloads: list[FleetWorkload], *,
                 max_queue: int = 4096,
                 shed_after_s: float = 30.0,
                 max_batch: int = 4,
                 max_retries: int = 2,
                 grace_s: float = 20.0,
                 deadline_factor: float = DEADLINE_FACTOR,
                 sched: str = "reactive",
                 lookahead_s: float = 5.0,
                 forecaster: str = "ou",
                 forecaster_fit: str = "full",
                 lat_bins: int = 64):
        self.pool = pool
        self.workloads = workloads
        self.params = _sched.make_sched_params(
            pool.params, workloads, max_queue=max_queue,
            shed_after_s=shed_after_s, max_batch=max_batch,
            max_retries=max_retries, grace_s=grace_s,
            deadline_factor=deadline_factor, sched=sched,
            lookahead_s=lookahead_s, forecaster=forecaster,
            forecaster_fit=forecaster_fit, lat_bins=lat_bins)
        self.state = _sched.make_sched_state(self.params, pool.device)

    def summary(self, duration_s: float) -> dict:
        fs, ss = to_numpy(self.pool.state, self.state)
        # quantum_j is None for a float64 pool: its ledger is in joules
        return sched_summary(self.params, ss, duration_s, fs,
                             self.pool.params.quantum_j,
                             [w.name for w in self.workloads])


def run_fleet(pool: FleetWorkerPool, sched: FleetScheduler,
              stream: RequestStream, n_steps: int, *,
              dispatch_every: int = 10) -> dict:
    """Serve ``n_steps`` ticks of ``stream`` (arrivals -> control plane ->
    device ticks -> collection) and return the summary dict."""
    arrivals = stream.counts_matrix(sched.params.W)[:n_steps]
    pool.run_serve(sched, arrivals, dispatch_every=dispatch_every)
    return sched.summary(n_steps * pool.dt)
