"""Runtime approximation policies (paper §4.3) as closed forms over tensors.

Counterpart of ``repro.core.policies``: a policy answers, for a vector of
budgets (joules), how many knob units each sample gets, or ``SKIP``.

- GREEDY: the most units the budget affords, then refine greedily.
- SMART(A): the smallest knob whose expected accuracy reaches A, if the
  budget affords it (then refine greedily); otherwise skip the round.
- FIXED(p): a constant knob, skipped when unaffordable.
- CONTINUOUS: all units, always.

``decide_batch(budgets, costs, accuracy)`` returns ``(initial_units,
refine_greedily)`` (int64 and bool tensors on the budgets' device), the
reference's closed forms evaluated with torch ops. The scalar ``decide``
and the reference's per-budget loop fallback are not ported: a policy
without a closed form raises ``TypeError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.budget import CostTable

SKIP = -1


def _max_units_within_batch(costs: CostTable, budgets: torch.Tensor
                            ) -> torch.Tensor:
    """Per budget, the most units whose cumulative cost (fixed and emit
    included) fits, or -1 when not even zero units fit."""
    cum = costs.cumulative_on(budgets.device)
    k = torch.searchsorted(cum, budgets, right=True) - 1
    return torch.where(cum[0] <= budgets, k, -1)


class Policy:
    name = "base"

    def decide_batch(self, budgets: torch.Tensor, costs: CostTable,
                     accuracy: np.ndarray
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        raise TypeError(
            f"{type(self).__name__}.decide_batch has no closed form; the "
            "port runs only closed-form policies (override decide_batch)")


@dataclasses.dataclass(frozen=True)
class Greedy(Policy):
    name: str = "GREEDY"

    def decide_batch(self, budgets, costs, accuracy):
        k = _max_units_within_batch(costs, budgets)
        return torch.where(k < 0, SKIP, k), k >= 0


@dataclasses.dataclass(frozen=True)
class Smart(Policy):
    """``min_accuracy`` is the user-defined floor A (e.g. 0.8 or 0.6)."""

    min_accuracy: float = 0.8
    name: str = "SMART"

    def decide_batch(self, budgets, costs, accuracy):
        if accuracy.shape[0] != costs.n_units + 1:
            raise ValueError("accuracy table must have n_units+1 entries "
                             "(accuracy[k] = expected accuracy with k units)")
        # the accuracy table is a host constant: the floor lookup is numpy
        ok = np.nonzero(np.asarray(accuracy) >= self.min_accuracy)[0]
        if ok.size == 0:
            return (torch.full(budgets.shape, SKIP, dtype=torch.int64,
                               device=budgets.device),
                    torch.zeros(budgets.shape, dtype=torch.bool,
                                device=budgets.device))
        p_required = int(ok[0])
        good = _max_units_within_batch(costs, budgets) >= p_required
        return torch.where(good, p_required, SKIP), good


@dataclasses.dataclass(frozen=True)
class Fixed(Policy):
    units: int = 0
    name: str = "FIXED"

    def decide_batch(self, budgets, costs, accuracy):
        k = _max_units_within_batch(costs, budgets)
        return (torch.where(k >= self.units, self.units, SKIP),
                torch.zeros(budgets.shape, dtype=torch.bool,
                            device=budgets.device))


@dataclasses.dataclass(frozen=True)
class Continuous(Policy):
    """All units, always (the battery-powered reference)."""

    name: str = "CONTINUOUS"

    def decide_batch(self, budgets, costs, accuracy):
        return (torch.full(budgets.shape, costs.n_units, dtype=torch.int64,
                           device=budgets.device),
                torch.zeros(budgets.shape, dtype=torch.bool,
                            device=budgets.device))
