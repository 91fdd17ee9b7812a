"""What decides ``correct``: each number the cell's driver reads, against
the limit that the cell's file (``port_bench/workloads/<cell>.json``)
gives it. A number above its limit, missing or not finite fails the run.
The gaps are measured as the instructions of each driver say: the worst
over leaves, steps or served tokens."""

from __future__ import annotations

import math
import statistics


def worst_leaf_gap(program: dict, reference: dict,
                   leaves=None) -> tuple[float, str]:
    """(the largest ``|program[k] - reference[k]|`` over leaves ``k``, each
    against the larger of the reference's norm of that leaf and of the
    median leaf (some gradients are all but zero); the leaf it is at)."""
    leaves = list(reference) if leaves is None else list(leaves)
    median = statistics.median(reference[k] for k in leaves)
    return max((abs(program[k] - reference[k]) / max(reference[k], median), k)
               for k in leaves)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [value, limit]}) over every number ``limits``
    holds."""
    compared, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        compared[name] = [value, limit]
    return correct, compared
