"""The one generator of requests, driven by a traffic file and a seed.

A seed fixes everything a run sends: which request comes i-th and the GA
seed of each search.  Every seed sends the same cycle of workload subsets
and objectives (the traffic file's), entered at another point, so two
seeds do the same work in another order.  The rule of the cycle is
``serve.dse.paper_request_mix``'s: request k searches subset k mod S under
objective k mod O.  With ``repeat_share`` p, request i (i >= 1) asks again,
with probability p, what one of the ``repeat_window`` requests before it
asked (the same search and seed), as users who send one query twice do;
which requests repeat, and which, is drawn from the seed.  An open loop's
gaps between arrivals are drawn from the seed too (``Arrivals``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

SEED_SPAN = 2 ** 31  # GA seeds are drawn below this
_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finaliser: a well-spread 64-bit word of ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


@dataclasses.dataclass(frozen=True)
class Search:
    names: Tuple[str, ...]  # the workload set
    objective: str
    seed: int


def subsets(rules: Sequence[str], names: Sequence[str]) -> List[Tuple[str, ...]]:
    """Workload subsets by rule: ``all`` (the whole set), ``singles`` (each
    workload), ``pairs`` (each workload with the next, cyclically)."""
    W = len(names)
    out: List[Tuple[str, ...]] = []
    for rule in rules:
        if rule == "all":
            out.append(tuple(names))
        elif rule == "singles":
            out += [(n,) for n in names]
        elif rule == "pairs":
            out += [(names[i], names[(i + 1) % W]) for i in range(W)] if W > 1 else []
        else:
            raise ValueError(f"unknown subset rule {rule!r}")
    return out


def _words(seed: int, n: int) -> np.ndarray:
    return np.random.SeedSequence(int(seed) % 2 ** 64).generate_state(n, np.uint64)


class Stream:
    """The service's requests, by index: ``stream[i]`` is a ``Search``.
    Index ``-k`` (k >= 1) is the k-th warm-up request, drawn apart."""

    def __init__(self, traffic: Dict, names: Sequence[str], seed: int):
        self.subsets = subsets(traffic["subsets"], names)
        self.objectives = list(traffic["objectives"])
        w = _words(seed, 4)
        self.offset = int(w[0] % (len(self.subsets) * len(self.objectives)))
        self.base = int(w[1] % SEED_SPAN)
        self.warm = int(w[2] % SEED_SPAN)
        self.repeat_word = int(w[3])
        self.repeat_share = float(traffic.get("repeat_share", 0.0))
        self.repeat_window = int(traffic.get("repeat_window", 256))

    def __getitem__(self, i: int) -> Search:
        if self.repeat_share > 0 and i >= 1:
            x = _mix(self.repeat_word ^ i)
            if (x >> 11) * 2.0 ** -53 < self.repeat_share:
                i -= 1 + _mix(x) % min(i, self.repeat_window)
        k = self.offset + i
        base = self.base if i >= 0 else self.warm
        return Search(self.subsets[k % len(self.subsets)],
                      self.objectives[k % len(self.objectives)],
                      (base + i) % SEED_SPAN)


class Arrivals:
    """An open loop's gaps (s) between arrivals, by index: exponential with
    mean ``1 / rate_per_s``, drawn from the seed in blocks."""

    def __init__(self, traffic: Dict, seed: int, block: int = 4096):
        self.mean = 1.0 / float(traffic["rate_per_s"])
        self.rng = np.random.Generator(np.random.PCG64(_words(seed, 4)[3:].tolist() + [1]))
        self.block = block
        self.gaps = np.zeros(0)

    def __getitem__(self, k: int) -> float:
        while k >= len(self.gaps):
            self.gaps = np.append(self.gaps, self.rng.exponential(self.mean, self.block))
        return float(self.gaps[k])


class Calls:
    """The sweep's calls, by index: ``calls[c]`` is (the joint seeds, the
    separate searches' seeds), ``seeds_per_call`` of each; index -1 is the
    warm-up call."""

    def __init__(self, traffic: Dict, seed: int):
        self.n = int(traffic["seeds_per_call"])
        w = _words(seed, 2)
        self.base = int(w[0] % SEED_SPAN)
        self.sep = int(w[1] % SEED_SPAN)

    def __getitem__(self, c: int) -> Tuple[List[int], List[int]]:
        first = (c + 1) * self.n
        return ([(self.base + first + j) % SEED_SPAN for j in range(self.n)],
                [(self.sep + first + j) % SEED_SPAN for j in range(self.n)])


def workload_sets(cfg: dict, sets) -> dict:
    """The program's ``WorkloadSet`` of each workload subset: the whole set
    packed from the configuration's frozen layer tables, and its subsets
    cut from it (``WorkloadSet.subset``, as ``paper_request_mix`` cuts
    them: padded to the whole set's depth)."""
    from repro_torch.workloads.pack import pack_workloads

    order = list(cfg["workloads"])
    full = pack_workloads([(n, cfg["workloads"][n]) for n in order])
    return {names: full.subset([order.index(n) for n in names]) for names in sets}
