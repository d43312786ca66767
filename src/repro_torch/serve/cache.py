"""Content-keyed result cache of the DSE service.

The cheapest search is the one not run: ``request_key`` is a sha256 over
everything that decides a request's result bits

    (cost-model version, grid token, workload fingerprint, objective,
     exponent weights, area constraint, backend, pop size, generations,
     top_k, pareto_k, tech,
     the random stream: its device's generator or threefry, the seed, the
     threefry key, and any given initial population or uniform blocks)

and over nothing else: ``priority`` and ``deadline_s`` only reorder
launches.  The stream tag is the port's own component: the same seed
draws other designs on the CPU's generator than on CUDA's, so a disk tier
shared by a CPU run and a card run must not serve one's result as the
other's.  A cache is built for one device and stream
(``ResultCache(device=, prng=)``) and keys with their tag; an engine
refuses a cache of another device or stream.

``ResultCache`` maps the key to a finalized ``SearchResult`` in two tiers:
an in-memory LRU front (``capacity`` entries, thread-safe: the async
service's worker and its clients share one) and an optional disk tier
under ``disk_dir/<request_key>`` written through ``checkpoint.store``
(atomic; a fresh process over the same directory serves the same bits;
a memory eviction never touches the disk).

Only full results are cached: ``partial=True`` snapshots are views of an
unfinished search.  Full results without a history (``ga=None``, the
pipelined engine's) are cached too; ``valid=False`` full results as well,
since searching again cannot make them feasible.  Pareto results carry
their members' (E, L, A) vectors through both tiers.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch import imc
from repro_torch.checkpoint import store
from repro_torch.core import space
from repro_torch.core.engine import SearchRequest, SearchResult, hash_stream, stream_tag
from repro_torch.core.ga import GAResult

_EMPTY = np.zeros((0,), np.float32)


def request_key(req: SearchRequest, stream: str) -> str:
    """Content key of one request's result on the random stream ``stream``
    (``core.engine.stream_tag`` of the device that computes it and of its
    streams, torch or threefry)."""
    h = hashlib.sha256()
    h.update(imc.COST_MODEL_VERSION.encode())  # read per call: a bump misses
    h.update(space.grid_token().encode())
    h.update(req.ws.fingerprint().encode())
    h.update(repr((
        req.objective, req.obj_weights, float(req.area_constr), req.backend,
        int(req.pop_size), int(req.generations), int(req.top_k), int(req.pareto_k),
        req.tech,
    )).encode())
    h.update(stream.encode())
    hash_stream(h, req)
    return h.hexdigest()


def _encode(res: SearchResult) -> list:
    """A result as ``checkpoint.store`` leaves, always the same nine: the
    four history fields (empty for a result without one), the top scores,
    genomes and convergence, the Pareto members' objective vectors (empty
    for the scalar families), and the other fields as a JSON byte array."""
    thin = res.ga is None
    vecs = res.objective_vectors
    meta = {
        "workload_names": list(res.workload_names),
        "objective": res.objective,
        "valid": bool(res.valid),
        "generations": int(res.generations),
        "thin": thin,
        "vectors": vecs is not None,
    }
    history = [_EMPTY] * 4 if thin else [np.asarray(f) for f in res.ga]
    return history + [
        np.asarray(res.top_scores), np.asarray(res.top_genomes),
        np.asarray(res.convergence),
        _EMPTY if vecs is None else np.asarray(vecs),
        np.frombuffer(json.dumps(meta).encode(), np.uint8),
    ]


def _decode(leaves: list) -> SearchResult:
    g, s, bg, bs, ts, tg, cv, ov, blob = leaves
    meta = json.loads(bytes(np.asarray(blob).tobytes()).decode())
    ga = None if meta["thin"] else GAResult(genomes=g, scores=s, best_genome=bg,
                                            best_score=bs)
    # top_designs are a function of top_genomes: recomputed, not stored
    designs = (space.design_dicts_from_indices(space.decode_indices_np(tg))
               if tg.size else [])
    return SearchResult(
        workload_names=tuple(meta["workload_names"]),
        objective=meta["objective"],
        ga=ga,
        top_designs=designs,
        top_scores=ts,
        top_genomes=tg,
        convergence=cv,
        valid=bool(meta["valid"]),
        partial=False,
        generations=int(meta["generations"]),
        objective_vectors=ov if meta["vectors"] else None,
    )


@dataclasses.dataclass
class CacheStats:
    hits: int = 0  # memory-tier hits
    disk_hits: int = 0  # disk-tier hits (promoted into memory)
    misses: int = 0
    puts: int = 0
    evictions: int = 0  # memory-tier LRU evictions (disk untouched)

    def hit_rate(self) -> float:
        """Share of lookups served from either tier (0.0 before any)."""
        served = self.hits + self.disk_hits
        total = served + self.misses
        return served / total if total else 0.0

    def summary(self) -> Dict[str, Union[int, float]]:
        out: Dict[str, Union[int, float]] = dataclasses.asdict(self)
        out["hit_rate"] = self.hit_rate()
        return out


class ResultCache:
    """Two-tier (LRU memory + optional disk) ``request_key`` -> finalized
    ``SearchResult`` store for results computed on ``device`` from the
    random streams ``prng`` (``core.engine.stream_tag``).  ``get`` /
    ``put`` take a ``SearchRequest`` or a key string; a disk hit is
    promoted into memory.  Thread-safe; disk writes are atomic."""

    def __init__(self, capacity: int = 1024,
                 disk_dir: Optional[Union[str, Path]] = None, *, device="cuda",
                 prng: str = "torch"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.disk_dir = None if disk_dir is None else Path(disk_dir)
        self.stream = stream_tag(device, prng)
        self._mem: "OrderedDict[str, SearchResult]" = OrderedDict()
        self._lock = threading.RLock()
        self.stats = CacheStats()

    def key(self, req: SearchRequest) -> str:
        return request_key(req, self.stream)

    def _as_key(self, req_or_key: Union[SearchRequest, str]) -> str:
        return req_or_key if isinstance(req_or_key, str) else self.key(req_or_key)

    def get(self, req_or_key: Union[SearchRequest, str]) -> Optional[SearchResult]:
        key = self._as_key(req_or_key)
        with self._lock:
            hit = self._mem.get(key)
            if hit is not None:
                self._mem.move_to_end(key)
                self.stats.hits += 1
                return hit
            res = self._disk_get(key)
            if res is not None:
                self.stats.disk_hits += 1
                self._mem_put(key, res)
                return res
            self.stats.misses += 1
            return None

    def put(self, req_or_key: Union[SearchRequest, str], res: SearchResult) -> bool:
        """Insert a full result; a ``partial=True`` snapshot is refused
        (returns False): it must never shadow the request's answer."""
        if res.partial:
            return False
        key = self._as_key(req_or_key)
        with self._lock:
            self.stats.puts += 1
            self._mem_put(key, res)
            self._disk_put(key, res)
        return True

    def _mem_put(self, key: str, res: SearchResult) -> None:
        self._mem[key] = res
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.stats.evictions += 1

    def _disk_get(self, key: str) -> Optional[SearchResult]:
        if self.disk_dir is None:
            return None
        d = self.disk_dir / key
        if store.latest_step(d) is None:
            return None
        leaves, _ = store.restore(d)
        return _decode(leaves)

    def _disk_put(self, key: str, res: SearchResult) -> None:
        if self.disk_dir is None:
            return
        d = self.disk_dir / key
        if store.latest_step(d) is not None:
            return  # content-keyed: a committed entry is this result
        store.save(d, 0, _encode(res))

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def __contains__(self, req_or_key) -> bool:
        key = self._as_key(req_or_key)
        with self._lock:
            if key in self._mem:
                return True
        return self._disk_get(key) is not None if self.disk_dir else False

    def mem_keys(self) -> List[str]:
        """Memory-tier keys, next to evict first."""
        with self._lock:
            return list(self._mem)

    def disk_keys(self) -> List[str]:
        """Committed disk-tier keys."""
        return [] if self.disk_dir is None else store.scan(self.disk_dir)

    def clear(self, *, disk: bool = False) -> None:
        """Drop the memory tier; ``disk=True`` also removes every committed
        disk entry."""
        with self._lock:
            self._mem.clear()
            if disk and self.disk_dir is not None:
                for key in store.scan(self.disk_dir):
                    store.clear(self.disk_dir / key)
