"""The DSE service under load on a search mesh of ranks, one card a rank
(``serve.dse.AsyncDSEService(mesh=)``, ``launch.mesh.make_search_mesh``).

The traffic file is a ``service`` mix (``bench/drivers/service.py``) with a
``mesh`` object, ``{"search": S, "data": D}``: the mesh's shape, whose
S x D ranks the harness starts, one process a card
(``bench/harness/ranks.py``).  Every rank builds the mesh and a
``SearchEngine`` on it with the mix's ``engine`` keywords.  On the lead
(rank 0) the ``Driver`` is the service driver's, its clients included:
the lead plans each launch and broadcasts it.  On every other rank the
``Follower`` is an ``AsyncDSEService`` that runs its rows of each launch
the lead announces, and the gathers, until the lead closes it; it submits
nothing.

Built in a process that is not one of S x D ranks, both refuse at once:
a harness that does not start the ranks gives no reading on one card
under this cell's name.

The window is the service's.  Its counters add the lead's collectives
(``core.distributed.STATS``): calls, and the bytes they brought in.
"""
from __future__ import annotations

from bench.drivers import service
from bench.harness import ranks

window = service.window


def _mesh(traffic: dict, device):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_search_mesh

    s, d = int(traffic["mesh"]["search"]), int(traffic["mesh"]["data"])
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != s * d:
        raise RuntimeError(f"the mix's {s}x{d} search mesh needs a world of {s * d} ranks, "
                           f"one a card (bench/run.py starts them for a cell whose chips "
                           f"is {s * d}); this process is in a world of {world}")
    return make_search_mesh(s, d, device_type=device.type)


class Driver(service.Driver):
    slice_edge = staticmethod(ranks.mark_slice)  # every rank traces the lead's slice

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        mesh = _mesh(traffic, device)
        super().__init__(cfg, {**traffic, "engine": {**traffic.get("engine", {}), "mesh": mesh}},
                         seed, device)

    def counters(self):
        from repro_torch.core.distributed import STATS

        return {**super().counters(), "collective_calls": STATS.calls,
                "collective_bytes": STATS.bytes}


class Follower:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.core.engine import SearchEngine
        from repro_torch.serve.dse import AsyncDSEService

        engine = SearchEngine(device=device, mesh=_mesh(traffic, device),
                              direct_seed=bool(cfg["search"]["direct_seed"]),
                              **traffic.get("engine", {}))
        self.svc = AsyncDSEService(engine=engine, **traffic.get("service", {}))

    def close(self) -> None:
        """Wait until the lead closes the service (its ``stop``)."""
        self.svc.close()
