"""Cells on more than one card: rank 0 in this process, ranks 1 .. chips - 1
as its children, one card each, in one default process group.

``bench/run.py`` runs a cell whose ``chips`` is over 1 so:

* ``Lead(chips, follower_cmd)`` starts each follower, ``follower_cmd`` with
  ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` (127.0.0.1) and
  a free ``MASTER_PORT`` in its environment, before this process imports
  torch, so that the ranks load side by side.  A follower's standard output
  goes to the lead's standard error: only the lead prints the result.
* ``run_lead`` makes the default process group as rank 0 on the card of
  ``LOCAL_RANK`` 0 (``launch.mesh.init_world``: NCCL on a card, gloo on the
  CPU), puts the fault to plant (or none) on the group's store, runs the
  cell with the fault planted here too, takes each follower's peak memory
  and traced slice from the store, and lets the followers go.
* ``follow`` is a follower's run: it makes the group as its rank, plants
  the fault it reads from the store, builds its side of the cell (the
  traffic kind's ``Follower``), profiles its own card over the lead's
  traced slice (``mark_slice``: store keys arm the followers' profilers,
  open the slices and close them), and once its side is done hands back
  its peak and its slice's summary (``trace.summarize``) through the
  store.

The followers die with the lead (``PR_SET_PDEATHSIG``).  A follower that
exits before the lead lets it go ends the lead within ``POLL_S``, with
every other follower, so that no collective waits out the groups' timeout
(``launch.mesh.TIMEOUT_S``, 120 s); the lead's exit code is then not 0.
Once every rank has reported, each process leaves with ``os._exit``: the
communicators are not torn down, as their peers are gone.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional

KEY = "bench/"
POLL_S = 0.2  # how often the lead looks at its followers
WAIT_S = 600.0  # a follower's longest wait for the lead (a run ends within 360 s)
COLLECT_S = 60.0  # the lead's longest wait for the followers' reports
FINISH_S = 30.0  # and for their exits
FAILED = 4  # the lead's exit code when a rank failed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In the child, before it runs: SIGKILL when the parent exits."""
    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG


def store():
    """The default process group's store."""
    from torch.distributed import distributed_c10d

    return distributed_c10d._get_default_store()


def wait_for(st, keys: List[str], timeout_s: float) -> None:
    """Wait until ``keys`` are on the store ``st``, asking every 20 ms.  Not
    the store's own ``wait``: a client blocked there holds its connection,
    and NCCL makes a communicator at its first collective by way of that
    connection, which would then wait with it."""
    deadline = time.monotonic() + timeout_s
    while not st.check(keys):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {keys} on the store after {timeout_s} s")
        time.sleep(0.02)


def mark_slice(edge: str) -> None:
    """An edge of a traced slice (``trace.traced``'s ``edge``), in a world
    of more than one rank; nothing without one.  ``"open"``, once a rank's
    profiler runs: the lead arms the followers' profilers and waits until
    each runs (starting one holds its process a second or so, and with it
    the service's collectives on every rank), then opens every rank's slice
    at once; ``"stop"``, the lead's slice over: the followers' slices
    close and their profilers stop, and the lead waits for them
    (``"stopped"``) before its own stops.  So no rank's profiler starts or
    stops inside another's slice."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    st, rank, n = store(), dist.get_rank(), dist.get_world_size()
    if rank == 0 and edge == "open":
        st.set(f"{KEY}slice/arm", "1")
        wait_for(st, [f"{KEY}slice/armed/{r}" for r in range(1, n)], COLLECT_S)
        st.set(f"{KEY}slice/open", "1")
    elif rank == 0 and edge == "stop":
        st.set(f"{KEY}slice/stop", "1")
        wait_for(st, [f"{KEY}slice/stopped/{r}" for r in range(1, n)], COLLECT_S)
    elif rank and edge == "open":
        st.set(f"{KEY}slice/armed/{rank}", "1")
        wait_for(st, [f"{KEY}slice/open"], WAIT_S)
    elif rank and edge == "stopped":
        st.set(f"{KEY}slice/stopped/{rank}", "1")


def planted(fault: str):
    """The fault ``fault`` (``bench/harness/faults.py``) planted while
    open; none for ``""``."""
    from bench.harness.faults import FAULTS

    return FAULTS[fault]() if fault else contextlib.nullcontext()


def _peak(dev) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


class Lead:
    """Rank 0's handle on its followers (ranks 1 .. chips - 1)."""

    def __init__(self, chips: int, follower_cmd: List[str]):
        self.chips = int(chips)
        self.env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
                    "WORLD_SIZE": str(self.chips)}
        self.released = threading.Event()
        self.procs = [subprocess.Popen(follower_cmd, stdin=subprocess.DEVNULL, stdout=2,
                                       env={**os.environ, **self.env, "RANK": str(r),
                                            "LOCAL_RANK": str(r)},
                                       preexec_fn=_die_with_parent)
                      for r in range(1, self.chips)]
        self.store = None
        threading.Thread(target=self._watch, name="bench-ranks", daemon=True).start()

    def _watch(self) -> None:
        while not self.released.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is not None and not self.released.is_set():
                    print(f"bench: rank {r} exited with code {rc} before the run ended; "
                          "ending the run", file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(FAILED)

    def join(self, device_type: str = "cuda"):
        """Make the default process group as rank 0; returns this rank's
        device."""
        os.environ.update({**self.env, "RANK": "0", "LOCAL_RANK": "0"})
        from repro_torch.launch.mesh import init_world

        _, _, dev = init_world(device_type)
        self.store = store()
        return dev

    def collect(self, timeout_s: float = COLLECT_S):
        """Each follower's (peak memory in bytes, traced slice's ``Trace`` or
        ``None``), once it has reported."""
        ranks = range(1, self.chips)
        keys = [f"{KEY}{k}/{r}" for r in ranks for k in ("peak", "trace")]
        wait_for(self.store, keys, timeout_s)
        return ([int(self.store.get(f"{KEY}peak/{r}")) for r in ranks],
                [pickle.loads(self.store.get(f"{KEY}trace/{r}")) for r in ranks])

    def finish(self, timeout_s: float = FINISH_S) -> List[Optional[int]]:
        """Let the followers go and wait for them; their exit codes (``None``
        for one that had to be killed)."""
        self.released.set()
        self.store.set(f"{KEY}done", "1")
        deadline = time.monotonic() + timeout_s
        rcs: List[Optional[int]] = []
        for p in self.procs:
            try:
                rcs.append(p.wait(max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        self.kill()
        return rcs

    def kill(self) -> None:
        """End every follower still running, and reap it."""
        self.released.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(10.0)


def run_lead(lead: Lead, cell: str, seed: int, seconds: float, trace: bool, *, spec,
             t_start: float, device_type: str = "cuda", fault: str = "",
             control: bool = False):
    """Rank 0's run of ``cell``: returns (exit code, the result's line or
    ``None`` where a follower failed)."""
    from bench.harness.cell import run_cell

    dev = lead.join(device_type)
    lead.store.set(f"{KEY}fault", fault)
    with planted(fault):
        out = run_cell(cell, seed, seconds, trace, t_start=t_start, device=dev,
                       chips=lead.chips, control=control, spec=spec, world=lead)
    rcs = lead.finish()
    if any(rc != 0 for rc in rcs):
        print(f"bench: the followers' exit codes are {rcs}", file=sys.stderr, flush=True)
        return FAILED, None
    return 0, out


def follow(cell: str, seed: int, trace: bool, spec, device_type: str = "cuda") -> int:
    """A follower's run of ``cell`` (rank and world from the environment)."""
    from repro_torch.launch.mesh import init_world

    from bench.harness import trace as tracing

    rank, _, dev = init_world(device_type)
    st = store()
    wait_for(st, [f"{KEY}fault"], WAIT_S)
    fault = st.get(f"{KEY}fault").decode()
    traffic = spec.traffic(spec.cell(cell)["traffic"])
    kind = spec.driver(traffic["kind"])
    if dev.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(dev)
    traces: list = []
    with planted(fault):
        side = kind.Follower(spec.config(spec.cell(cell)["config"]), traffic, seed, dev)
        print(f"bench: rank {rank} (pid {os.getpid()}) follows on {dev}, fault "
              f"{fault or 'none'}", file=sys.stderr, flush=True)
        if trace:
            wait_for(st, [f"{KEY}slice/arm"], WAIT_S)
            with tracing.traced(traces, edge=mark_slice):
                wait_for(st, [f"{KEY}slice/stop"], WAIT_S)
        side.close()
    st.set(f"{KEY}peak/{rank}", str(_peak(dev)))
    st.set(f"{KEY}trace/{rank}", pickle.dumps(traces[0] if traces else None))
    wait_for(st, [f"{KEY}done"], WAIT_S)
    return 0
