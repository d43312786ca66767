"""The window's arithmetic, on drivers that only move a fake clock."""
import pytest

from bench.harness.cell import measure


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeSweep:
    """Calls of 40 searches that take ``dt`` seconds each."""

    def __init__(self, clock, dts):
        self.clock, self.dts, self.call_s, self.b1_layers = clock, dts, [], {}
        self.launches = 0

    def call(self, k):
        self.clock.t += self.dts[k] if k >= 0 else 0.05
        self.call_s.append(self.dts[k] if k >= 0 else 0.05)
        self.made = getattr(self, "made", []) + [k]
        self.launches += 9
        return 40

    def counters(self):
        return {"launches": self.launches, "transfer_bytes": 0}


class FakeService:
    """Answers at fixed host times; ``pump`` moves the clock and answers."""

    def __init__(self, clock, times):
        self.clock, self.times = clock, times
        self.t_done, self.t_submit = {}, {}

    def start(self):
        pass

    def pump(self, until):
        for i, t in enumerate(self.times):
            if self.clock.t < t <= until:
                self.t_done[i], self.t_submit[i] = t, t - 0.25
        self.clock.t = until

    def stop(self):
        pass

    def counters(self):
        return {"launches": len(self.t_done), "transfer_bytes": 0}

    def wait_p95_s(self):
        return 0.1

    def completed_between(self, t0, t1):
        return [i for i, t in self.t_done.items() if t0 <= t <= t1]


def test_sweep_rate_is_over_whole_calls():
    clock = Clock()
    d = FakeSweep(clock, [0.3, 0.3, 0.3, 0.3, 0.3])
    run, t0 = measure(d, {"kind": "sweep"}, 1.0, False, clock=clock)
    # calls end at 0.3, 0.6, 0.9, 1.2: the window closes at the call that
    # passes 1 s, and the rate is 4 calls' searches over 1.2 s
    assert (run.searches, run.window_s, t0) == (160, pytest.approx(1.2), 0.0)
    assert run.searches / run.window_s == pytest.approx(133.333333, rel=1e-6)
    assert run.counters["launches"] == 36 and run.call_s == [0.3] * 4


def test_service_rate_is_over_the_window():
    clock = Clock()
    times = [0.05 + 0.1 * k for k in range(40)]  # 10 answers a second
    d = FakeService(clock, times)
    run, t0 = measure(d, {"kind": "service", "ramp_s": 0.5}, 2.0, False, clock=clock)
    # the window is [0.5, 2.5]: the answers at 0.55, ..., 2.45
    assert t0 == 0.5 and run.window_s == 2.0 and run.searches == 20
    assert run.searches / run.window_s == 10.0
    assert run.latencies_s == [pytest.approx(0.25)] * 20 and run.wait_p95_s == 0.1


def test_the_device_slice_traces_fixed_calls_after_the_window(monkeypatch):
    """A mix's ``device_calls`` trace calls -2, -3, ... after the window of
    an untraced run (the same work whatever the window's length), and
    ``device_ms_per_search`` is the slice's busy time over its searches."""
    import contextlib

    from bench.harness import cell
    from bench.harness.spec import Spec
    from bench.harness.trace import Trace

    sweep = Spec().driver("sweep")

    @contextlib.contextmanager
    def traced(out, edge=None):
        yield
        out.append(Trace(window_s=1.0, busy_s=0.06, device_ops=[], idle_gaps=[], launches=[]))

    monkeypatch.setattr(sweep.tracing, "traced", traced)
    for dts in ([0.3] * 5, [0.6] * 5):
        clock = Clock()
        d = FakeSweep(clock, dts)
        run, _ = measure(d, {"kind": "sweep", "device_calls": 3}, 1.0, False, clock=clock,
                         window=sweep.window)
        assert d.made[-3:] == [-2, -3, -4] and run.device_searches == 120
        assert run.searches == 40 * (len(d.made) - 3) and run.call_s == dts[:len(d.made) - 3]
        assert cell.device_ms_per_search(run) == pytest.approx(0.5)
    clock = Clock()
    d = FakeSweep(clock, [0.3] * 5)
    run, _ = measure(d, {"kind": "sweep", "device_calls": 3, "trace_calls": 1}, 1.0, True,
                     clock=clock, window=sweep.window)
    assert d.made == [0, 1, 2, 3, 4] and run.device_searches == 0
