"""The serving-session metrics (``metrics/*_ms.*.py`` through
``spans.py``) on tiny cells, traced, on the CPU: each reads a finite
positive number on its own cell and nothing on the train cell, and a
traced run reads only its own window's spans."""

import math
import time
from collections import Counter

import pytest

from benchmark import harness
from benchmark.tests import tiny
from onet_tpu_torch.utils import profiling

NEW = {tiny.REQUESTS: ("lock_wait_ms.requests", "step_launch_ms.requests",
                       "session_copy_ms.requests"),
       tiny.SERVE_BF16: ("session_copy_ms.serve",),
       tiny.SERVE_INT8: ("session_copy_ms.serve-int8",)}
ALL = [m for ms in NEW.values() for m in ms]


def traced(cell, seed=tiny.SEED, seconds=0.3):
    # bf16 on the CPU is not held to the card's limits (test_bench_faults)
    over = {} if cell == tiny.SERVE_INT8 else {"precision": "fp32"}
    bench, cfg, mix = tiny.tiny(cell, **over)
    return harness.run_cell(cell, seed, seconds, True,
                            t_start=time.perf_counter(), device="cpu",
                            bench=bench, cfg=cfg, mix=mix)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_readers_read_their_own_cell(cell):
    out = traced(cell)
    assert out["correct"], out["checks"]
    for name in NEW[cell]:
        v = out["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, name
    assert not set(out["metrics"]) & (set(ALL) - set(NEW[cell]))


def test_readers_read_nothing_on_train():
    out = traced(tiny.TRAIN)
    assert out["correct"] and not set(out["metrics"]) & set(ALL)
    traced(tiny.SERVE_BF16)            # the latest session holds spans
    for name in ALL:
        assert harness.reader(name).read({"kind": "train"}) is None


def test_two_traced_runs_read_their_own_windows():
    seen = []
    for seed in (tiny.SEED, tiny.SEED + 1):
        out = traced(tiny.SERVE_BF16, seed=seed)
        spans = profiling.profiled_spans()
        names = Counter(r.name for r in spans)
        # the window's calls, one segment each, and not set-up's
        assert names["session.segment"] == out["attempted"] > 0
        assert names["session.step"] == out["attempted"]
        assert len({r.session for r in spans}) == 1
        seen.append(spans)
    first, second = seen
    assert first[0].session != second[0].session
    assert max(r.id for r in first) < min(r.id for r in second)


def test_span_timeline_puts_each_gap_in_its_span():
    """Two device records with idle time around them: each part of a
    gap goes to the innermost span covering it, and the gap is named by
    the host op running at its start, as trace.py names it."""
    from benchmark.span_timeline import place_gaps

    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 30},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 60, "dur": 20},
          {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 35,
           "dur": 30}]
    rows = [{"name": "session.segment", "ts_us": 0, "end_us": 100},
            {"name": "session.copy_in", "ts_us": 0, "end_us": 5},
            {"name": "session.labels_out", "ts_us": 40, "end_us": 85},
            {"name": "session.cast", "ts_us": 85, "end_us": 100}]
    got = place_gaps(ev, rows)
    assert got == {("session.copy_in", "host (no op)"): 0.005,
                   ("session.segment", "host (no op)"): 0.005,
                   ("session.labels_out", "aten::to"): 0.02,
                   ("session.labels_out", "host (no op)"): 0.005,
                   ("session.cast", "host (no op)"): 0.015}


def test_copies_count_whole_requests_of_the_window(tmp_path):
    """A call begun before the window is left out, and one still open
    when the window ends counts whole."""
    from benchmark.spans import per_request_median_ms

    def copy(ms):
        with profiling.span("session.copy_in"):
            time.sleep(ms / 1e3)

    before = profiling.span("session.segment").__enter__()
    with profiling.trace(str(tmp_path)):
        copy(2)
        before.__exit__(None, None, None)
        with profiling.span("session.segment"):
            copy(10)
        after = profiling.span("session.segment").__enter__()
        copy(2)
    copy(20)
    after.__exit__(None, None, None)
    got = per_request_median_ms({"kind": "serve"}, "serve")
    assert 15 < got < 30         # the median of ~10 and ~22 ms
