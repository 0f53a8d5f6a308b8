"""Driver of a request cell: independent requests arrive in an open loop
on a fixed schedule (``traffic/arrivals.py``) and are served by
``ServingSession.segment`` on the threads of a fixed number of client
connections, as the port's ``ThreadingHTTPServer`` serves clients that
keep their connections alive (its handler speaks HTTP/1.1): each
connection is one thread, and a request waits until one is free. The
session's step lock runs one step at a time, so the connections set how
much of one request's host work (copies in and out, the labels' cast)
overlaps another's step; a request beyond them waits for a connection
instead of the lock, and its latency counts that wait all the same. The
session's batch is the request's size, so that each request runs one
step of its own frames (at ``serve``'s default 32 each request of 8
would run a batch padded to 32).

Set-up starts the connection threads and has each serve one request, so
that each has the thread-local state the step builds on first use
(cuDNN's execution plans among it: on an H100 a request on a fresh
thread took ~100 ms against ~38 on a warm one). A request's latency runs
from when it was due to when its masks are in host memory. The window is
the schedule's length; once it has closed the driver waits (up to
``wait_s``) for every request due in it, and one that does not finish,
or fails, counts as missing, with a latency of the window and the wait
together (longer than any the run could see). How late the generator
ran is printed on an earlier line. The session and the check are the
batch-serving driver's (``serve.py``), on the frames of ``check_requests``
requests drawn from the seed: a request served another's masks reads as
wrong wherever the two carry different frames.

The arrival schedule comes from the mix's ``schedule_seed``, the same
for every run: with the order drawn from each run's seed the tail moved
by 18% between seeds where one seed read within a few percent twice, so
the run's seed draws the frames, the weights and which frames each
request carries, and not the work's timing.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from benchmark.drivers import serve
from benchmark.harness import log
from benchmark.traffic.arrivals import schedule
from benchmark.traffic.frames import rng
from benchmark.work.onet import conv_work


class Connections:
    """``n`` client-connection threads that serve requests from a queue
    with ``handle(item)``; ``stop()`` ends and joins them."""

    def __init__(self, n: int, handle):
        self.q = queue.Queue()
        self.handle = handle
        self.threads = [threading.Thread(target=self._run, daemon=True)
                        for _ in range(n)]
        for th in self.threads:
            th.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            self.handle(item)

    def stop(self, timeout: float = 60.0):
        for _ in self.threads:
            self.q.put(None)
        deadline = time.perf_counter() + timeout
        for th in self.threads:
            th.join(timeout=max(0.0, deadline - time.perf_counter()))


def setup(ctx):
    sess, pool = serve.build_session(ctx, ctx.mix["session_batch"])
    st = {"sess": sess, "pool": pool, "handler": None}
    f = ctx.mix["frames_per_request"]

    def handle(item):
        st["handler"](item)

    n = ctx.mix["connections"]
    done = threading.Barrier(n + 1)

    def warm(_):
        sess.segment(pool[:f])
        done.wait()

    st["handler"] = warm
    st["conns"] = Connections(n, handle)
    for _ in range(n):           # one request on each connection's thread
        st["conns"].q.put(0)
    done.wait()
    return st


def p95(lat) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(lat)
    return s[max(0, int(np.ceil(0.95 * len(s))) - 1)]


def draws(ctx, n: int):
    """From the run's seed: which frames each of ``n`` requests carries
    (an index into the pool's consecutive groups of
    ``frames_per_request``), and the set of requests the check keeps."""
    mix = ctx.mix
    npay = mix["pool"] // mix["frames_per_request"]
    payload = rng(ctx.seed, 5).integers(0, npay, size=n)
    keep = set(rng(ctx.seed, 6).choice(
        n, size=min(mix["check_requests"], n), replace=False).tolist())
    return payload, keep


def checked_frames(ctx) -> list:
    """The pool indices of the frames a run's check compares, with a
    frame that two kept requests carry listed twice."""
    mix = ctx.mix
    f = mix["frames_per_request"]
    n = len(schedule(mix["arrivals"], mix["rate_per_s"], ctx.window_seconds,
                     mix["schedule_seed"]))
    payload, keep = draws(ctx, n)
    return [int(payload[i]) * f + j for i in sorted(keep) for j in range(f)]


def window(ctx, st):
    sess, pool, conns = st["sess"], st["pool"], st["conns"]
    mix = ctx.mix
    f = mix["frames_per_request"]
    due = schedule(mix["arrivals"], mix["rate_per_s"], ctx.window_seconds,
                   mix["schedule_seed"])
    n = len(due)
    payload, keep = draws(ctx, n)
    lat = [float("inf")] * n
    late = np.zeros(n)
    kept = {}
    errors = []
    finished = threading.Semaphore(0)
    lock = threading.Lock()

    def handle(item):
        i, t_due = item
        try:
            lo = int(payload[i]) * f
            masks, _ = sess.segment(pool[lo:lo + f])
            t = time.perf_counter()
            with lock:
                lat[i] = t - t_due
                if i in keep:
                    kept[i] = (lo, masks.copy())
        except Exception as e:   # noqa: BLE001 — a missing request
            with lock:
                errors.append(repr(e))
        finally:
            finished.release()

    st["handler"] = handle
    with ctx.window() as w:
        t0 = w.t0
        for i, d in enumerate(due):
            t_due = t0 + float(d)
            now = time.perf_counter()
            if now < t_due:
                time.sleep(t_due - now)
            late[i] = time.perf_counter() - t_due
            conns.q.put((i, t_due))
        end = t0 + ctx.window_seconds
        while time.perf_counter() < end:
            time.sleep(min(0.01, max(0.0, end - time.perf_counter())))
        deadline = time.perf_counter() + mix["wait_s"]
        unfinished = 0
        for _ in range(n):
            if not finished.acquire(
                    timeout=max(0.0, deadline - time.perf_counter())):
                unfinished += 1
    log(f"[requests] {n} due at {mix['rate_per_s']} req/s over "
        f"{ctx.window_seconds} s on {len(conns.threads)} connections; "
        f"generator late: p50 {np.median(late) * 1e3:.3f} ms, max "
        f"{late.max() * 1e3:.3f} ms; {len(errors)} failed, {unfinished} "
        f"unfinished after the wait")
    for e in errors[:3]:
        log(f"[requests] error: {e}")
    failed = sum(1 for v in lat if not np.isfinite(v))
    done = n - failed
    # a missing request is slower than any the run could see finish
    worst = ctx.window_seconds + mix["wait_s"]
    lat = [v if np.isfinite(v) else worst for v in lat]
    st["sample"] = [(lo + j, m[j]) for lo, m in kept.values()
                    for j in range(m.shape[0])]
    rec = {"kind": "requests", "calls": done, "frames": done * f,
           "seconds": w.seconds, "attempted": n, "failed": failed,
           "e2e": {"request_p95_ms": p95(lat) * 1e3}, "latency_s": lat,
           "work": conv_work(ctx.cfg, mix["session_batch"], train=False)}
    if ctx.trace:
        from benchmark.trace import kernel_classes
        rec["summary"] = w.summary(kernel_classes(ctx.bench_dir))
    return rec


def check(ctx, st, rec) -> dict:
    st.pop("conns").stop()
    serve.free_program(st)
    return serve.judge_sample(ctx, st["pool"], st["sample"])
