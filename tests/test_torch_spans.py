"""The span recorder (onet_tpu_torch/utils/profiling.py) and the spans of
the serving session (serve/http.py) on the CPU with a base-8 model:
nesting and request ids, the ring's bound, one span of each name a
batch, masks with and without a profiler, four threads at once, and the
ranges the spans leave in a Chrome trace on the profiler's clock."""

import json
import os
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from onet_tpu_torch.core.policy import DEFAULT
from onet_tpu_torch.models.infer import fold_onet, onet_infer
from onet_tpu_torch.models.onet import onet_init, predict_label
from onet_tpu_torch.serve.http import ServingSession
from onet_tpu_torch.utils import profiling as P

BATCH_SPANS = ("session.copy_in", "session.lock_wait", "session.step",
               "session.device_wait", "session.labels_out", "session.cast")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def session():
    params, state = onet_init(torch.Generator().manual_seed(4), 1, base=8,
                              device="cpu")
    folded = fold_onet(params, state)
    sess = ServingSession(lambda f, x: onet_infer(f, x, policy=DEFAULT),
                          folded, batch=3, in_channels=1, mode="fp32",
                          input_hw=(32, 32), device="cpu")
    sess.warmup()
    return sess, folded


def _frames(seed, n=5):
    return np.random.default_rng(seed).uniform(0, 1, (n, 32, 32, 1)).astype(
        np.float32)


def test_nesting_parent_and_request():
    since = P.mark()
    with P.span("a") as a:
        with P.span("b") as b:
            with P.span("c") as c:
                pass
            other = []
            th = threading.Thread(target=lambda: other.append(
                P.span("t").__enter__().__exit__(None, None, None)))
            th.start()
            th.join()
    with P.span("d") as d:
        pass
    recs = [r for r in P.spans(since) if r.name != "t"]
    assert [r.name for r in recs] == ["c", "b", "a", "d"]
    got = {r.name: r for r in recs}
    assert (got["a"].parent, got["b"].parent, got["c"].parent,
            got["d"].parent) == (None, a.id, b.id, None)
    assert {got[k].request for k in "abc"} == {a.id}
    assert got["d"].request == d.id and got["c"].id == c.id
    assert (got["a"].start <= got["b"].start <= got["c"].start
            <= got["c"].end <= got["b"].end <= got["a"].end)
    t = [r for r in P.spans(since) if r.name == "t"]
    assert len(t) == 1 and t[0].parent is None and t[0].request == t[0].id
    assert all(r.session is None for r in P.spans(since))


def test_ring_keeps_the_latest():
    since = P.mark()
    for i in range(P.RING + 10):
        with P.span(f"fill{i % 3}"):
            pass
    recs = P.spans()
    assert len(recs) == P.RING
    mine = P.spans(since)
    assert len(mine) == P.RING and mine[0].id == since + 11
    assert [r.id for r in mine] == sorted(r.id for r in mine)


@pytest.mark.parametrize("normalize", [False, True])
def test_one_span_of_each_name_per_batch(session, normalize):
    sess, _ = session
    before = P.counters()
    since = P.mark()
    masks, dev_ms = sess.segment(_frames(0), normalize=normalize)
    assert masks.shape == (5, 32, 32)
    recs = P.spans(since)
    names = Counter(r.name for r in recs)
    want = {k: 2 for k in BATCH_SPANS}
    want["session.segment"] = 1
    if normalize:
        want["session.normalize"] = 2
    assert dict(names) == want
    seg = [r for r in recs if r.name == "session.segment"][0]
    assert all(r.request == seg.id for r in recs)
    assert all(r.parent == seg.id for r in recs if r is not seg)
    under = sum(r.ms for r in recs if r.name in (
        "session.step", "session.cast", "session.device_wait",
        "session.labels_out"))
    assert dev_ms == pytest.approx(under) and dev_ms > 0
    after = P.counters()
    assert after["steps"] - before.get("steps", 0) == 2
    assert (after["padded_frames"] - before.get("padded_frames", 0)) == 1


@pytest.mark.parametrize("n", [6, 5])
def test_masks_are_the_steps_labels_as_uint8(session, n):
    """For a whole number of batches and a ragged tail: the masks are the
    step's labels on each padded batch, cast on the host as before, with
    the real frames' rows only, in memory of their own."""
    sess, folded = session
    imgs = _frames(5, n)
    masks, _ = sess.segment(imgs)
    padded = np.concatenate([imgs, np.repeat(imgs[-1:], (-n) % 3, axis=0)])
    want = np.concatenate([
        onet_infer(folded, torch.from_numpy(padded[i:i + 3]),
                   policy=DEFAULT)[1].numpy().astype(np.uint8)
        for i in range(0, len(padded), 3)])[:n]
    assert masks.shape == (n, 32, 32) and masks.dtype == np.uint8
    assert np.array_equal(masks, want)
    assert not np.shares_memory(masks, sess._staging.numpy())


def test_a_later_call_leaves_earlier_masks(session):
    sess, _ = session
    first, _ = sess.segment(_frames(6))
    kept = first.copy()
    second, _ = sess.segment(_frames(7))
    assert not np.array_equal(second, kept)
    assert np.array_equal(first, kept)


def test_staging_is_made_once_a_shape_and_grown_once(session):
    """A fresh session makes its staging buffer on its first batch, keeps
    it over calls of that shape and of a smaller one, and grows it once
    for a larger frame; every batch's labels come through it."""
    _, folded = session
    sess = ServingSession(lambda f, x: onet_infer(f, x, policy=DEFAULT),
                          folded, batch=2, in_channels=1, mode="fp32",
                          device="cpu")
    before = P.counters()

    def delta(name):
        return P.counters().get(name, 0) - before.get(name, 0)

    for _ in range(2):
        sess.segment(_frames(8, n=3))
    assert (delta("staging_allocs"), delta("labels_staged")) == (1, 4)
    sess.segment(_frames(8, n=1))
    assert delta("staging_allocs") == 1
    big = np.random.default_rng(9).uniform(0, 1, (2, 48, 48, 1)).astype(
        np.float32)
    masks, _ = sess.segment(big)
    assert masks.shape == (2, 48, 48)
    assert (delta("staging_allocs"), delta("labels_staged")) == (2, 6)
    assert delta("steps") == delta("labels_staged")
    assert sess._staging.numel() == 2 * 48 * 48


def test_masks_equal_with_and_without_profiler(session, tmp_path):
    sess, folded = session
    imgs = _frames(1)
    plain, _ = sess.segment(imgs)
    with P.trace(str(tmp_path)):
        traced, _ = sess.segment(imgs)
    assert np.array_equal(plain, traced)
    s, _ = onet_infer(folded, torch.tensor(imgs), policy=DEFAULT)
    assert np.array_equal(plain, predict_label(s).numpy())
    assert {r.name for r in P.profiled_spans()} >= set(BATCH_SPANS)


def test_four_threads_lose_no_record(session):
    sess, folded = session
    calls = 3
    imgs = [_frames(10 + k) for k in range(4)]
    out = {}
    since = P.mark()

    def run(k):
        out[k] = [sess.segment(imgs[k])[0] for _ in range(calls)]

    ths = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in ths)
    recs = P.spans(since)
    names = Counter(r.name for r in recs)
    assert names["session.segment"] == 4 * calls
    assert all(names[k] == 4 * calls * 2 for k in BATCH_SPANS)
    by_req = {}
    for r in recs:
        by_req.setdefault(r.request, Counter())[r.name] += 1
    assert len(by_req) == 4 * calls
    assert all(c == Counter({**{k: 2 for k in BATCH_SPANS},
                             "session.segment": 1})
               for c in by_req.values())
    for k in range(4):
        s, _ = onet_infer(folded, torch.tensor(imgs[k]), policy=DEFAULT)
        want = predict_label(s).numpy()
        assert all(np.array_equal(m, want) for m in out[k])


def test_threads_lose_no_span_or_count():
    """Sixteen threads switching every microsecond: every span reaches
    the ring and every count the counter."""
    threads, each = 16, 200
    assert 2 * threads * each <= P.RING
    before = P.counters().get("stress", 0)
    since = P.mark()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with P.span("stress.outer"):
                    with P.span("stress.inner"):
                        P.count("stress")

        ths = [threading.Thread(target=work) for _ in range(threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    recs = P.spans(since)
    assert len(recs) == 2 * threads * each
    assert len({r.id for r in recs}) == len(recs)
    outer = {r.id for r in recs if r.name == "stress.outer"}
    assert all(r.parent in outer and r.request == r.parent
               for r in recs if r.name == "stress.inner")
    assert P.counters()["stress"] - before == threads * each


def test_stats_count_only_the_sessions_own_spans(session):
    sess, folded = session
    other = ServingSession(lambda f, x: onet_infer(f, x, policy=DEFAULT),
                           folded, batch=2, in_channels=1, mode="fp32",
                           input_hw=(32, 32), device="cpu")
    sess.segment(_frames(3))
    before = sess.stats()["spans_ms"]
    other.segment(_frames(4, n=3))
    assert sess.stats()["spans_ms"] == before
    mine = other.stats()["spans_ms"]
    assert mine["session.segment"]["count"] == 1
    assert mine["session.step"]["count"] == 2


def test_trace_ranges_sit_on_the_records(session, tmp_path):
    """Each session.* span is a user_annotation range of the Chrome trace;
    mapped by ``trace_us``, a record's start and end lie within 50 us of
    its range's. A warm call first (a range's first use in a process is
    slower to open), then three calls: on a loaded host a thread switch
    inside a range's opening can delay one, so one call of the three has
    to hold every range within 50 us, and every call within 5 ms."""
    sess, _ = session
    imgs = _frames(2)
    marks = []
    with P.trace(str(tmp_path)):
        sess.segment(imgs)
        for _ in range(3):
            marks.append(P.mark())
            sess.segment(imgs, normalize=True)
    with open(os.path.join(str(tmp_path), P.TRACE_FILE)) as f:
        data = json.load(f)
    base = data["baseTimeNanoseconds"]
    ranges = {}
    for e in data["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ranges.setdefault(e["name"], []).append(e)
    recs = P.profiled_spans()
    gap = {}          # record id -> its larger distance to its range, us
    for name in {r.name for r in recs}:
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start)
        theirs = sorted(ranges.get(name, []), key=lambda e: e["ts"])
        assert len(theirs) == len(mine), name
        for r, e in zip(mine, theirs):
            gap[r.id] = max(abs(P.trace_us(r.start, base) - e["ts"]),
                            abs(P.trace_us(r.end, base) - e["ts"] - e["dur"]))
    worst = []
    for lo, hi in zip(marks, marks[1:] + [float("inf")]):
        call = [r for r in recs if lo < r.id < hi]
        assert {r.name for r in call} == set(BATCH_SPANS) | {
            "session.segment", "session.normalize"}
        worst.append(max(gap[r.id] for r in call))
    assert min(worst) <= 50 and max(worst) <= 5000, worst
