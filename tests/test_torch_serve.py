"""The port's HTTP serving daemon (onet_tpu_torch/serve/http.py) on the CPU
with a base-8 model: the real HTTP stack on an ephemeral localhost port."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from onet_tpu_torch.core.policy import DEFAULT
from onet_tpu_torch.models.infer import fold_onet, onet_infer
from onet_tpu_torch.models.onet import onet_init, predict_label
from onet_tpu_torch.serve.http import (
    ServingSession, canonicalize, start_server)


def _step(folded, xb):
    return onet_infer(folded, xb, policy=DEFAULT)


@pytest.fixture(scope="module")
def served():
    params, state = onet_init(torch.Generator().manual_seed(4), 1, base=8,
                              device="cpu")
    folded = fold_onet(params, state)
    sess = ServingSession(_step, folded, batch=3, in_channels=1,
                          mode="fp32", model_name="tiny", input_hw=(32, 32),
                          device="cpu")
    sess.warmup()
    httpd = start_server(sess, 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield sess, folded, url
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=10)
    assert not th.is_alive()


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read())), dict(resp.headers)


def _get_json(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def test_post_segment_matches_direct_infer(served):
    sess, folded, url = served
    imgs = np.random.default_rng(0).uniform(0, 1, (5, 32, 32, 1)).astype(
        np.float32)
    masks, headers = _post(url + "/segment", imgs)
    assert masks.shape == (5, 32, 32) and masks.dtype == np.uint8
    assert headers["X-Onet-Frames"] == "5"
    s, _ = onet_infer(folded, torch.tensor(imgs), policy=DEFAULT)
    np.testing.assert_array_equal(masks, predict_label(s).numpy())
    stats = _get_json(url + "/stats")
    assert stats["requests"] >= 1 and stats["frames"] >= 5
    assert stats["device_ms"]["p50"] > 0


def test_stats_reads_the_spans(served):
    """/stats keeps its five keys and adds each span's percentiles and the
    counters; a request's X-Onet-Device-Ms is its time under the step
    lock (step, cast, device wait, labels out), the lock's wait left
    out."""
    from onet_tpu_torch.utils import profiling

    sess, _, url = served
    imgs = np.random.default_rng(2).uniform(0, 1, (4, 32, 32, 1)).astype(
        np.float32)
    since = profiling.mark()
    _, headers = _post(url + "/segment", imgs)
    stats = _get_json(url + "/stats")
    assert {"requests", "frames", "errors", "device_ms", "total_ms",
            "spans_ms", "steps", "padded_frames", "labels_staged",
            "staging_allocs"} <= set(stats)
    for name in ("http.request", "http.read", "http.write",
                 "session.segment", "session.copy_in", "session.lock_wait",
                 "session.step", "session.device_wait", "session.labels_out",
                 "session.cast"):
        row = stats["spans_ms"][name]
        assert set(row) == {"p50", "p95", "max", "count"} and row["count"] >= 1
    assert stats["steps"] >= 2 and stats["padded_frames"] >= 2
    assert stats["labels_staged"] == stats["steps"]
    assert stats["staging_allocs"] >= 1
    recs = profiling.spans(since)
    req = [r for r in recs if r.name == "http.request"]
    assert len(req) == 1
    mine = [r for r in recs if r.request == req[0].id]
    assert {r.name for r in mine} >= {"http.read", "http.write",
                                      "session.segment"}
    under = sum(r.ms for r in mine if r.name in (
        "session.step", "session.cast", "session.device_wait",
        "session.labels_out"))
    assert float(headers["X-Onet-Device-Ms"]) == pytest.approx(under,
                                                               abs=0.006)
    assert 0 < stats["device_ms"]["p50"] <= stats["total_ms"]["max"]


def test_normalize_query_applies_minmax(served):
    sess, folded, url = served
    raw = np.random.default_rng(1).uniform(3, 9, (2, 32, 32)).astype(
        np.float32)
    masks, _ = _post(url + "/segment?normalize=1", raw)
    x = torch.tensor(raw[..., None])
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    s, _ = onet_infer(folded, (x - lo) / (hi - lo + np.spacing(1.0)),
                      policy=DEFAULT)
    np.testing.assert_array_equal(masks, predict_label(s).numpy())


def test_health_and_errors(served):
    sess, _, url = served
    health = _get_json(url + "/healthz")
    assert health["status"] == "ok" and health["batch"] == 3
    assert health["input_hw"] == [32, 32] and health["tile"] is None
    errors = sess.errors
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/segment?scene=1", np.zeros((1, 32, 32), np.float32))
    assert e.value.code == 400
    assert "without --tile" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/nope", np.zeros((1, 32, 32), np.float32))
    assert e.value.code == 404
    assert sess.errors == errors + 1          # only the 400 counts
    with pytest.raises(urllib.error.HTTPError) as e:
        _get_json(url + "/missing")
    assert e.value.code == 404


def test_canonicalize_shapes():
    for shape in [(16, 16), (16, 16, 1), (2, 16, 16), (2, 16, 16, 1)]:
        out = canonicalize(np.zeros(shape, np.float32), 1)
        assert out.ndim == 4 and out.shape[-1] == 1
    assert canonicalize(np.zeros((16, 16, 3), np.float32), 3).shape == (
        1, 16, 16, 3)
    with pytest.raises(ValueError):
        canonicalize(np.zeros((2, 16, 16, 3), np.float32), 1)
    with pytest.raises(ValueError):
        canonicalize(np.array(["a"]), 1)
