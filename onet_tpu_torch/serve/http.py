"""HTTP serving daemon with the model resident on the card
(``onet_tpu/serve/http.py``).

    POST /segment   body = a numpy ``.npy`` payload, float imagery in [0, 1]:
                    [H, W], [H, W, C], [B, H, W] or [B, H, W, C].
                    Response = ``.npy`` uint8 masks [B, H, W]. Query params:
                      ?normalize=1  per-frame min-max first
                      ?scene=1      each frame is a scene of any size,
                                    served through the tiled path
                                    (``serve/tiles.py``); only when the
                                    session has a ``tile``, else 400
    GET  /healthz   JSON: model, mode, batch, warm state
    GET  /stats     JSON: request/frame/error counts, device and
                    end-to-end latency percentiles of the requests, each
                    span's percentiles (``spans_ms``), steps and padded
                    frames

Requests of any batch size run in fixed ``batch``-sized chunks (the last
one padded); scenes run in batches of ``tile + 2*halo`` windows, one shape
too. The device step is serialized by a lock; the HTTP layer is a
``ThreadingHTTPServer`` so health and stats probes never wait behind it.

A batch's labels leave the card as uint8: the step's labels are narrowed
on the device, copied into one host staging buffer that the session owns
(pinned on a CUDA device, so the copy runs at DMA speed; made on first use
and grown only when a batch needs more bytes) and from there into the
call's masks, which are allocated once a call and never alias the buffer.

The session and the handler time their parts as spans
(``utils/profiling.py``), one set a batch: ``session.copy_in`` (frames to
the device), ``session.normalize``, ``session.lock_wait`` (acquiring the
step lock), ``session.step`` (launching the step), ``session.cast``
(launching the labels' narrowing to uint8), ``session.device_wait``
(until the step is done), ``session.labels_out`` (labels through the
staging buffer into the call's masks), under ``session.segment`` a call;
a scene's ``session.tiled`` and ``session.cast``; ``http.read``,
``http.write`` under ``http.request``. Counters: ``steps``,
``padded_frames`` (frames added to fill a batch), ``labels_staged``
(batches whose labels came back through the staging buffer),
``staging_allocs`` (times the buffer was made or grown).
"""

from __future__ import annotations

import collections
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.ops.normalize import minmax_per_frame
from onet_tpu_torch.serve.tiles import infer_tiled
from onet_tpu_torch.utils.profiling import (RING, count, counters,
                                            percentiles, span, spans,
                                            summarize)

# spans under the step lock, its wait left out: a request's device time
UNDER_LOCK = ("session.step", "session.cast", "session.device_wait",
              "session.labels_out", "session.tiled")


class ServingSession:
    """Owns the warm serving step and its statistics.

    ``step(model_arg, x)`` takes an NHWC float32 batch on ``device`` and
    returns (S, labels), as ``onet_infer`` does. With ``tile`` the session
    also serves scenes (``segment_scenes``) in windows of
    ``tile + 2*halo``."""

    def __init__(self, step, model_arg, *, batch: int, in_channels: int,
                 mode: str = "bf16", model_name: str = "", tile: int = 0,
                 halo: int = 32, input_hw=None, device=None):
        self.step = step
        self.model_arg = model_arg
        self.batch = int(batch)
        self.in_channels = int(in_channels)
        self.mode = mode
        self.model_name = model_name
        self.tile = int(tile)
        self.halo = int(halo)
        self.input_hw = input_hw          # (H, W) the step was warmed at
        self.device = resolve_device(device)
        self.warm = False
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.frames = 0
        self.errors = 0
        # the request ids of this session's calls, to find its spans
        self._served = collections.deque(maxlen=RING)
        self._staging = None              # uint8 host buffer of the labels
        self.started = time.time()

    # -- device work --------------------------------------------------------

    def _copy_in(self, a: np.ndarray) -> torch.Tensor:
        with span("session.copy_in"):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _acquire(self):
        with span("session.lock_wait"):
            self._lock.acquire()

    def _staged(self, nbytes: int) -> torch.Tensor:
        """The first ``nbytes`` of the staging buffer, which is made or
        grown first where it is too small. Called under the step lock."""
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = torch.empty(
                nbytes, dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
            count("staging_allocs")
        return self._staging[:nbytes]

    def _run(self, xb: torch.Tensor, out=None):
        """ms under the step lock, its wait left out. The batch's labels
        come back as uint8; the first ``len(out)`` frames' go into ``out``
        (a [k, H, W] uint8 array)."""
        self._acquire()
        try:
            with torch.inference_mode():
                with span("session.step") as st:
                    _, m = self.step(self.model_arg, xb)
                with span("session.cast") as ca:
                    m = m.to(torch.uint8)
                with span("session.device_wait") as dw:
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
                with span("session.labels_out") as lo:
                    staged = self._staged(m.numel()).view(m.shape)
                    staged.copy_(m, non_blocking=True)
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
                    if out is not None:
                        np.copyto(out, staged[:len(out)].numpy())
        finally:
            self._lock.release()
        count("steps")
        count("labels_staged")
        return st.ms + ca.ms + dw.ms + lo.ms

    def warmup(self, hw=None):
        """Run the step once (kernel builds, cuDNN plans) so the first
        request is served at device speed; at the window size with a
        ``tile``."""
        if self.tile:
            hw = (self.tile + 2 * self.halo,) * 2
        hw = hw or self.input_hw or (224, 224)
        self._run(torch.zeros((self.batch, hw[0], hw[1], self.in_channels),
                              device=self.device))
        self.input_hw = tuple(hw)
        self.warm = True

    def segment(self, imgs: np.ndarray, normalize: bool = False):
        """[B, H, W, C] float -> ([B, H, W] uint8 masks, device ms): the
        time under the step lock, its wait left out. Each batch writes its
        real frames' labels into the masks; a padded frame's are not
        copied."""
        with span("session.segment") as call:
            self._served.append(call.request)
            n = imgs.shape[0]
            pad = (-n) % self.batch
            if pad:
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad,
                                                       axis=0)])
                count("padded_frames", pad)
            masks = np.empty((n,) + imgs.shape[1:3], np.uint8)
            dev_ms = 0.0
            for i in range(0, imgs.shape[0], self.batch):
                xb = self._copy_in(imgs[i:i + self.batch])
                if normalize:
                    with span("session.normalize"):
                        xb = minmax_per_frame(xb)
                dev_ms += self._run(xb, masks[i:i + self.batch])
            return masks, dev_ms

    def segment_scenes(self, imgs: np.ndarray, normalize: bool = False):
        """[B, H, W, C] scenes -> ([B, H, W] uint8 masks, device ms): each
        scene goes to the device once and through ``infer_tiled`` under
        the step lock."""
        if not self.tile:
            raise ValueError("daemon started without --tile; "
                             "?scene=1 unavailable")
        with span("session.segment") as call:
            self._served.append(call.request)
            out, dev_ms = [], 0.0
            for scene in imgs:
                x = self._copy_in(scene)
                if normalize:
                    with span("session.normalize"):
                        x = minmax_per_frame(x[None])[0]
                self._acquire()
                try:
                    with span("session.tiled") as sp:
                        m = infer_tiled(self.step, self.model_arg, x,
                                        tile=self.tile, halo=self.halo,
                                        batch=self.batch, device=self.device)
                    with span("session.cast") as ca:
                        out.append(m[None].astype(np.uint8))
                finally:
                    self._lock.release()
                dev_ms += sp.ms + ca.ms
            return np.concatenate(out), dev_ms

    # -- bookkeeping ---------------------------------------------------------

    def record(self, frames: int):
        with self._stats_lock:
            self.requests += 1
            self.frames += frames

    def record_error(self):
        with self._stats_lock:
            self.errors += 1

    def health(self) -> dict:
        return {"status": "ok" if self.warm else "warming",
                "model": self.model_name, "mode": self.mode,
                "batch": self.batch, "in_channels": self.in_channels,
                "tile": self.tile or None, "device": str(self.device),
                "input_hw": list(self.input_hw) if self.input_hw else None,
                "uptime_s": round(time.time() - self.started, 1)}

    def stats(self) -> dict:
        """Counts; ``device_ms`` (time under the step lock, its wait left
        out) and ``total_ms`` (``http.request``) over the session's
        answered requests in the span ring, ``spans_ms`` over all its
        spans there; ``steps``, ``padded_frames``, ``labels_staged`` and
        ``staging_allocs`` since the process started."""
        mine = set(self._served)
        recs = [r for r in spans() if r.request in mine]
        dev, total = {}, {}
        for r in recs:
            if r.name in UNDER_LOCK:
                dev[r.request] = dev.get(r.request, 0.0) + r.ms
            elif r.name == "http.request":
                total[r.request] = r.ms
        answered = {r.request for r in recs if r.name == "http.write"}
        c = counters()
        with self._stats_lock:
            out = {"requests": self.requests, "frames": self.frames,
                   "errors": self.errors}
        out.update(
            device_ms=percentiles(
                [dev.get(q, 0.0) for q in total if q in answered], 2),
            total_ms=percentiles(
                [ms for q, ms in total.items() if q in answered], 2),
            spans_ms=summarize(recs), steps=c.get("steps", 0),
            padded_frames=c.get("padded_frames", 0),
            labels_staged=c.get("labels_staged", 0),
            staging_allocs=c.get("staging_allocs", 0))
        return out


def canonicalize(arr: np.ndarray, in_channels: int) -> np.ndarray:
    """Any of [H,W] / [H,W,C] / [B,H,W] / [B,H,W,C] -> [B,H,W,C] float32."""
    a = np.asarray(arr)
    if not np.issubdtype(a.dtype, np.number):
        raise ValueError(f"non-numeric payload dtype {a.dtype}")
    a = a.astype(np.float32)
    if a.ndim == 2:
        a = a[None, :, :, None]
    elif a.ndim == 3:
        # trailing channel dim vs leading batch dim: channels are small
        a = a[None] if a.shape[-1] == in_channels else a[..., None]
    elif a.ndim != 4:
        raise ValueError(f"expected 2-4 dims, got shape {a.shape}")
    if a.shape[-1] != in_channels:
        raise ValueError(f"expected {in_channels} channel(s), "
                         f"got shape {tuple(a.shape)}")
    return a


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def make_handler(session: ServingSession):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: N802 — quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, session.health())
            elif path == "/stats":
                self._json(200, session.stats())
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/segment":
                self._json(404, {"error": f"unknown path {url.path}"})
                return
            q = parse_qs(url.query)
            normalize = q.get("normalize", ["0"])[0] not in ("0", "")
            scene = q.get("scene", ["0"])[0] not in ("0", "")
            with span("http.request"):
                try:
                    with span("http.read"):
                        n = int(self.headers.get("Content-Length", 0))
                        payload = io.BytesIO(self.rfile.read(n))
                        imgs = canonicalize(
                            np.load(payload, allow_pickle=False),
                            session.in_channels)
                    if scene:
                        masks, dev_ms = session.segment_scenes(imgs,
                                                               normalize)
                    else:
                        masks, dev_ms = session.segment(imgs, normalize)
                except Exception as e:  # noqa: BLE001 — to the client
                    session.record_error()
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                session.record(masks.shape[0])
                with span("http.write"):
                    body = _npy_bytes(masks)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-npy")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Onet-Frames", str(masks.shape[0]))
                    self.send_header("X-Onet-Device-Ms", f"{dev_ms:.2f}")
                    self.send_header("X-Onet-Mode", session.mode)
                    self.end_headers()
                    self.wfile.write(body)

    return Handler


def start_server(session: ServingSession, port: int,
                 host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) and return the httpd; the caller drives
    ``serve_forever()`` or ``handle_request()``."""
    httpd = ThreadingHTTPServer((host, port), make_handler(session))
    httpd.daemon_threads = True
    return httpd
