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
    GET  /stats     JSON: request/frame counts, device + end-to-end latency
                    percentiles

Requests of any batch size run in fixed ``batch``-sized chunks (the last
one padded); scenes run in batches of ``tile + 2*halo`` windows, one shape
too. The device step is serialized by a lock; the HTTP layer is a
``ThreadingHTTPServer`` so health and stats probes never wait behind it.
"""

from __future__ import annotations

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
        self._lat_device_ms: list = []
        self._lat_total_ms: list = []
        self.started = time.time()

    # -- device work --------------------------------------------------------

    def _run(self, xb: torch.Tensor) -> np.ndarray:
        with self._lock, torch.inference_mode():
            _, m = self.step(self.model_arg, xb)
            return m.cpu().numpy()        # waits for the device

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
        """[B, H, W, C] float -> ([B, H, W] uint8 masks, device ms)."""
        n = imgs.shape[0]
        pad = (-n) % self.batch
        if pad:
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)])
        masks, dev_ms = [], 0.0
        for i in range(0, imgs.shape[0], self.batch):
            xb = torch.from_numpy(
                np.ascontiguousarray(imgs[i:i + self.batch])).to(self.device)
            if normalize:
                xb = minmax_per_frame(xb)
            t0 = time.perf_counter()
            m = self._run(xb)
            dev_ms += (time.perf_counter() - t0) * 1e3
            masks.append(m.astype(np.uint8))
        return np.concatenate(masks)[:n], dev_ms

    def segment_scenes(self, imgs: np.ndarray, normalize: bool = False):
        """[B, H, W, C] scenes -> ([B, H, W] uint8 masks, device ms): each
        scene goes to the device once and through ``infer_tiled`` under
        the step lock."""
        if not self.tile:
            raise ValueError("daemon started without --tile; "
                             "?scene=1 unavailable")
        out, dev_ms = [], 0.0
        for scene in imgs:
            x = torch.from_numpy(np.ascontiguousarray(scene)).to(self.device)
            if normalize:
                x = minmax_per_frame(x[None])[0]
            t0 = time.perf_counter()
            with self._lock:
                m = infer_tiled(self.step, self.model_arg, x, tile=self.tile,
                                halo=self.halo, batch=self.batch,
                                device=self.device)
            dev_ms += (time.perf_counter() - t0) * 1e3
            out.append(m[None].astype(np.uint8))
        return np.concatenate(out), dev_ms

    # -- bookkeeping ---------------------------------------------------------

    def record(self, frames: int, dev_ms: float, total_ms: float):
        with self._stats_lock:
            self.requests += 1
            self.frames += frames
            self._lat_device_ms.append(dev_ms)
            self._lat_total_ms.append(total_ms)
            if len(self._lat_total_ms) > 4096:     # bounded memory
                self._lat_device_ms = self._lat_device_ms[-2048:]
                self._lat_total_ms = self._lat_total_ms[-2048:]

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
        with self._stats_lock:
            dev = np.asarray(self._lat_device_ms, np.float64)
            tot = np.asarray(self._lat_total_ms, np.float64)

            def pct(a):
                if a.size == 0:
                    return None
                return {"p50": round(float(np.percentile(a, 50)), 2),
                        "p95": round(float(np.percentile(a, 95)), 2),
                        "max": round(float(a.max()), 2)}

            return {"requests": self.requests, "frames": self.frames,
                    "errors": self.errors,
                    "device_ms": pct(dev), "total_ms": pct(tot)}


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
            t_req = time.perf_counter()
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = io.BytesIO(self.rfile.read(n))
                imgs = canonicalize(np.load(payload, allow_pickle=False),
                                    session.in_channels)
                if scene:
                    masks, dev_ms = session.segment_scenes(imgs, normalize)
                else:
                    masks, dev_ms = session.segment(imgs, normalize)
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                session.record_error()
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            total_ms = (time.perf_counter() - t_req) * 1e3
            session.record(masks.shape[0], dev_ms, total_ms)
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
