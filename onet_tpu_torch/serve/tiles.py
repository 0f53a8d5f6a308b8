"""Tiled serving for scenes larger than one window
(``onet_tpu/serve/tiles.py``).

A full ZY-3 scene or a radar sweep is larger than the frames the model was
trained on. ``infer_tiled`` serves any [H, W, C] scene: context windows of
``tile + 2 * halo`` pixels run through the serving step in batches of one
shape, each window's emit region is cropped out, and the mask is
reassembled.

Windows are clamped inside the scene: a window near a border slides inward
so that the scene's border is the window's, and border pixels see the same
SAME-conv zero padding as whole-scene inference; interior pixels get at
least ``halo`` pixels of true context. Zero padding is added only when the
whole scene is smaller than one window. The last batch repeats its last
window, so every call has one shape.

The scene goes to the device once; the windows are sliced there and the
mask is assembled there, so a scene costs one host read (the JAX package
stacks the windows on the host and reads each batch back).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from onet_tpu_torch.core.device import resolve_device


def _plan(size: int, tile: int) -> list:
    """Emit-region start offsets covering [0, size): stride ``tile``, the
    last start clamped (overlapping pixels are emitted again, the same)."""
    if size <= tile:
        return [0]
    return list(range(0, size - tile, tile)) + [size - tile]


def infer_tiled(infer_fn, model_arg, scene, *, tile: int = 512,
                halo: int = 32, batch: int = 8, device=None) -> np.ndarray:
    """Run ``labels = infer_fn(model_arg, x)[1]`` over an [H, W, C] scene
    (numpy or a tensor) on ``device`` (default: the card; raises without
    one). Every call takes [batch, tile + 2*halo, tile + 2*halo, C]
    float32. Returns the [H, W] int32 mask."""
    dev = resolve_device(device)
    h, w, _ = scene.shape
    t, win = tile, tile + 2 * halo
    x = torch.as_tensor(scene).to(dev, torch.float32)
    ph, pw = max(win - h, 0), max(win - w, 0)
    if ph or pw:      # smaller than one window: zero-pad, as SAME convs do
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    sh, sw = x.shape[:2]

    coords = []
    for y in _plan(h, t):
        wy = min(max(y - halo, 0), sh - win)
        for xo in _plan(w, t):
            wx = min(max(xo - halo, 0), sw - win)
            coords.append((y, xo, wy, wx))

    out = torch.empty((h, w), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for i in range(0, len(coords), batch):
            part = coords[i:i + batch]
            part = part + [part[-1]] * (batch - len(part))   # one shape
            chunk = torch.stack([x[wy:wy + win, wx:wx + win]
                                 for _, _, wy, wx in part])
            labels = infer_fn(model_arg, chunk)[1]
            for j, (y, xo, wy, wx) in enumerate(coords[i:i + batch]):
                oy, ox = y - wy, xo - wx
                ey, ex = min(t, h - y), min(t, w - xo)
                out[y:y + ey, xo:xo + ex] = labels[j, oy:oy + ey, ox:ox + ex]
    return out.cpu().numpy()
