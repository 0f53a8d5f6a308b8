"""Checkpoints: a pickle-free npz of flattened trees
(``onet_tpu/core/checkpoint.py``).

The file format is the JAX package's, key for key, so either package
resumes the other's files: ``p:<path>`` params, ``s:<path>`` BatchNorm
state, the Adam state as ``o:.count``, ``o:.mu/<path>`` and
``o:.nu/<path>`` (the leading dot is what the JAX package's flattening
makes of optax's named-tuple fields), ``__epoch__`` and ``__meta__`` (a
JSON dict). Paths join dict keys with "/", e.g. ``p:top/inc/conv1/w``.

The reference saves ``{"net": state_dict, "epoch": int}`` at the final
epoch and epoch 300; the drivers keep those save points and the
reference's date-hour file mark.

The port's train step updates params and Adam state in place, so every
save copies them to the host (synchronized) before it returns; only the
file I/O runs later, on the writer thread.
"""

from __future__ import annotations

import glob
import json
import os
import threading
from datetime import datetime
from typing import Dict

import numpy as np
import torch

from onet_tpu_torch.core.bridge import (TORCH_EXTS, import_torch_checkpoint,
                                        load_onet_npz)
from onet_tpu_torch.models.unet import tree_leaves


def _children(tree):
    """(name, child) pairs of a dict (sorted keys) or a list (indices):
    the path segments the JAX package's ``tree_flatten_with_path`` gives
    (a dict key, a list index)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), t) for i, t in enumerate(tree)]


def _flatten(tree, prefix: str, path: str = "") -> Dict[str, np.ndarray]:
    """{prefix + "a/b/0/c": host copy of the leaf}: the leaves copied to
    the host, synchronized, into memory no later step can write."""
    if isinstance(tree, (dict, list)):
        flat = {}
        for k, child in _children(tree):
            flat.update(_flatten(child, prefix,
                                 f"{path}/{k}" if path else k))
        return flat
    return {prefix + path: tree.detach().to("cpu", copy=True).numpy()}


def _unflatten(template, flat: Dict[str, np.ndarray], prefix: str,
               path: str = ""):
    if isinstance(template, (dict, list)):
        built = {k: _unflatten(child, flat, prefix,
                               f"{path}/{k}" if path else k)
                 for k, child in _children(template)}
        if isinstance(template, list):
            return [built[str(i)] for i in range(len(template))]
        return {k: built[str(k)] for k in template}
    key = prefix + path
    if key not in flat:
        raise KeyError(
            f"checkpoint has no '{key}' — its parameter tree does not "
            "match the requested model (a checkpoint trained with a "
            "different --arch, --base-channels or --in-channels? "
            "Note serving/quantization support the vanilla conv U-Net "
            "only.)")
    got = flat[key]
    want_shape = tuple(template.shape)
    if tuple(got.shape) != want_shape:
        raise ValueError(
            f"checkpoint '{key}' has shape {tuple(got.shape)} but the "
            f"requested model wants {want_shape} — trained with a "
            "different --base-channels/--in-channels/arch geometry?")
    return torch.from_numpy(np.array(got)).to(template.device)


def _opt_tree(opt_state):
    """The Adam state {count, mu, nu} under the JAX file's field names."""
    return {"." + k: v for k, v in opt_state.items()}


def datehour_mark() -> str:
    now = datetime.now()
    return "%04d_%02d%02d_%02d" % (now.year, now.month, now.day, now.hour)


def save_checkpoint(path: str, params, bn_state, epoch: int, opt_state=None,
                    meta: dict = None):
    """Crash-safe save: write a temp file in the target directory, fsync,
    then rename it over the final name, so a process killed mid-write
    never leaves a truncated npz there.

    ``opt_state`` (optional) stores the Adam state under 'o:' so a resumed
    run keeps its moments and step count; ``meta`` (optional) a small JSON
    dict (the model family and its geometry, ``models/arch.py``) under
    '__meta__', read back by ``read_checkpoint_meta``."""
    _write_npz_atomic(path, _flat_record(params, bn_state, epoch, opt_state,
                                         meta))


def _flat_record(params, bn_state, epoch, opt_state=None, meta=None):
    """The host-side flat dict of one checkpoint. Every leaf is copied to
    the host here, so the caller may run the next (in-place) step as soon
    as this returns."""
    flat = {"__epoch__": np.asarray(epoch)}
    flat.update(_flatten(params, "p:"))
    flat.update(_flatten(bn_state, "s:"))
    if opt_state is not None:
        flat.update(_flatten(_opt_tree(opt_state), "o:"))
    if meta:
        flat["__meta__"] = np.asarray(json.dumps(meta))
    return flat


def _write_npz_atomic(path: str, flat):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class AsyncCheckpointWriter:
    """Overlap checkpoint file I/O with training.

    ``save()`` copies the tensors to the host before it returns (the train
    step updates them in place right after) and then serializes and
    renames on a background thread, running autosave rotation there too,
    so the train loop pays only the copy. At most one write is in flight:
    a second ``save()`` first joins the previous one. ``wait()`` joins and
    re-raises any error of the writer thread; drivers call it before
    returning so a failed save cannot pass silently."""

    def __init__(self):
        self._thread = None
        self._err = None

    def save(self, path: str, params, bn_state, epoch: int, opt_state=None,
             meta: dict = None, rotate: tuple = None):
        """``rotate=(out_root, keep, pattern)`` runs rotate_checkpoints
        after the write completes, in the writer thread."""
        self.wait()
        flat = _flat_record(params, bn_state, epoch, opt_state, meta)

        def write():
            try:
                _write_npz_atomic(path, flat)
                if rotate is not None:
                    out_root, keep, pattern = rotate
                    rotate_checkpoints(out_root, keep=keep, pattern=pattern)
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                self._err = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def read_checkpoint_meta(path: str) -> dict:
    """The '__meta__' dict stored by save_checkpoint, or {} for files
    without one (older npz files, reference torch checkpoints)."""
    if not path.endswith(".npz"):
        return {}
    with np.load(path) as z:
        if "__meta__" not in z.files:
            return {}
        return json.loads(str(z["__meta__"]))


def rotate_checkpoints(out_root: str, keep: int = 3,
                       pattern: str = "*.npz") -> list:
    """Keep the newest ``keep`` checkpoints matching ``pattern`` under
    ``out_root`` (by mtime) and delete the rest; returns the deleted paths.

    Callers MUST scope ``pattern`` to their own autosave namespace (e.g.
    ``f"{model_name}_autosave_*.npz"``): the default ``*.npz`` matches
    every checkpoint in the directory, milestones included."""
    hits = sorted(glob.glob(os.path.join(out_root, pattern)),
                  key=os.path.getmtime)
    doomed = hits[:-keep] if keep > 0 else hits
    for p in doomed:
        os.remove(p)
    return doomed


def latest_checkpoint(out_root: str, pattern: str = "*.npz"):
    """The newest checkpoint under ``out_root`` (mtime order), or None:
    the auto-resume hook."""
    hits = sorted(glob.glob(os.path.join(out_root, pattern)),
                  key=os.path.getmtime)
    return hits[-1] if hits else None


def load_checkpoint(path: str, params_template, state_template,
                    opt_template=None):
    """Returns (params, bn_state, epoch), or with ``opt_template``
    (params, bn_state, epoch, opt_state_or_None): None for a checkpoint
    without optimizer state (the caller then says that Adam restarts).
    The templates give the trees' structure, shapes and device; the
    arrays keep the file's bits.

    Reference torch checkpoints (``.pt/.pth/.pytorch``) load through
    ``core/bridge.py``."""
    if path.endswith(TORCH_EXTS):
        share = "down" not in params_template
        dev = tree_leaves(params_template)[0].device
        params, bn_state, epoch = import_torch_checkpoint(
            path, weight_share=share, device=dev)
        for got, want, name in ((params, params_template, "params"),
                                (bn_state, state_template, "bn_state")):
            gs = [tuple(x.shape) for x in tree_leaves(got)]
            ws = [tuple(x.shape) for x in tree_leaves(want)]
            if gs != ws:
                raise ValueError(
                    f"{path}: imported {name} shapes do not match the "
                    f"requested model (got first-diff "
                    f"{next((a, b) for a, b in zip(gs, ws) if a != b)}); "
                    "check --base-channels/--in-channels")
        if opt_template is None:
            return params, bn_state, epoch
        return params, bn_state, epoch, None
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = _unflatten(params_template, flat, "p:")
    bn_state = _unflatten(state_template, flat, "s:")
    epoch = int(flat["__epoch__"])
    if opt_template is None:
        return params, bn_state, epoch
    if not any(k.startswith("o:") for k in flat):
        return params, bn_state, epoch, None
    opt = _unflatten(_opt_tree(opt_template), flat, "o:")
    return params, bn_state, epoch, {k[1:]: v for k, v in opt.items()}


def load_arch_auto(path: str, device=None):
    """Load a checkpoint by its own '__meta__' (meta-less files resolve to
    the vanilla conv U-Net). Returns (arch, params, bn_state, epoch).
    Another family (``swin``, ``convnext``, ``transunet``) is built from
    the file's meta (its geometry, input channels and twin-ness) and then
    loaded into, key for key."""
    from onet_tpu_torch.models.arch import arch_from_meta

    meta = read_checkpoint_meta(path)
    arch = arch_from_meta(meta)
    if arch.vanilla:
        params, bn_state, epoch = load_onet_auto(path, device)
        return arch, params, bn_state, epoch
    params, bn_state = arch.init(
        torch.Generator().manual_seed(0), meta.get("in_channels", 1),
        weight_share=meta.get("weight_share", True), device=device)
    params, bn_state, epoch = load_checkpoint(path, params, bn_state)
    return arch, params, bn_state, epoch


def load_onet_auto(path: str, device=None):
    """Load an Onet checkpoint, its width, input channels and twin-ness
    read from the file itself (npz shapes, or the reference state_dict's
    own keys). Returns (params, bn_state, epoch) on ``device``."""
    if path.endswith(TORCH_EXTS):
        return import_torch_checkpoint(path, device=device)
    return load_onet_npz(path, device)
