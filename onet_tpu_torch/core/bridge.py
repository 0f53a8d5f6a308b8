"""Weights carried into the port.

* ``from_jax_numpy``: the JAX package's ``(params, bn_state)`` trees, as
  numpy, to the port's dicts: same keys, same HWIO layout, bit-exact.
* ``load_onet_npz``: the JAX checkpoint format (``p:``/``s:`` flat keys,
  ``onet_tpu/core/checkpoint.py``), with the width, input channels and
  twin-ness read from the file's own shapes.
* ``import_torch_state``: the reference ``state_dict`` schema (``topu.*`` /
  ``dwnu.*``, OIHW; ``onet_tpu/core/torch_import.py``), so reference
  ``.pytorch`` weights serve too.
* ``adam_state_from_jax``: the JAX ``adam_init``/``adam_update`` state
  (optax's count, mu, nu, as numpy) to the port's Adam state, so a run can
  start both frameworks from the same params, BN state and optimizer state.

Every loader puts the tensors on ``device``: the card by default, raising
without one.
"""

from __future__ import annotations

import numpy as np
import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.models.unet import _channels, tree_map


def _tensor(a, dev) -> torch.Tensor:
    """numpy / tensor -> float32 tensor on ``dev`` that owns its memory."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)


def from_jax_numpy(params, state, device=None):
    """JAX (params, bn_state) trees with numpy (or array-like) leaves ->
    the port's (params, state) dicts on ``device``."""
    dev = resolve_device(device)
    conv = lambda a: _tensor(a, dev)   # noqa: E731
    return tree_map(conv, params), tree_map(conv, state)


def adam_state_from_jax(count, mu, nu, device=None):
    """optax ``ScaleByAdamState`` fields (count: int scalar; mu, nu: trees
    like the params, numpy or array-like leaves) -> the port's Adam state
    on ``device`` (``train/optim.py``)."""
    dev = resolve_device(device)
    conv = lambda a: _tensor(a, dev)   # noqa: E731
    return {"count": torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                                  device=dev),
            "mu": tree_map(conv, mu), "nu": tree_map(conv, nu)}


# ---------------------------------------------------------------------------
# the JAX npz checkpoint
# ---------------------------------------------------------------------------

def _unet_shapes(cin: int, base: int):
    """{flat key: shape} of one U-Net's params ('p') and BN state ('s')."""
    c = _channels(base)
    out = {}

    def dconv(prefix, ci, co):
        out[f"p:{prefix}/conv1/w"] = (3, 3, ci, co)
        out[f"p:{prefix}/conv2/w"] = (3, 3, co, co)
        for bn in ("bn1", "bn2"):
            out[f"p:{prefix}/{bn}/scale"] = (co,)
            out[f"p:{prefix}/{bn}/bias"] = (co,)
            out[f"s:{prefix}/{bn}/mean"] = (co,)
            out[f"s:{prefix}/{bn}/var"] = (co,)

    dconv("inc", cin, c[0])
    for i in range(4):
        dconv(f"down{i + 1}", c[i], c[i + 1])
    ups_in = (c[4], c[3], c[2], c[1])
    ups_out = (c[3], c[2], c[1], c[0])
    for i in range(4):
        out[f"p:up{i + 1}/up/w"] = (2, 2, ups_in[i], ups_in[i] // 2)
        out[f"p:up{i + 1}/up/b"] = (ups_in[i] // 2,)
        dconv(f"up{i + 1}/conv", ups_in[i], ups_out[i])
    return out


def _nest(flat: dict, prefix: str, dev):
    tree = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _tensor(val, dev)
    return tree


def load_onet_npz(path: str, device=None):
    """Load a JAX-package Onet checkpoint (``.npz``). Returns
    (params, state, epoch). Raises on a missing key or a wrong shape."""
    dev = resolve_device(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    _, _, cin, base = flat["p:top/inc/conv1/w"].shape
    branches = ["top"] + (["down"] if any(k.startswith("p:down/")
                                          for k in flat) else [])
    for br in branches:
        for key, shape in _unet_shapes(cin, base).items():
            full = f"{key[:2]}{br}/{key[2:]}"
            if full not in flat:
                raise KeyError(f"{path}: checkpoint has no '{full}'")
            if tuple(flat[full].shape) != shape:
                raise ValueError(f"{path}: '{full}' has shape "
                                 f"{tuple(flat[full].shape)}, want {shape}")
    return (_nest(flat, "p:", dev), _nest(flat, "s:", dev),
            int(flat.get("__epoch__", 0)))


# ---------------------------------------------------------------------------
# the reference state_dict schema
# ---------------------------------------------------------------------------

def _import_double_conv(sd, prefix: str, dev):
    """One DoubleConv at torch ``prefix`` (ending in 'double_conv.')."""
    t = lambda k: _tensor(sd[prefix + k], dev)   # noqa: E731
    p = {"conv1": {"w": t("0.weight").permute(2, 3, 1, 0).contiguous()},
         "bn1": {"scale": t("1.weight"), "bias": t("1.bias")},
         "conv2": {"w": t("3.weight").permute(2, 3, 1, 0).contiguous()},
         "bn2": {"scale": t("4.weight"), "bias": t("4.bias")}}
    s = {"bn1": {"mean": t("1.running_mean"), "var": t("1.running_var")},
         "bn2": {"mean": t("4.running_mean"), "var": t("4.running_var")}}
    return p, s


def _import_unet(sd, unet: str, dev):
    params, state = {}, {}
    params["inc"], state["inc"] = _import_double_conv(
        sd, f"{unet}.inc.double_conv.", dev)
    for i in range(1, 5):
        params[f"down{i}"], state[f"down{i}"] = _import_double_conv(
            sd, f"{unet}.down{i}.maxpool_conv.1.double_conv.", dev)
    for i in range(1, 5):
        cp, cs = _import_double_conv(sd, f"{unet}.up{i}.conv.double_conv.",
                                     dev)
        params[f"up{i}"] = {
            "up": {"w": _tensor(sd[f"{unet}.up{i}.up.weight"], dev)
                   .permute(2, 3, 0, 1).contiguous(),
                   "b": _tensor(sd[f"{unet}.up{i}.up.bias"], dev)},
            "conv": cp}
        state[f"up{i}"] = {"conv": cs}
    return params, state


def import_torch_state(sd, *, weight_share=None, device=None):
    """Reference Onet ``state_dict`` -> (params, state) on ``device``.

    ``weight_share=None`` auto-detects: the weight-shared reference model
    registers the same UNet under ``topu`` and ``dwnu``, so the branches
    compare equal; a twin checkpoint yields a ``{"top", "down"}`` tree."""
    dev = resolve_device(device)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    probe = "inc.double_conv.0.weight"
    if f"topu.{probe}" not in sd:
        raise KeyError(
            "not a reference Onet state_dict: missing 'topu.%s' "
            "(keys look like: %s)" % (probe, sorted(sd)[:3]))
    if weight_share is None:
        weight_share = (f"dwnu.{probe}" not in sd or np.array_equal(
            _tensor(sd[f"topu.{probe}"], "cpu").numpy(),
            _tensor(sd[f"dwnu.{probe}"], "cpu").numpy()))
    pt, st = _import_unet(sd, "topu", dev)
    if weight_share:
        return {"top": pt}, {"top": st}
    pd, sdn = _import_unet(sd, "dwnu", dev)
    return {"top": pt, "down": pd}, {"top": st, "down": sdn}
