"""Weights carried into the port.

* ``from_jax_numpy``: the JAX package's ``(params, bn_state)`` trees, as
  numpy, to the port's dicts: same keys, same HWIO layout, bit-exact.
* ``load_onet_npz``: the JAX checkpoint format (``p:``/``s:`` flat keys,
  ``onet_tpu/core/checkpoint.py``), with the width, input channels and
  twin-ness read from the file's own shapes.
* ``import_torch_state``: the reference ``state_dict`` schema (``topu.*`` /
  ``dwnu.*``, OIHW; ``onet_tpu/core/torch_import.py``), so reference
  ``.pytorch`` weights serve too; ``import_torch_checkpoint`` reads such a
  file (its save schemas or a bare state_dict).
* ``export_torch_state`` / ``export_torch_checkpoint``: the way back, the
  port's trees as a reference ``state_dict`` and its ``{"net", "epoch"}``
  file, so a model trained on the card runs in the reference's scripts.
* ``adam_state_from_jax``: the JAX ``adam_init``/``adam_update`` state
  (optax's count, mu, nu, as numpy) to the port's Adam state, so a run can
  start both frameworks from the same params, BN state and optimizer state.
* ``quant_from_jax_numpy``: the JAX int8 serving parameters ``q``
  (``onet_tpu/models/quant.py::quantize_folded``, as numpy) to the port's
  (``models/quant.py``): the same keys, int8 codes as ``torch.int8``, the
  scales and biases float32, the float ``in_scale`` kept.

Every loader puts the tensors on ``device``: the card by default, raising
without one. The exporters take trees on any device and return CPU
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.models.unet import _channels, tree_map

TORCH_EXTS = (".pt", ".pth", ".pytorch")


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


def quant_from_jax_numpy(q, device=None):
    """JAX int8 serving parameters (``quantize_folded``'s dict, numpy or
    array-like leaves) -> the port's ``q`` on ``device``: int8 leaves stay
    int8, the rest become float32; ``in_scale`` stays a Python float."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return torch.tensor(a, device=dev)
        return torch.tensor(a.astype(np.float32), device=dev)

    out = {}
    for key, val in q.items():
        if key == "in_scale":
            out[key] = float(np.asarray(val))
        else:
            out[key] = {k: leaf(v) for k, v in val.items()}
    return out


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


def import_torch_checkpoint(path: str, *, weight_share=None, device=None):
    """Load a reference ``.pt/.pth/.pytorch`` checkpoint: ``{"net": sd,
    "epoch": e}`` (the simclutter driver's), ``{"net": sd, "save_epoch":
    e}`` (the zy3 driver's) or a bare state_dict. Only tensors and plain
    containers are unpickled. Returns (params, state, epoch) on
    ``device``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    epoch = 0
    if isinstance(blob, dict) and "net" in blob:
        epoch = int(blob.get("epoch", blob.get("save_epoch", 0)))
        sd = blob["net"]
    elif isinstance(blob, dict) and all("." in k for k in blob):
        sd = blob
    else:
        raise ValueError(
            f"{path}: expected a reference checkpoint dict with a 'net' "
            f"state_dict or a bare state_dict; got {type(blob).__name__} "
            f"with keys {list(blob)[:4] if isinstance(blob, dict) else ''}")
    params, state = import_torch_state(sd, weight_share=weight_share,
                                       device=device)
    return params, state, epoch


def _cpu(t: torch.Tensor) -> torch.Tensor:
    """A float32 CPU copy that owns its memory (off the card first)."""
    return t.detach().to("cpu", torch.float32, copy=True,
                         memory_format=torch.contiguous_format)


def _export_double_conv(sd, prefix: str, p, s):
    sd[prefix + "0.weight"] = _cpu(p["conv1"]["w"].permute(3, 2, 0, 1))
    sd[prefix + "1.weight"] = _cpu(p["bn1"]["scale"])
    sd[prefix + "1.bias"] = _cpu(p["bn1"]["bias"])
    sd[prefix + "1.running_mean"] = _cpu(s["bn1"]["mean"])
    sd[prefix + "1.running_var"] = _cpu(s["bn1"]["var"])
    sd[prefix + "3.weight"] = _cpu(p["conv2"]["w"].permute(3, 2, 0, 1))
    sd[prefix + "4.weight"] = _cpu(p["bn2"]["scale"])
    sd[prefix + "4.bias"] = _cpu(p["bn2"]["bias"])
    sd[prefix + "4.running_mean"] = _cpu(s["bn2"]["mean"])
    sd[prefix + "4.running_var"] = _cpu(s["bn2"]["var"])


def _export_unet(sd, unet: str, p, s):
    _export_double_conv(sd, f"{unet}.inc.double_conv.", p["inc"], s["inc"])
    for i in range(1, 5):
        _export_double_conv(sd, f"{unet}.down{i}.maxpool_conv.1.double_conv.",
                            p[f"down{i}"], s[f"down{i}"])
    for i in range(1, 5):
        up = p[f"up{i}"]["up"]
        sd[f"{unet}.up{i}.up.weight"] = _cpu(up["w"].permute(2, 3, 0, 1))
        sd[f"{unet}.up{i}.up.bias"] = _cpu(up["b"])
        _export_double_conv(sd, f"{unet}.up{i}.conv.double_conv.",
                            p[f"up{i}"]["conv"], s[f"up{i}"]["conv"])


def export_torch_state(params, state):
    """Inverse of :func:`import_torch_state`: the reference-schema
    state_dict of the port's trees, as float32 CPU tensors (conv weights
    OIHW, transposed-conv weights IOHW). A weight-shared tree emits both
    ``topu.*`` and ``dwnu.*``, the same tensors under both names (the
    reference's shared model registers one UNet twice, so a strict
    ``load_state_dict`` expects both). ``num_batches_tracked`` is an int64
    zero (the reference's BatchNorm uses a fixed momentum, so the counter
    is inert)."""
    sd = {}
    _export_unet(sd, "topu", params["top"], state["top"])
    if "down" in params:
        _export_unet(sd, "dwnu", params["down"], state["down"])
    else:
        sd.update({"dwnu" + k[len("topu"):]: v for k, v in list(sd.items())})
    for k in [k for k in sd if k.endswith("running_mean")]:
        sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64)
    return sd


def export_torch_checkpoint(path: str, params, state, epoch: int = 0):
    """Save the port's trees as a reference-loadable checkpoint
    (``{"net": state_dict, "epoch": N}``), which the reference's own
    scripts load with ``onet.load_state_dict(torch.load(f)['net'])``.
    Returns ``path``."""
    torch.save({"net": export_torch_state(params, state),
                "epoch": int(epoch)}, path)
    return path
