"""Model and data inspection utilities (``onet_tpu/utils/summary.py``).

Reference counterparts in utils_20231218.py: count_parameters (:29-42),
print_parameters_statics / compare_top_dwn_parameters_statics (:44-89,
the weight-share gradient-flow debug aids), get_model_summary (:692-811,
the forward-hook FLOP/param table), and get_scr
(Rayleigh_bg_Gaussian_EOT_generator_20230208.py:277-294).

Trees are the port's nested dicts and lists; leaf names join the keys
(and list indices) with "/" in the JAX package's leaf order, and the
statistics are numpy's on a host copy, so both packages give the same
rows for the same weights. ``runtime_layer_summary`` traces on PyTorch's
``meta`` device where the JAX package uses ``jax.eval_shape``: shapes
only, no arithmetic, at any input size.
"""

from __future__ import annotations

import types
from typing import Dict, List

import numpy as np
import torch

from onet_tpu_torch.models.unet import tree_map


def scr_db(image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Signal-to-clutter ratio of the labelled extended target (dB): the
    mean energy under the label over the mean energy outside it. Stays on
    the device; ``get_scr`` is the host float."""
    lab = label.to(image.dtype)
    sig = torch.sum(torch.square(lab * image)) / torch.clamp_min(
        torch.sum(lab == 1), 1)
    noi = torch.sum(torch.square((1 - lab) * image)) / torch.clamp_min(
        torch.sum(lab == 0), 1)
    return 10.0 * torch.log10(sig / noi)


def get_scr(image: torch.Tensor, label: torch.Tensor) -> float:
    """Signal-to-clutter ratio of the labelled extended target (dB)."""
    return float(scr_db(image, label))


def _leaves_with_path(tree, path=()):
    """(path, leaf) in the JAX package's leaf order: dict keys sorted,
    list elements by index. A path segment is ("key", k) or ("idx", i)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _leaves_with_path(tree[k], path + (("key", k),))]
    if isinstance(tree, list):
        return [item for i, t in enumerate(tree)
                for item in _leaves_with_path(t, path + (("idx", i),))]
    return [(path, tree)]


def _host(leaf) -> np.ndarray:
    return leaf.detach().to("cpu").numpy()


def count_parameters(params) -> float:
    """Trainable parameter count in millions (reference prints M units)."""
    return sum(int(t.numel()) for _, t in _leaves_with_path(params)) / 1e6


def parameter_statistics(params) -> Dict[str, Dict[str, float]]:
    """Per-leaf mean/std/absmax — the weight-share debugging aid."""
    out = {}
    for path, leaf in _leaves_with_path(params):
        name = "/".join(str(v) for _, v in path)
        arr = _host(leaf)
        out[name] = {"mean": float(arr.mean()), "std": float(arr.std()),
                     "absmax": float(np.abs(arr).max()),
                     "shape": tuple(arr.shape)}
    return out


def compare_parameter_trees(a, b, atol: float = 0.0) -> List[str]:
    """Names of leaves that differ (empty list == trees identical, the
    weight-share invariant check). A list index is named "[i]", as the
    JAX package names it here."""
    diffs = []
    for (pa, la), (_, lb) in zip(_leaves_with_path(a), _leaves_with_path(b)):
        if not np.allclose(_host(la), _host(lb), atol=atol):
            diffs.append("/".join(str(v) if kind == "key" else f"[{v}]"
                                  for kind, v in pa))
    return diffs


def _conv_flops(h, w, kh, kw, cin, cout):
    return 2 * h * w * kh * kw * cin * cout


def _numel(tree) -> int:
    return sum(int(t.numel()) for _, t in _leaves_with_path(tree))


def model_summary(params, input_hw=(224, 224), in_channels=1,
                  batch: int = 1) -> List[Dict]:
    """Static per-stage table (name, params, output shape, fwd FLOPs) for
    the weight-shared U-Net — the analogue of the reference's hook-based
    summary, derived from shapes instead of a live forward."""
    rows = []
    h, w = input_hw
    tree = params["top"] if "top" in params else params

    def dconv_row(name, p, h, w, cin):
        c1 = p["conv1"]["w"].shape[-1]
        c2 = p["conv2"]["w"].shape[-1]
        flops = (_conv_flops(h, w, 3, 3, cin, c1)
                 + _conv_flops(h, w, 3, 3, c1, c2))
        rows.append({"name": name, "out_shape": (batch, h, w, c2),
                     "params": _numel(p), "fwd_flops": batch * flops})
        return c2

    c = dconv_row("inc", tree["inc"], h, w, in_channels)
    skip_hw = [(h, w)]
    for i in range(1, 5):
        h, w = h // 2, w // 2
        c = dconv_row(f"down{i}", tree[f"down{i}"], h, w, c)
        skip_hw.append((h, w))
    for i in range(1, 5):
        up = tree[f"up{i}"]
        cin = up["up"]["w"].shape[2]
        cup = up["up"]["w"].shape[3]
        h, w = skip_hw[4 - i]          # up{i} lands on the matching skip size
        # k=2 s=2 transpose conv: each output pixel costs one cin*cup MAC
        tflops = 2 * h * w * cin * cup
        rows.append({"name": f"up{i}/transpose",
                     "out_shape": (batch, h, w, cup),
                     "params": _numel(up["up"]), "fwd_flops": batch * tflops})
        c = dconv_row(f"up{i}/conv", up["conv"], h, w, cup * 2)
    rows.append({"name": "TOTAL", "out_shape": None,
                 "params": sum(r["params"] for r in rows),
                 "fwd_flops": sum(r["fwd_flops"] for r in rows)})
    return rows


def runtime_layer_summary(params, state, x, *,
                          train: bool = False) -> List[Dict]:
    """Per-layer output shapes/dtypes from a LIVE traced forward — the
    counterpart of the reference's forward-hook summary
    (utils_20231218.py:692-811): the layer primitives are intercepted
    during one forward on the ``meta`` device (no device work, any input
    size), through the U-Net's ``ops`` injection point.

    Returns rows {name, op, out_shape, out_dtype} in execution order
    (dtypes spelled as numpy spells them). Complements model_summary's
    static FLOP/param table with what the traced graph actually produces
    (padding, stacking and policy casts included)."""
    from onet_tpu_torch.models import layers as L
    from onet_tpu_torch.models.onet import onet_forward

    rows = []

    def tap(op):
        fn = getattr(L, op)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            y = out[0] if isinstance(out, tuple) else out
            rows.append({"name": f"{op}_{len(rows)}", "op": op,
                         "out_shape": tuple(y.shape),
                         "out_dtype": str(y.dtype).removeprefix("torch.")})
            return out
        return wrapped

    ops = types.SimpleNamespace(
        conv3x3=tap("conv3x3"),
        batch_norm=tap("batch_norm"),
        max_pool=tap("max_pool_2x2"),
        conv_transpose=tap("conv_transpose_2x2"),
    )
    meta = lambda t: t.to("meta")   # noqa: E731
    with torch.no_grad():
        onet_forward(tree_map(meta, params), tree_map(meta, state),
                     torch.empty(tuple(x.shape), dtype=x.dtype,
                                 device="meta"),
                     train=train, ops=ops, pair_pack=False)
    return rows
