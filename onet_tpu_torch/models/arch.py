"""Architecture registry (``onet_tpu/models/arch.py``).

Every backbone exposes the same (init, forward) pair, so the steps and
drivers stay backbone-agnostic; checkpoints record the family and its
geometry in '__meta__' (``arch_meta``), so later surfaces rebuild the
right model from the file alone.

``init(gen, in_channels, *, weight_share=True, base=64, dtype=...,
device=None)`` draws from a ``torch.Generator`` where the JAX package
takes a key and returns (params, state) on ``device`` (default: the
card); ``forward(params, state, x, *, train, bias, policy)`` returns
(OnetOutput, state). The families: the vanilla conv U-Net
(``models/onet.py``), Swin-Unet (``models/swin.py``), ConvNeXt-UNet
(``models/convnext.py``) and TransUNet (``models/transunet.py``). Only
the vanilla one has the conv-specific machinery (channel stacking, the
pair-packed kernels, int8, BN-folded serving); the others size through
their own geometry arguments and refuse ``base != 64``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

ARCH_NAMES = ("vanilla", "swin", "convnext", "transunet")

GEOMETRY_KEYS = {
    "vanilla": (),
    "swin": ("swin_window", "swin_embed"),
    "convnext": ("convnext_embed",),
    "transunet": ("transunet_embed", "transunet_depth"),
}


def arch_meta(config) -> dict:
    """Checkpoint metadata of the model a driver config builds: the
    backbone family plus exactly the geometry knobs it consumes.
    ``config`` is any object with the driver-config fields."""
    name = getattr(config, "arch", "vanilla") or "vanilla"
    meta = {"arch": name,
            "in_channels": int(config.in_channels),
            "weight_share": bool(config.weight_share)}
    if name == "vanilla":
        meta["base_channels"] = int(config.base_channels)
    for k in GEOMETRY_KEYS[name]:
        meta[k] = int(getattr(config, k))
    return meta


def arch_from_meta(meta: dict):
    """get_arch from a read_checkpoint_meta dict ({} -> vanilla)."""
    name = meta.get("arch", "vanilla")
    kw = {k: meta[k] for k in GEOMETRY_KEYS.get(name, ()) if k in meta}
    return get_arch(name, **kw)


def _family(name, onet_init, forward, flag, **geometry):
    def init(gen, in_channels=1, *, weight_share=True, base=64,
             dtype=torch.float32, device=None):
        if base != 64:
            raise ValueError(f"--arch {name} sizes via {flag}, "
                             "not --base-channels")
        return onet_init(gen, in_channels, weight_share=weight_share,
                         dtype=dtype, device=device, **geometry)

    return SimpleNamespace(name=name, init=init, forward=forward,
                           vanilla=False)


def get_arch(name: str = None, *, swin_window: int = 7,
             swin_embed: int = 96, convnext_embed: int = 96,
             transunet_embed: int = 768, transunet_depth: int = 12):
    """Resolve an architecture by name. ``swin_*`` shape the transformer
    family (window 7 fits 224^2 inputs, 8 fits 512^2; embed 96 is the
    published Swin-T width); ``convnext_embed`` scales the ConvNeXt-T
    width; ``transunet_*`` the hybrid ViT (768 / 12 is ViT-B; the embed
    must stay divisible by 48)."""
    name = name or "vanilla"
    if name == "vanilla":
        from onet_tpu_torch.models.onet import onet_forward, onet_init
        return SimpleNamespace(name=name, init=onet_init,
                               forward=onet_forward, vanilla=True)
    if name == "swin":
        from onet_tpu_torch.models.swin import (swin_onet_forward,
                                                swin_onet_init)
        return _family(name, swin_onet_init, swin_onet_forward,
                       "--swin-embed", window=swin_window,
                       embed_dim=swin_embed)
    if name == "convnext":
        from onet_tpu_torch.models.convnext import (convnext_onet_forward,
                                                    convnext_onet_init)
        return _family(name, convnext_onet_init, convnext_onet_forward,
                       "--convnext-embed", embed_dim=convnext_embed)
    if name == "transunet":
        from onet_tpu_torch.models.transunet import (transunet_onet_forward,
                                                     transunet_onet_init)
        return _family(name, transunet_onet_init, transunet_onet_forward,
                       "--transunet-embed", embed_dim=transunet_embed,
                       depth=transunet_depth)
    raise ValueError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
