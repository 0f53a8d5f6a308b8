"""Architecture registry (``onet_tpu/models/arch.py``).

Every backbone exposes the same (init, forward) pair, so the steps and
drivers stay backbone-agnostic; checkpoints record the family and its
geometry in '__meta__' (``arch_meta``), so later surfaces rebuild the
right model from the file alone.

The port has the vanilla conv U-Net: ``get_arch("vanilla")`` returns
``models/onet.py``'s ``onet_init`` (which draws from a
``torch.Generator`` where the JAX package takes a key) and
``onet_forward``. The other families are not ported yet (ROADMAP.md,
Queue A item 6) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from types import SimpleNamespace

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


def get_arch(name: str = None, *, swin_window: int = 7,
             swin_embed: int = 96, convnext_embed: int = 96,
             transunet_embed: int = 768, transunet_depth: int = 12):
    """Resolve an architecture by name. The geometry arguments shape the
    families not ported yet; they are accepted so that a driver config
    passes through unchanged."""
    name = name or "vanilla"
    if name == "vanilla":
        from onet_tpu_torch.models.onet import onet_forward, onet_init
        return SimpleNamespace(name=name, init=onet_init,
                               forward=onet_forward, vanilla=True)
    if name in ARCH_NAMES:
        raise NotImplementedError(
            f"arch {name!r} is not in the port yet (ROADMAP.md, Queue A "
            "item 6: other model families); the port has 'vanilla'")
    raise ValueError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
