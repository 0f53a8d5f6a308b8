"""Single-file serving artifacts (``onet_tpu/serve/artifact.py``).

``export_serving_artifact`` exports the BN-folded serving graph with
``torch.export``, the folded weights baked into the program as constants,
and writes one self-contained file. Loading needs no model code: the
program is deserialized and called, so a trained model deploys to any
machine with PyTorch, without this package, its checkpoint format or the
backbone's definition. The batch dimension is exported symbolic by default
(``torch.export.Dim``): one artifact serves any batch size; H, W and C are
static.

The exported graph is the channel-stacked folded forward on cuDNN, as the
JAX artifact exports its default graph: the pair-packed path calls its
kernels through ctypes, which ``torch.export`` cannot trace. With
``int8_calib`` it is the int8 graph (``models/quant.py``), whose int8
convs are the ``torch.library`` custom ops of ``ops/conv_i8.py``: the
program records them as ops and launches the hand-written kernels when it
runs on the card; ``load_serving_artifact`` imports that module (which
registers the ops) before it deserializes a program. Tensors made
inside the traced code take the device they were traced on, so the program
is exported on the device that will serve it (the card by default), the
header records that device, and a load on another device moves the
program there (``torch.export.passes.move_to_device_pass``).

File format (little-endian), the JAX container with its own magic:

    bytes 0..7      magic  b"ONETP01\\0"
    bytes 8..15     uint64 header length N
    bytes 16..16+N  JSON header (input spec, model metadata, versions)
    rest            ``torch.export.save`` of the program (weights inside)

The JAX package's artifacts (magic ``b"ONETX01\\0"``) hold a StableHLO
module: the reader names them as such.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct

import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.policy import Policy

MAGIC = b"ONETP01\x00"       # 8 bytes
JAX_MAGIC = b"ONETX01\x00"   # the JAX package's artifacts
_HEADER_VERSION = 1


class _Fn(torch.nn.Module):
    """``fn`` as a module, for ``torch.export``: the tensors it closes
    over become the program's constants."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _call_fn(folded, policy, bias):
    """The exported computation: x [B, H, W, C] f32 -> (S f32, labels
    int32), on the channel-stacked folded graph."""
    from onet_tpu_torch.models.infer import onet_infer

    def fn(x):
        s, labels = onet_infer(folded, x, bias=bias, policy=policy,
                               channel_stack=True, pair_pack=False)
        return s.float(), labels.to(torch.int32)

    return fn


def _call_fn_q(q, bias, head_bf16):
    """The exported int8 computation: x [B, H, W, C] f32 -> (S f32, labels
    int32), on the int8 graph."""
    from onet_tpu_torch.models.quant import onet_infer_q

    def fn(x):
        s, labels = onet_infer_q(q, x, bias=bias, head_bf16=head_bf16)
        return s.float(), labels.to(torch.int32)

    return fn


def export_serving_artifact(params, bn_state, out_path, *, input_hw,
                            in_channels=1, batch=None, policy=None,
                            bias=0.0, int8_calib=None, head_bf16=True,
                            extra_meta=None, device=None) -> dict:
    """Export the folded serving graph of ``(params, bn_state)`` on
    ``device`` (default: the card; raises without one).

    batch=None exports a symbolic batch dimension (any batch size at call
    time); an int pins it. ``int8_calib`` (a [B, H, W, C] calibration batch
    in [0, 1]) bakes the int8 graph instead (``models/quant.py``,
    calibrated on that batch with ``policy``; weight-shared models only;
    ``head_bf16`` as in ``onet_infer_q``). Returns the header written."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.infer import fold_onet
    from onet_tpu_torch.models.onet import is_weight_shared
    from onet_tpu_torch.models.unet import param_count, tree_map

    dev = resolve_device(device)
    policy = policy or BF16_COMPUTE
    with torch.no_grad():
        folded = fold_onet(tree_map(lambda t: t.to(dev), params),
                           tree_map(lambda t: t.to(dev), bn_state))
    if int8_calib is not None:
        from onet_tpu_torch.models.quant import calibrate, quantize_folded
        if not is_weight_shared(params):
            raise ValueError("int8 artifacts require the weight-shared "
                             "model (the quantized graph is the stacked "
                             "twin pass; models/quant.py)")
        x = torch.as_tensor(int8_calib).to(dev, torch.float32)
        with torch.no_grad():
            q = quantize_folded(folded, calibrate(folded, x, bias=bias,
                                                  policy=policy))
        fn = _call_fn_q(q, bias, head_bf16)
        arithmetic = "int8" + ("+bf16head" if head_bf16 else "")
    else:
        fn = _call_fn(folded, policy, bias)
        arithmetic = str(policy.compute_dtype).removeprefix("torch.")
    meta = {"bias": float(bias), "arithmetic": arithmetic,
            "params_m": round(param_count(params) / 1e6, 4)}
    if extra_meta:
        meta.update(extra_meta)
    return export_fn_artifact(fn, out_path, input_hw=input_hw,
                              in_channels=in_channels, batch=batch,
                              extra_meta=meta, device=dev)


def export_fn_artifact(fn, out_path, *, input_hw, in_channels, batch=None,
                       extra_meta=None, device=None) -> dict:
    """Export any ``fn(x [B, H, W, C] f32) -> (S f32, labels int32)``
    serving step on ``device`` (default: the card); the tensors it closes
    over become the program's constants. The writer behind
    ``export_serving_artifact``."""
    dev = resolve_device(device)
    h, w = input_hw
    # an example batch of 2: torch.export specializes sizes 0 and 1
    x = torch.zeros((2 if batch is None else int(batch), h, w, in_channels),
                    dtype=torch.float32, device=dev)
    dynamic = ({"x": {0: torch.export.Dim("batch", min=1)}}
               if batch is None else None)
    with torch.no_grad():
        program = torch.export.export(_Fn(fn), (x,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()

    meta = {
        "header_version": _HEADER_VERSION,
        "input_hw": [int(h), int(w)],
        "in_channels": int(in_channels),
        "batch": "symbolic" if batch is None else int(batch),
        "device": dev.type,
        "output": ["S float32 [B,H,W,2]", "labels int32 [B,H,W]"],
        "torch_version": torch.__version__,
        # integrity guard: a truncated or corrupted copy fails at load with
        # a clear message instead of a deserializer crash
        "blob_sha256": hashlib.sha256(blob).hexdigest(),
    }
    if extra_meta:
        meta.update(extra_meta)
    head = json.dumps(meta).encode()
    with open(out_path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        f.write(blob)
    return meta


def _read_container(path, *, want_blob):
    """Parse the container; every malformation (bad magic, truncated
    prefix, header or program, unreadable JSON, a future header version)
    raises ValueError with a clear message. Returns (meta, blob or
    None)."""
    with open(path, "rb") as f:
        prefix = f.read(16)
        if prefix[:8] == JAX_MAGIC:
            raise ValueError(
                f"{path}: a JAX serving artifact (magic {JAX_MAGIC!r}, a "
                "StableHLO module), not a torch one: load it with the JAX "
                "package, or export the checkpoint with this package's "
                "export_serving_artifact")
        if prefix[:8] != MAGIC:
            raise ValueError(
                f"{path}: not a serving artifact (magic {prefix[:8]!r}; "
                f"expected {MAGIC!r}; export one with "
                "onet_tpu_torch.serve.artifact.export_serving_artifact)")
        if len(prefix) < 16:
            raise ValueError(f"{path}: truncated artifact (only "
                             f"{len(prefix)} bytes of the 16-byte prefix)")
        (n,) = struct.unpack("<Q", prefix[8:16])
        head = f.read(n)
        if len(head) < n:
            raise ValueError(f"{path}: truncated artifact header "
                             f"({len(head)} of {n} bytes)")
        try:
            meta = json.loads(head.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(
                f"{path}: corrupted artifact header ({e})") from None
        if meta.get("header_version", 1) > _HEADER_VERSION:
            raise ValueError(
                f"{path}: artifact header v{meta['header_version']} > "
                f"supported v{_HEADER_VERSION} — upgrade this package to "
                "load it")
        blob = None
        if want_blob:
            blob = f.read()
            want = meta.get("blob_sha256")
            if want and hashlib.sha256(blob).hexdigest() != want:
                raise ValueError(
                    f"{path}: module bytes do not match the header "
                    "checksum — the artifact is truncated or corrupted; "
                    "re-copy or re-export")
        return meta, blob


def read_artifact_meta(path) -> dict:
    """Header metadata only (no deserialization)."""
    return _read_container(path, want_blob=False)[0]


def load_serving_artifact(path, device=None):
    """Load ``path`` onto ``device`` (default: the card; raises without
    one) -> ``(call, meta)``.

    ``call(x)`` takes [B, H, W, C] float32 (B free if the artifact was
    exported with a symbolic batch) and returns ``(S, labels)`` on
    ``device``, the contract of the checkpoint serving step, so the tiling
    and HTTP layers take it unchanged. Raises where the program cannot be
    put on ``device``."""
    import onet_tpu_torch.ops.conv_i8  # noqa: F401  (registers the int8 ops)

    dev = resolve_device(device)
    meta, blob = _read_container(path, want_blob=True)
    program = torch.export.load(io.BytesIO(blob))
    if meta.get("device") != dev.type:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
    module = program.module()
    tensors = [t for t in (*program.constants.values(),
                           *program.state_dict.values())
               if isinstance(t, torch.Tensor)]
    off = sorted({str(t.device) for t in tensors
                  if t.device.type != dev.type})
    if off:
        raise RuntimeError(f"{path}: the program's weights stay on {off} "
                           f"after the move to {dev}")
    expect = (meta["input_hw"][0], meta["input_hw"][1], meta["in_channels"])
    # the switches a policy sets around its step are not in the program:
    # float32 means no TF32, as on the live path (core/policy.py)
    precision = Policy(allow_tf32=meta.get("arithmetic") != "float32")

    def artifact_call(x):
        x = torch.as_tensor(x).to(dev, torch.float32)
        if tuple(x.shape[1:]) != expect:
            raise ValueError(
                f"artifact expects input [B, {expect[0]}, {expect[1]}, "
                f"{expect[2]}]; got {tuple(x.shape)} (artifacts carry "
                "static H/W/C — tile larger scenes with "
                "serve/tiles.py::infer_tiled, or re-export at this size)")
        if meta["batch"] != "symbolic" and x.shape[0] != meta["batch"]:
            raise ValueError(
                f"artifact was exported with a pinned batch of "
                f"{meta['batch']}; got {x.shape[0]} (re-export with "
                "batch=None for a symbolic batch)")
        with torch.inference_mode(), precision.precision():
            return module(x)

    return artifact_call, meta


def is_artifact(path) -> bool:
    """True for this package's artifacts (not the JAX package's)."""
    try:
        with open(path, "rb") as f:
            return f.read(8) == MAGIC
    except OSError:
        return False
