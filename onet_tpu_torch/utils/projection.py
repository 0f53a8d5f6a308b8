"""Falsifiable multi-card step projection from the collectives the port
issues (``onet_tpu/utils/projection.py``).

The strongest multi-card performance statement one card can give is a
projection whose every input is measured or stated, so it can be
falsified card for card on an 8-card host:

    projected step time  =  t_compute(per-card work)  +  t_link
    t_compute            =  the measured one-card step at the SAME
                            per-card work (scaled per A6 where it is not)
    t_link               =  sum over the collectives the step issues of
                            wire_bytes / BW + per-hop latency

The JAX package reads its collectives from compiled HLO text
(``parse_collectives``). The port has no HLO: its collectives are calls
into ``torch.distributed``, which ``parallel/collectives.py::record``
notes as they run, with their payload bytes, group size, name, mesh axes
and element size. The recorder takes the place of ``parse_collectives``, which
has no counterpart here. ``rescale`` carries a recording made on a small
mesh and a few frames to the projected mesh and per-card batch.

Stated assumptions (each one falsifiable):
  A1. NVLink: an H100 SXM card has 18 NVLink 4 links, 900 GB/s
      bidirectional in all (NVIDIA's published figure), so 450 GB/s each
      way. On an 8-card HGX host every card reaches every other through
      NVSwitch, and a ring over a mesh axis moves at most 450 GB/s out of
      each card: BW = 4.5e11 B/s per card (``NVLINK_BW``).
  A2. Ring collective wire volume per card, payload B over a group of g
      (the JAX package's): all-reduce 2B(g-1)/g, all-gather B(g-1)/g
      (B = result bytes), reduce-scatter B_result x (g-1),
      collective-permute B (one hop). A broadcast is priced as B (each
      card receives the payload once).
  A3. No overlap of compute and communication (conservative: NCCL runs
      on its own stream, so real steps should be faster).
  A4. Per-hop latency ``latency_s`` (default 2 us, ``NVLINK_LATENCY``)
      per collective per ring step: the small-tensor (BatchNorm sums,
      int8 scales) term.
  A5. The recorder notes each execution, so a collective inside the
      pipeline's microbatch loop counts once a trip (JAX's ``in_loop``
      and ``loop_trips`` have no counterpart).
  A6. t_compute scales linearly when per-card work shrinks (spatial
      partitioning halves the rows per card -> half the step time).
      Optimistic at small per-card extents; stated where used.
  A7. ``rescale``: the payloads named in ``FIXED`` (gradients, BatchNorm
      sums and state, the int8 scales' max, a loss) do not depend on the
      batch; every other payload is an activation and scales with the
      frames a data shard and with the element bytes (a recording in
      float32 priced for bf16 halves them). A group spans the projected
      mesh's sizes of the axes the collective was issued over.

The study ``onet_tpu_torch/runs/project_nvlink.py`` prints the table for
an 8-card H100 host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List

# one-way bytes/s per card over NVLink 4 (H100 SXM: 900 GB/s both ways)
NVLINK_BW = 4.5e11
NVLINK_LATENCY = 2e-6

# payloads that do not scale with the batch (A7)
FIXED = frozenset({"grads", "bn_sums", "bn_state", "quant_max",
                   "all_reduce_flat"})


@dataclass
class Collective:
    kind: str           # all-reduce / all-gather / reduce-scatter / ...
    payload_bytes: int  # result bytes (A2)
    group_size: int     # ranks in the group (ring length)
    name: str           # what the payload carries (collectives.py)
    axes: tuple = ()    # the mesh axes it was issued over
    elem_bytes: int = 0  # bytes of one payload element

    def wire_bytes(self) -> float:
        """Per-card wire volume under ring algorithms (A2)."""
        b, g = self.payload_bytes, self.group_size
        if g <= 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * b * (g - 1) / g
        if self.kind in ("all-gather", "all-to-all"):
            return b * (g - 1) / g
        if self.kind == "reduce-scatter":
            return float(b) * (g - 1)   # payload = scattered result
        return float(b)                  # collective-permute, broadcast


def summarize(collectives: Iterable[Collective]) -> Dict[str, Dict]:
    """Per-kind op count / payload / wire totals."""
    agg: Dict[str, Dict] = {}
    for c in collectives:
        a = agg.setdefault(c.kind, {"ops": 0, "payload_bytes": 0,
                                    "wire_bytes": 0.0})
        a["ops"] += 1
        a["payload_bytes"] += c.payload_bytes
        a["wire_bytes"] += c.wire_bytes()
    return agg


def rescale(collectives: Iterable[Collective], mesh: Dict[str, int], *,
            frames: float = 1.0, elem_bytes: int = None
            ) -> List[Collective]:
    """Collectives recorded on a small mesh, carried to ``mesh`` ({axis:
    size}) with ``frames`` times the recording's frames a data shard and,
    with ``elem_bytes``, activations of that element size (A7)."""
    out = []
    for c in collectives:
        g = math.prod(mesh.get(a, 1) for a in c.axes)
        b, e = float(c.payload_bytes), c.elem_bytes
        if c.name not in FIXED:
            b *= frames
            if elem_bytes is not None:
                b, e = b * elem_bytes / e, elem_bytes
        out.append(Collective(c.kind, int(round(b)), g, c.name, c.axes, e))
    return out


def project_step(t_compute_s: float, collectives: Iterable[Collective], *,
                 tiles_per_step: float, axis_bw: float = NVLINK_BW,
                 latency_s: float = NVLINK_LATENCY) -> Dict[str, float]:
    """Combine measured compute with the priced collectives, one execution
    each as recorded (A2-A5; A3: no overlap). Returns the JAX package's
    record; ``t_ici_ms`` keeps its name and holds the NVLink time (JAX's
    ``ici_seconds`` and its ``repeat`` / ``loop_trips`` counts are not
    needed: the recorder notes every execution)."""
    cols = list(collectives)
    t_link = sum(c.wire_bytes() / axis_bw
                 + latency_s * max(c.group_size - 1, 0) for c in cols)
    t_step = t_compute_s + t_link
    return {
        "t_compute_ms": t_compute_s * 1e3,
        "t_ici_ms": t_link * 1e3,
        "t_step_ms": t_step * 1e3,
        "tiles_per_s": tiles_per_step / t_step,
        "ici_fraction": t_link / t_step,
        "n_collectives": len(cols),
    }
