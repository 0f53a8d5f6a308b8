"""Falsifiable 8-card H100 step projection (the counterpart of the repo
root's ``runs/project_v5e8.py``).

For each combination of mesh axes the port trains on (data, data x
space, data x space x spacew, data x model, data x stage, the int8 steps)
and for data-parallel serving, the projected step of an 8-card NVLink
host at 512^2, bf16, 8 frames a card (a data shard's 8 frames, split over
its space / model / stage cards):

    t_step = t_compute (measured on this card, scaled per A6)
           + t_link    (the collectives the step issues, priced per A1-A5)

with every assumption stated in ``onet_tpu_torch/utils/projection.py``.
The collectives are recorded (``parallel/collectives.py::record``) from
one step of each case on a mesh of 2 or 4 ranks, 2 frames a data shard,
and carried to the 8-card mesh and 8 frames by ``rescale`` (A7). Every
number printed for 8 cards is a projection; only t_compute and the
recorded payloads are measured.

    python -m onet_tpu_torch.runs.project_nvlink [--device cuda]

runs on the card: it times the one-card steps (the pair-packed bf16 train
step of ``chip_smoke.py``'s phase 4, the int8 steps, the folded forward,
batch 8 at 512^2), records the cases in a gloo world of 4 processes
sharing the card, and prints the table with the card's name and power
limit. ``chip_smoke.py`` phase 14 (f) prints the same table from its own
recordings and times.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np

from onet_tpu_torch.utils.projection import project_step, rescale, summarize

TILE = 512
PER_CARD = 8              # frames a data shard, the one-card step's batch
N_CARDS = 8
RECORD_FRAMES = 2         # frames a data shard in the recordings
BF16_BYTES = 2

# (label, recorded case, projected mesh, t_compute key, A6 divisor)
COMBOS = (
    ("train dp8", "dp (2, 1)", {"data": 8}, "train", 1),
    ("train dp4xsp2", "spatial (1, 2)", {"data": 4, "space": 2}, "train",
     2),
    ("train dp2xsp2x2", "spatial (1, 2, 2)",
     {"data": 2, "space": 2, "spacew": 2}, "train", 4),
    ("train dp4xtp2", "tp (1, 2)", {"data": 4, "model": 2}, "train", 2),
    ("train dp4xpp2 (m=2)", "pp (1, 2)", {"data": 4, "stage": 2}, "train",
     None),
    ("train int8 fwd+dx dp8", "int8 fwd+dx (2, 1)", {"data": 8},
     "train_fwd+dx", 1),
    ("train int8 fwd dp4xsp2", "int8 fwd (1, 2)", {"data": 4, "space": 2},
     "train_fwd", 2),
    ("infer dp8", "serve", {"data": 8}, "infer", 1),
)
# the recorded cases: (mode, mesh shape, axis names, microbatches, int8)
CASES = {
    "dp (2, 1)": ("dp", (2, 1), ("data", "space"), 1, None),
    "spatial (1, 2)": ("spatial", (1, 2), ("data", "space"), 1, None),
    "spatial (1, 2, 2)": ("spatial", (1, 2, 2), ("data", "space", "spacew"),
                          1, None),
    "tp (1, 2)": ("tp", (1, 2), ("data", "model"), 1, None),
    "pp (1, 2)": ("pp", (1, 2), ("data", "stage"), 2, None),
    "int8 fwd+dx (2, 1)": ("dp", (2, 1), ("data", "space"), 1, "fwd+dx"),
    "int8 fwd (1, 2)": ("spatial", (1, 2), ("data", "space"), 1, "fwd"),
}


def stage_flop_shares(base: int = 64) -> tuple:
    """Encoder vs decoder forward-FLOP share at 512^2 (the pipeline cut,
    parallel/pipeline.py: encoder = inc + down1..4 | decoder = up1..4)."""
    import torch

    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.utils.summary import model_summary

    params, _ = onet_init(torch.Generator().manual_seed(0), 1, base=base,
                          device="meta")
    rows = model_summary(params, input_hw=(TILE, TILE), in_channels=1)
    enc = sum(r["fwd_flops"] for r in rows
              if r["name"] == "inc" or r["name"].startswith("down"))
    dec = sum(r["fwd_flops"] for r in rows if r["name"].startswith("up"))
    return enc / (enc + dec), dec / (enc + dec)


def compute_seconds(key: str, divisor, times: dict):
    """(t_compute in s, its basis) for a combo (A6)."""
    t = times[key]
    if divisor is not None:
        basis = ("measured one-card step, per-card work identical"
                 if divisor == 1 else
                 f"A6: 1/{divisor} of the per-card work -> t_single/"
                 f"{divisor}")
        return t / divisor, basis
    enc, dec = stage_flop_shares()
    microbatches = CASES["pp (1, 2)"][3]
    ticks = microbatches + 1
    share = max(enc, dec)
    return (t * share * ticks / microbatches,
            f"slowest-stage share {share:.3f} x bubble "
            f"{ticks / microbatches:.2f} x t_single")


def project(records: dict, times: dict) -> dict:
    """The table's rows: {label: {"proj", "collectives", "basis", ...}}.
    ``records``: {case: list of Collective} from one step of each case
    at RECORD_FRAMES a data shard ("serve": the serving run's, which must
    be empty); ``times``: seconds of the one-card steps at PER_CARD
    frames ("train", "train_fwd", "train_fwd+dx", "infer")."""
    rows = {}
    for label, case, mesh, key, div in COMBOS:
        if case not in records or key not in times:
            continue
        cols = rescale(records[case], mesh, frames=PER_CARD / RECORD_FRAMES,
                       elem_bytes=BF16_BYTES)
        if case == "serve" and cols:
            raise AssertionError(f"serving over cards issued collectives: "
                                 f"{summarize(cols)}")
        t, basis = compute_seconds(key, div, times)
        frames = mesh.get("data", 1) * PER_CARD
        rows[label] = {"proj": project_step(t, cols, tiles_per_step=frames),
                       "collectives": summarize(cols), "basis": basis,
                       "recorded_case": case}
    return rows


def table(rows: dict, card: str) -> list:
    """The printed lines; every 8-card number is a projection."""
    out = [f"projected {N_CARDS}-card step (NVLink, A1-A7), {TILE}^2 bf16, "
           f"{PER_CARD} frames a data shard; t_compute measured on {card}",
           f"{'combo':24s} {'t_comp ms':>9s} {'t_link ms':>9s} "
           f"{'link %':>6s} {'frames/s':>9s} {'/card':>7s}  (projected)"]
    for name, r in rows.items():
        p = r["proj"]
        out.append(f"{name:24s} {p['t_compute_ms']:9.2f} "
                   f"{p['t_ici_ms']:9.3f} {100 * p['ici_fraction']:5.2f}% "
                   f"{p['tiles_per_s']:9.1f} "
                   f"{p['tiles_per_s'] / N_CARDS:7.1f}")
    return out


# ---------------------------------------------------------------------------
# measuring on the card
# ---------------------------------------------------------------------------

def _record_rank(cases, hw: int, base: int) -> dict:
    """One rank of the recording world: one bf16 step of every case that
    fits the world, under ``record``; returns {case: collectives}."""
    import torch
    import torch.distributed as dist

    from onet_tpu_torch.core.mesh import make_mesh
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.parallel import launch
    from onet_tpu_torch.parallel.collectives import record
    from onet_tpu_torch.train.optim import adam_init

    device = launch.device()
    out = {}
    for name in cases:
        mode, shape, names, mb, q = CASES[name]
        n = int(np.prod(shape))
        if n > dist.get_world_size():
            continue
        mesh = make_mesh(shape, names, ranks=list(range(n)))
        if mesh is None:
            continue
        p, s = onet_init(torch.Generator().manual_seed(0), 1, base=base,
                         device=device)
        g = torch.Generator().manual_seed(1)
        x = torch.rand((RECORD_FRAMES * mesh.shape.get("data", 1), hw, hw,
                        1), generator=g).to(device)
        step = make_step(mode, mesh, mb, BF16_COMPUTE, q)
        with record() as cols:
            step(p, s, adam_init(p), x, 1e-5)
        out[name] = cols
        dist.barrier(group=mesh.world.group)
        del p, s, x, step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def make_step(mode, mesh, microbatches, policy, quantized=None):
    """The train step of a recorded case."""
    from onet_tpu_torch.train.steps import make_train_step
    if mode == "dp":
        return make_train_step(mesh=mesh, policy=policy, quantized=quantized)
    if mode == "spatial":
        return make_train_step(mesh=mesh, spatial=True, policy=policy,
                               quantized=quantized)
    if mode == "tp":
        from onet_tpu_torch.parallel.tensor import make_tp_train_step
        return make_tp_train_step(mesh, policy=policy)
    from onet_tpu_torch.parallel.pipeline import make_pp_train_step
    return make_pp_train_step(mesh, microbatches=microbatches, policy=policy)


def serve_collectives(device) -> list:
    """What ``serve --dp``'s shards issue (``run._serve_shards`` over this
    one device, a batch of PER_CARD frames): nothing."""
    import torch

    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.parallel.collectives import record
    from onet_tpu_torch.run import _serve_shards

    p, s = onet_init(torch.Generator().manual_seed(0), 1, base=64,
                     device=device)
    x = torch.rand((PER_CARD, TILE, TILE, 1)).to(device)
    with torch.inference_mode(), record() as cols:
        step = _serve_shards(
            lambda f, xb: onet_infer(f, xb, policy=BF16_COMPUTE),
            fold_onet(p, s), [device])
        step(None, x)
    return cols


def one_card_times(device) -> dict:
    """Seconds of the one-card steps at PER_CARD frames, 512^2, bf16: the
    pair-packed train step (phase 4's), the int8 steps, the folded
    forward; CUDA events around 5 calls after 2."""
    import torch

    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    def timed(fn, reps=5):
        for _ in range(2):
            fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps / 1e3

    p, s = O.onet_init(torch.Generator().manual_seed(0), 1, base=64,
                       device=device)
    x = torch.rand((PER_CARD, TILE, TILE, 1),
                   generator=torch.Generator().manual_seed(1)).to(device)
    times = {}
    for key, level, wp in (("train", None, True), ("train_fwd", "fwd", False),
                           ("train_fwd+dx", "fwd+dx", False)):
        old, O.PAIR_PACK = O.PAIR_PACK, wp
        try:
            step = make_train_step(policy=BF16_COMPUTE, quantized=level)
            o = adam_init(p)
            times[key] = timed(lambda: step(p, s, o, x, 1e-5))
        finally:
            O.PAIR_PACK = old
    old, O.PAIR_PACK = O.PAIR_PACK, True
    try:
        with torch.inference_mode():
            f = fold_onet(p, s)
            times["infer"] = timed(lambda: onet_infer(f, x,
                                                      policy=BF16_COMPUTE))
    finally:
        O.PAIR_PACK = old
    return times


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown card"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON here")
    args = ap.parse_args(argv)

    import torch

    from onet_tpu_torch.core.device import resolve_device
    from onet_tpu_torch.parallel.launch import run_world

    dev = resolve_device(args.device)
    card = card_name()
    times = one_card_times(dev)
    torch.cuda.empty_cache()
    records = run_world(4, f"cuda:{dev.index or 0}", _record_rank,
                        tuple(CASES), TILE, 64, backend="gloo")[0]
    records["serve"] = serve_collectives(dev)
    rows = project(records, times)
    for line in table(rows, card):
        print(line)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "times_s": times, "rows": rows}, fh,
                      indent=1, default=str)


if __name__ == "__main__":
    main()
