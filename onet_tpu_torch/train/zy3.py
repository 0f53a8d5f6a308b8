"""Workload 4: unsupervised ZY-3 cloud-detection training
(``onet_tpu/train/zy3.py``).

The reference's Train_Onet_on_zy3_20240606.py:74-177, rebuilt:
* Adam at lr 1e-4 with cosine warm restarts (T0=300, mult=2,
  eta_min=1e-6) stepped per epoch;
* the ZY-3 augmentation on every train batch (``aug=True``), its choices
  drawn on the device (``data/augment.py``);
* every epoch, the eval with per-image Hungarian (K=2) alignment and
  per-image (acc, miou, dr, far, tiou), averaged over images, and the test
  JSD loss; the per-image alignment is batched (``torch.func.vmap``), and
  an epoch's eval reads the host once;
* a checkpoint at the final epoch (and epoch 300), in the JAX package's
  file format; ``restart_from`` continues from such a file, and a SIGTERM
  drains the step, checkpoints and returns.

``device`` (default: the card; raises without one) is the one argument
the JAX package has no counterpart to; ``arch`` picks the backbone family
(``models/arch.py``). ``mesh`` (``core/mesh.py``) makes the train step
data parallel (every rank runs ``train`` on the same data and its steps
take their rows of each batch); the eval stays one graph on every rank,
as in the JAX package. Only the mesh's first rank writes checkpoints,
logs and curves, and a SIGTERM on any rank stops every rank at the same
step.
Each epoch's shuffle and augmentation draw from a generator derived from
(loop seed, epoch), so a restarted epoch draws what it would have drawn.

``save_zy3_test_results`` is split in two: ``zy3_test_rows`` computes the
report's rows and summary on the device (no pandas), and
``write_zy3_report`` writes the workbook from them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch

from onet_tpu_torch.core.checkpoint import (datehour_mark, load_checkpoint,
                                            save_checkpoint)
from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.core.prng import RngStream, derive_seed, make_generator
from onet_tpu_torch.data.arrays import ArrayDataset, batch_iterator
from onet_tpu_torch.metrics.segmentation import (
    align_labels_hungarian, evaluate_binary_segmentation)
from onet_tpu_torch.models.arch import arch_meta, get_arch
from onet_tpu_torch.models.onet import LOSSES, onet_forward, predict_label
from onet_tpu_torch.report import can_draw
from onet_tpu_torch.report.logs import setup_logging
from onet_tpu_torch.train.optim import adam_init, cosine_warm_restarts
from onet_tpu_torch.train.preempt import PreemptGuard
from onet_tpu_torch.train.steps import make_grad_step, make_train_step

METRICS = ("acc", "miou", "dr", "far", "tiou")
GROUP_NAMES = ("normal_cloud", "thin_cloud", "snow_cloud")
DETECTOR_FARS = (0.01, 0.05)


@dataclasses.dataclass
class Zy3Config:
    model_name: str = "onet_vanilla_zy3"
    epoch_nums: int = 11
    batch_sz: int = 5
    input_sz: int = 224
    in_channels: int = 3
    weight_share: bool = True
    aug: bool = True
    base_lr: float = 1e-4
    eta_min: float = 1e-6
    t0: int = 300
    t_mult: int = 2
    out_root: str = "./checkpoint/zy3/onet_vanilla"
    seed: int = 1981
    base_channels: int = 64
    restart_from: Optional[str] = None
    # on SIGTERM finish the current step, checkpoint and return; pass the
    # saved path as restart_from to continue (the cut epoch is redone)
    preempt_save: bool = True
    save_epochs: tuple = (300,)
    # backbone family (models/arch.py): "vanilla", "swin", "convnext" or
    # "transunet", sized by the geometry fields below
    arch: str = "vanilla"
    swin_window: int = 7
    swin_embed: int = 96
    convnext_embed: int = 96
    transunet_embed: int = 768
    transunet_depth: int = 12
    # objective (models/onet.py::LOSSES): "jsd" or "rsn"
    loss: str = "jsd"


def _per_image(pred: torch.Tensor, labels: torch.Tensor):
    """Hungarian-align each image's prediction to its own labels and score
    it: (metrics {name: [B]}, aligned [B, H, W])."""
    def one(p, lab):
        p2 = align_labels_hungarian(p, lab)
        return evaluate_binary_segmentation(p2, lab), p2

    return torch.func.vmap(one)(pred, labels)


def make_zy3_eval(*, policy: Policy = DEFAULT, forward=None,
                  loss: str = "jsd"):
    """(params, bn_state, x, labels) -> (per-image metrics {name: [B]},
    the batch's test loss, the aligned predictions, Vt, Vd), under
    ``no_grad`` and the policy's precision. ``loss`` picks the objective
    the test loss reports; ``forward`` another family's forward
    (``models/arch.py``)."""
    fwd = forward or onet_forward
    loss_of = LOSSES[loss]

    def eval_batch(params, bn_state, x, labels):
        with torch.no_grad(), policy.precision():
            out, _ = fwd(params, bn_state, x, train=False, policy=policy)
            value = loss_of(out)
            metrics, aligned = _per_image(predict_label(out.S), labels)
            return metrics, value, aligned, out.Vt, out.Vd

    return eval_batch


def evaluate_zy3(eval_batch, params, bn_state, test_ds: ArrayDataset,
                 batch_sz: int):
    """Returns (the mean of each per-image metric and the mean batch test
    loss as host floats, the per-image metrics as numpy arrays). One host
    read at the end."""
    per_img = {k: [] for k in METRICS}
    losses = []
    for batch in batch_iterator(test_ds, batch_sz):
        metrics, value, _, _, _ = eval_batch(params, bn_state, batch["imgs"],
                                             batch["labels"])
        for k in METRICS:
            per_img[k].append(metrics[k])
        losses.append(value)
    host = {k: torch.cat(v).double().cpu().numpy() for k, v in per_img.items()}
    mean = {k: float(v.mean()) for k, v in host.items()}
    mean["test_loss"] = float(torch.stack(losses).double().mean())
    return mean, host


def zy3_test_rows(params, bn_state, test_ds: ArrayDataset, ids,
                  groups: Optional[dict] = None, *, batch_sz: int = 5,
                  policy: Policy = DEFAULT, forward=None):
    """The Excel report's content, computed on the device: one row per
    test image (img_id, acc, miou, group, and the rgb, label, aligned
    pred, Vt and Vd maps, the last two min-max normalized per frame, as
    host arrays), and the summary rows: per-group and overall means, then
    the threshold detector's operating points at the FAR budgets
    DETECTOR_FARS (``metrics/roc.py``), with the foreground branch the one
    whose raw argmax agrees better with the labels overall. ``groups`` maps
    a group name of GROUP_NAMES to its img_ids; an image in none gets group
    -1. Returns (rows, summary_rows)."""
    from onet_tpu_torch.metrics.roc import dr_at_far, fg_score
    from onet_tpu_torch.ops.normalize import minmax_per_frame

    eval_batch = make_zy3_eval(policy=policy, forward=forward)
    group_of = {}
    for gi, gname in enumerate(GROUP_NAMES):
        for img_id in (groups or {}).get(gname, []):
            group_of[str(img_id)] = gi
    parts = {k: [] for k in ("acc", "miou", "rgb", "label", "pred", "vt",
                             "vd")}
    for batch in batch_iterator(test_ds, batch_sz):
        metrics, _, aligned, vt, vd = eval_batch(params, bn_state,
                                                 batch["imgs"],
                                                 batch["labels"])
        parts["acc"].append(metrics["acc"])
        parts["miou"].append(metrics["miou"])
        parts["rgb"].append(batch["imgs"])
        parts["label"].append(batch["labels"])
        parts["pred"].append(aligned)
        parts["vt"].append(vt)
        parts["vd"].append(vd)
    dev = {k: torch.cat(v) for k, v in parts.items()}
    vt_all, vd_all, lab_all = dev["vt"], dev["vd"], dev["label"]
    # the detector's foreground branch: whichever raw branch argmax agrees
    # better with the labels overall
    agree = torch.mean(((vd_all > vt_all) == (lab_all > 0)).to(torch.float32))
    fg_is_down = float(agree) >= 0.5
    det = dr_at_far(fg_score(vt_all, vd_all, fg_is_down=fg_is_down),
                    lab_all, DETECTOR_FARS)
    dev["vt"] = minmax_per_frame(vt_all)
    dev["vd"] = minmax_per_frame(vd_all)
    host = {k: v.to(torch.float32).cpu().numpy() for k, v in dev.items()}
    rows = []
    for idx in range(host["acc"].shape[0]):
        img_id = str(ids[idx]) if idx < len(ids) else f"img_{idx:04d}"
        rows.append({"img_id": img_id,
                     "acc": float(host["acc"][idx]),
                     "miou": float(host["miou"][idx]),
                     "group": group_of.get(img_id, -1),
                     **{k: host[k][idx] for k in ("rgb", "label", "pred",
                                                  "vt", "vd")}})
    summary_rows = []
    for gi, gname in enumerate(GROUP_NAMES):
        sub = [r for r in rows if r["group"] == gi]
        if sub:
            summary_rows.append({
                "group": gname, "n": len(sub),
                "acc": float(np.mean([r["acc"] for r in sub])),
                "miou": float(np.mean([r["miou"] for r in sub]))})
    summary_rows.append({"group": "all", "n": len(rows),
                         "acc": float(np.mean([r["acc"] for r in rows])),
                         "miou": float(np.mean([r["miou"] for r in rows]))})
    for budget, (far_a, dr, thr) in det.items():
        summary_rows.append({"group": f"detector@far<={budget:g}",
                             "n": len(rows), "dr": float(dr),
                             "far": float(far_a), "threshold": float(thr)})
    logging.info("Detector operating points: %s",
                 {b: round(v[1], 4) for b, v in det.items()})
    return rows, summary_rows


def write_zy3_report(out_path: str, rows, summary_rows):
    """The workbook of ``zy3_test_rows``' output: the rows with their
    thumbnails, and the summary sheet. Returns (path, summary DataFrame)."""
    import pandas as pd

    from onet_tpu_torch.report.tables import save_zy3_excel_report

    summary = pd.DataFrame(summary_rows)
    return save_zy3_excel_report(out_path, rows, summary), summary


def save_zy3_test_results(out_path: str, params, bn_state,
                          test_ds: ArrayDataset, ids,
                          groups: Optional[dict] = None, *,
                          batch_sz: int = 5, policy: Policy = DEFAULT,
                          draw: bool = False, draw_all: bool = False,
                          epoch: Optional[int] = None,
                          model_name: str = "onet_zy3", forward=None):
    """The Excel report with embedded thumbnails and the per-group summary
    (save_zy3_test_results_to_excel / save_results_to_excel,
    uti_zy3_test_20240123.py:320-429,541-591): ``zy3_test_rows`` then
    ``write_zy3_report``. ``draw`` also saves draw_test_res's 5x5 grids
    beside the report (matplotlib). Returns (path, summary DataFrame)."""
    rows, summary_rows = zy3_test_rows(params, bn_state, test_ds, ids,
                                       groups, batch_sz=batch_sz,
                                       policy=policy, forward=forward)
    path, summary = write_zy3_report(out_path, rows, summary_rows)
    overall = next(r for r in summary_rows if r["group"] == "all")
    logging.info("Overall testset Accuracy %.4f, mIoU %.4f",
                 overall["acc"], overall["miou"])
    if draw:
        from onet_tpu_torch.report.curves import save_test_res_grids
        save_test_res_grids(
            os.path.dirname(out_path) or ".", model_name, rows,
            test_loss=0.0, acc=overall["acc"], miou=overall["miou"],
            epoch=epoch, draw_all=draw_all)
    return path, summary


def train(config: Zy3Config, train_ds: ArrayDataset, test_ds: ArrayDataset,
          *, policy: Policy = DEFAULT, mesh=None, log: bool = True,
          progress_cb=None, device=None):
    """Run the workload on ``device``. Returns (params, bn_state,
    history): history["loss"] per epoch, history["eval"] {epoch: metrics}
    and, after a SIGTERM drain, history["preempted"] (the epoch it cut).
    ``progress_cb(epoch, loss, metrics)`` is called after each epoch's
    eval."""
    arch = get_arch(config.arch, swin_window=config.swin_window,
                    swin_embed=config.swin_embed,
                    convnext_embed=config.convnext_embed,
                    transunet_embed=config.transunet_embed,
                    transunet_depth=config.transunet_depth)
    dev = resolve_device(device)
    stream = RngStream(config.seed, device=dev)
    g_model = stream.next(device="cpu")      # onet_init draws on the CPU
    loop_seed = stream.next_seed()

    params, bn_state = arch.init(g_model, config.in_channels,
                                 weight_share=config.weight_share,
                                 base=config.base_channels, device=dev)
    opt_state = adam_init(params)
    start_epoch = 0
    if config.restart_from:
        params, bn_state, last, opt_loaded = load_checkpoint(
            config.restart_from, params, bn_state, opt_template=opt_state)
        start_epoch = last + 1
        if opt_loaded is not None:
            opt_state = opt_loaded
        elif log:
            logging.warning("Checkpoint %s has no optimizer state; Adam "
                            "moments restart from zero", config.restart_from)
    fwd = None if arch.vanilla else arch.forward
    train_step = make_train_step(policy=policy, mesh=mesh, forward=fwd,
                                 loss=config.loss)
    eval_batch = make_zy3_eval(policy=policy, forward=fwd, loss=config.loss)
    lead = mesh is None or mesh.rank == mesh.ranks[0]
    log = log and lead
    world = None if mesh is None else mesh.world

    if log:
        setup_logging(config.out_root, config.model_name)

    history = {"loss": [], "eval": {}}
    mark = datehour_mark()
    guard = PreemptGuard(config.preempt_save).install()
    try:
        for epoch in range(start_epoch, config.epoch_nums):
            lr = cosine_warm_restarts(config.base_lr, epoch, t0=config.t0,
                                      t_mult=config.t_mult,
                                      eta_min=config.eta_min)
            losses = []
            g_epoch = make_generator(derive_seed(loop_seed, epoch), dev)
            for batch in batch_iterator(train_ds, config.batch_sz,
                                        gen=g_epoch):
                x = batch["imgs"]
                if config.aug:
                    from onet_tpu_torch.data.augment import augment_batch
                    x = augment_batch(g_epoch, x)
                params, bn_state, opt_state, loss = train_step(
                    params, bn_state, opt_state, x, lr)
                losses.append(loss)
                if guard.triggered_on_any(world, dev):
                    break
            if guard.settled_on_any(world):
                # the cut epoch is recorded as NOT done: restart_from redoes
                # it in full
                path = os.path.join(
                    config.out_root,
                    f"{config.model_name}_preempt{max(epoch - 1, 0)}"
                    f"_{mark}.npz")
                if lead:
                    save_checkpoint(path, params, bn_state, epoch - 1,
                                    opt_state=opt_state,
                                    meta=arch_meta(config))
                history["preempted"] = epoch
                msg = (f"SIGTERM: preempted at epoch {epoch}; checkpoint "
                       f"saved -> {path} (pass restart_from to continue)")
                if log:
                    print(msg)
                    logging.warning(msg)
                break
            loss_epoch = float(torch.mean(torch.stack(losses)))
            history["loss"].append(loss_epoch)

            metrics, _ = evaluate_zy3(eval_batch, params, bn_state, test_ds,
                                      config.batch_sz)
            history["eval"][epoch] = metrics
            line = ("%s===Epoch: %04d, Training loss: %.2E, lr: %.2E,"
                    "miou %.4f acc %.4f" % (config.model_name, epoch,
                                            loss_epoch, lr, metrics["miou"],
                                            metrics["acc"]))
            if log:
                print(line)
                logging.info(line)
            if progress_cb:
                progress_cb(epoch, loss_epoch, metrics)

            if lead and (epoch == config.epoch_nums - 1
                         or epoch in config.save_epochs):
                path = os.path.join(
                    config.out_root,
                    f"{config.model_name}_epoch{epoch}_{mark}.npz")
                save_checkpoint(path, params, bn_state, epoch,
                                opt_state=opt_state, meta=arch_meta(config))
                if log:
                    logging.info("Saved checkpoint: %s", path)
    finally:
        guard.restore()
    if log and can_draw():
        from onet_tpu_torch.report.curves import save_training_curves

        save_training_curves(
            os.path.join(config.out_root,
                         f"{config.model_name}_train_loss_{mark}.png"),
            history["loss"], history["eval"])
    return params, bn_state, history


def make_supervised_train_step(*, policy: Policy = DEFAULT, mesh=None):
    """The supervised fine-tuning step: (params, bn_state, opt_state, x,
    labels, lr) -> (params, bn_state, opt_state, loss), a pixel-wise cross
    entropy on the class-probability map S (the reference defines the
    supervised ZY-3 datasets but no supervised objective). Params and Adam
    state are updated in place, as ``make_train_step``'s. ``mesh``: data
    parallel over its ``data`` axis, on the global batch and labels."""

    def cross_entropy(params, bn_state, x, labels):
        out, new_bn = onet_forward(params, bn_state, x, train=True,
                                   policy=policy)
        logp = torch.log(torch.clamp(out.S, 1e-8, 1.0))
        y = labels.to(torch.int64)[..., None]
        return -torch.mean(torch.gather(logp, -1, y)), new_bn

    return make_grad_step(cross_entropy, policy, mesh=mesh)
