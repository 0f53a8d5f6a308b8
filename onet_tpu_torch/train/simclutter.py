"""Workload 1: unsupervised Onet training on simulated sea clutter
(``onet_tpu/train/simclutter.py``).

The reference's Train_Onet_on_simclutter_20250407.py, rebuilt:
* the data is generated on the device (``sim/``) instead of loaded from
  .pt files, and stays there; batches are device-side gathers by a
  permutation drawn per epoch;
* one train step per batch (``train/steps.py``), which updates params and
  Adam state in place;
* eval every ``eval_every`` epochs and at the last, with the flip
  alignment and the (acc, miou, dr, far, tiou) bundle, batch-averaged;
* Adam at lr 5e-6 halved every 100 epochs, checkpoints at the final epoch
  and epoch 300, the reference's epoch log lines.

Beyond the reference, as in the JAX package: resume from the newest
checkpoint, rotated autosaves, and a SIGTERM drain that checkpoints and
returns. ``device`` (default: the card; raises without one) is the one
argument the JAX package has no counterpart to. ``quantized`` trains with
int8 conv arithmetic (``models/qtrain.py``, the vanilla backbone only);
``arch`` picks the backbone family (``models/arch.py``).

``mesh`` (``core/mesh.py``) trains data parallel; with ``spatial`` by
halo exchange (``parallel/halo.py``), with ``pipeline_microbatches`` by
the GPipe pipeline (``parallel/pipeline.py``), refused where the JAX
package refuses them. Every rank runs this function: each generates the
same seeded data and its steps take their rows of each global batch, so
every rank holds the same parameters. Only the first rank of the mesh
writes checkpoints, logs and curves; every rank resumes from them. A
SIGTERM on any rank stops every rank at the same step.

Random streams come from ``core/prng.py`` (seed -> data, model, loop);
each epoch's shuffle and augmentation draw from a generator derived from
(loop seed, epoch), so a resumed epoch draws what it would have drawn.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from onet_tpu_torch.core.checkpoint import (
    AsyncCheckpointWriter, datehour_mark, latest_checkpoint,
    load_checkpoint)
from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.core.prng import RngStream, derive_seed, make_generator
from onet_tpu_torch.data.arrays import ArrayDataset, batch_iterator
from onet_tpu_torch.data.simclutter import simclutter_datasets
from onet_tpu_torch.models.arch import arch_meta, get_arch
from onet_tpu_torch.models.unet import param_count
from onet_tpu_torch.report.logs import epoch_log_line, setup_logging
from onet_tpu_torch.train.optim import adam_init, step_decay
from onet_tpu_torch.train.preempt import PreemptGuard
from onet_tpu_torch.train.steps import make_eval_step, make_train_step


@dataclasses.dataclass
class SimclutterConfig:
    model_name: str = "onet_rayleigh"
    epoch_nums: int = 301
    batch_sz: int = 10
    input_sz: int = 224
    in_channels: int = 1
    weight_share: bool = True
    binit: bool = True
    low_snr: int = 0
    high_snr: int = 2
    # clutter family: "rayleigh" or "k" (the reference's bg_type)
    bg: str = "rayleigh"
    frames_per_level: int = 150
    base_lr: float = 1e-5 / 2
    lr_decay_every: int = 100
    lr_decay: float = 0.5
    eval_every: int = 50
    out_root: str = "./checkpoint/sim_clutter"
    seed: int = 1981
    base_channels: int = 64
    save_epochs: tuple = (300,)
    # complement-input bias: X_d = clip(1 - X + bias, 0, 1)
    bias: float = 0.0
    # the reference's pixel augmentation on train batches (its published
    # config runs without it)
    aug: bool = False
    # resume from the newest checkpoint under out_root; autosaves every N
    # epochs with keep-last-k rotation (0 disables)
    resume: bool = False
    autosave_every: int = 0
    autosave_keep: int = 3
    # on SIGTERM finish the current step, checkpoint into the autosave
    # namespace and return (main thread only)
    preempt_save: bool = True
    # int8 training arithmetic (models/qtrain.py): None = exact, "fwd" =
    # int8 forward convs, "fwd+dx" = also the input-gradient convs
    quantized: str = None
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


def _check_parallel(config, arch, mesh, pipeline_microbatches, spatial):
    """The JAX package's refusals of the parallel options."""
    if pipeline_microbatches:
        if mesh is None:
            raise ValueError("pipeline_microbatches requires a "
                             "('data', 'stage') mesh")
        if config.quantized:
            raise ValueError("pipeline training is exact-arithmetic only")
        if not arch.vanilla:
            raise ValueError("pipeline stages are defined on the vanilla "
                             "conv U-Net only")
        if config.loss != "jsd":
            raise ValueError("pipeline training uses the jsd objective "
                             "(the per-microbatch schedule fixes the loss)")
    elif spatial:
        if mesh is None:
            raise ValueError("spatial=True requires a ('data','space'"
                             "[,'spacew']) mesh")
        if config.quantized:
            raise ValueError("spatial training is exact-arithmetic only")
        if not arch.vanilla or config.loss != "jsd":
            raise ValueError("spatial training is defined on the vanilla "
                             "conv U-Net with the jsd objective")


def _steps(config, policy, fwd, mesh, pipeline_microbatches, spatial):
    """(train_step, eval_step) for the driver's options."""
    kw = dict(policy=policy, bias=config.bias)
    if pipeline_microbatches:
        from onet_tpu_torch.parallel.pipeline import make_pp_train_step
        return (make_pp_train_step(mesh, microbatches=pipeline_microbatches,
                                   **kw),
                make_eval_step(align="flip", **kw))
    if spatial:
        from onet_tpu_torch.parallel.halo import make_spatial_train_step
        train_step = make_spatial_train_step(mesh, **kw)
        eval_step = make_eval_step(align="flip", mesh=mesh, **kw)
    else:
        train_step = make_train_step(mesh=mesh, quantized=config.quantized,
                                     forward=fwd, loss=config.loss, **kw)
        eval_step = make_eval_step(align="flip", mesh=mesh, forward=fwd,
                                   loss=config.loss, **kw)
    if mesh is None:
        return train_step, eval_step
    # an eval batch the data axis does not divide runs the plain eval
    n_data = mesh.shape.get("data", mesh.size)
    eval_mesh = eval_step
    eval_plain = make_eval_step(align="flip", forward=fwd, loss=config.loss,
                                **kw)

    def eval_any(p, b, x, labels):
        if x.shape[0] % n_data == 0:
            return eval_mesh(p, b, x, labels)
        return eval_plain(p, b, x, labels)

    return train_step, eval_any


def evaluate(eval_step, params, bn_state, test_ds: ArrayDataset,
             batch_sz: int):
    """Batch-averaged metric bundle (the reference's test_simclutter)."""
    sums, n = None, 0
    for batch in batch_iterator(test_ds, batch_sz):
        metrics, loss, _ = eval_step(params, bn_state, batch["imgs"],
                                     batch["labels"])
        metrics = {k: float(v) for k, v in metrics.items()}
        sums = metrics if sums is None else {k: sums[k] + metrics[k]
                                             for k in sums}
        n += 1
    return {k: v / n for k, v in sums.items()}


def train(config: SimclutterConfig = SimclutterConfig(), *,
          policy: Policy = DEFAULT, mesh=None,
          pipeline_microbatches: int = None, spatial: bool = False,
          datasets=None, log: bool = True, progress_cb=None, device=None):
    """Run the workload on ``device``. Returns (params, bn_state,
    history): history["loss"] per epoch, history["eval"] {epoch: metrics}
    and, after a SIGTERM drain, history["preempted"] (the epoch it cut).
    ``datasets=(train, test)`` skips generation.

    ``pipeline_microbatches``: the GPipe step on a ``('data', 'stage')``
    ``mesh``; eval stays one replicated graph, and a batch that does not
    split into microbatches x data shards is skipped. ``spatial``: the
    halo-exchange step on a ``('data', 'space'[, 'spacew'])`` mesh; eval
    splits the batch over ``data``. Either way an eval batch that the
    ``data`` axis does not divide runs the plain eval on every rank."""
    arch = get_arch(config.arch, swin_window=config.swin_window,
                    swin_embed=config.swin_embed,
                    convnext_embed=config.convnext_embed,
                    transunet_embed=config.transunet_embed,
                    transunet_depth=config.transunet_depth)
    _check_parallel(config, arch, mesh, pipeline_microbatches, spatial)
    dev = resolve_device(device)
    stream = RngStream(config.seed, device=dev)
    g_data = stream.next()
    g_model = stream.next(device="cpu")      # onet_init draws on the CPU
    loop_seed = stream.next_seed()

    if datasets is None:
        train_ds, test_ds = simclutter_datasets(
            g_data, low_snr=config.low_snr, high_snr=config.high_snr,
            frames_per_level=config.frames_per_level, crop=config.input_sz,
            bg=config.bg, device=dev)
    else:
        train_ds, test_ds = datasets

    params, bn_state = arch.init(g_model, config.in_channels,
                                 weight_share=config.weight_share,
                                 base=config.base_channels, device=dev)
    fwd = None if arch.vanilla else arch.forward
    opt_state = adam_init(params)
    train_step, eval_step = _steps(config, policy, fwd, mesh,
                                   pipeline_microbatches, spatial)
    lead = mesh is None or mesh.rank == mesh.ranks[0]
    log = log and lead
    world = None if mesh is None else mesh.world

    if log:
        setup_logging(config.out_root, config.model_name)
        logging.info("train simclutter: %d frames, %.1fM params",
                     len(train_ds), param_count(params) / 1e6)

    history = {"loss": [], "eval": {}}
    mark = datehour_mark()
    writer = AsyncCheckpointWriter()
    # SIGTERM sets a flag; the loop drains the current step, checkpoints
    # and returns. try/finally so an exception escaping the loop still
    # restores the previous handler for long-lived in-process callers.
    guard = PreemptGuard(config.preempt_save).install()
    try:
        start_epoch = 0
        if config.resume:
            ck = latest_checkpoint(config.out_root)
            if ck:
                params, bn_state, last, opt_loaded = load_checkpoint(
                    ck, params, bn_state, opt_template=opt_state)
                start_epoch = last + 1
                if opt_loaded is not None:
                    opt_state = opt_loaded
                elif log:
                    logging.warning(
                        "Checkpoint %s has no optimizer state; Adam moments "
                        "and step count restart from zero", ck)
                if log:
                    logging.info("Resumed from %s (epoch %d)", ck, last)
        for epoch in range(start_epoch, config.epoch_nums):
            lr = step_decay(config.base_lr, epoch, every=config.lr_decay_every,
                            factor=config.lr_decay)
            losses = []
            g_epoch = make_generator(derive_seed(loop_seed, epoch), dev)
            for batch in batch_iterator(train_ds, config.batch_sz,
                                        gen=g_epoch):
                x = batch["imgs"]
                if pipeline_microbatches and x.shape[0] % (
                        pipeline_microbatches * mesh.shape.get("data", 1)):
                    # GPipe needs full microbatches: the ragged tail is
                    # dropped (shuffled each epoch, so no frame always)
                    continue
                if config.aug:
                    from onet_tpu_torch.data.augment import (
                        simclutter_pixel_augment)
                    x = simclutter_pixel_augment(g_epoch, x)
                params, bn_state, opt_state, loss = train_step(
                    params, bn_state, opt_state, x, lr)
                losses.append(loss)
                if guard.triggered_on_any(world, dev):
                    break
            if guard.settled_on_any(world):
                # checkpoint into the autosave namespace (auto-resume finds
                # it; rotation keeps it inside autosave_keep). The cut epoch
                # is recorded as NOT done (epoch - 1): resume redoes it.
                path = os.path.join(
                    config.out_root,
                    f"{config.model_name}_autosave_{max(epoch - 1, 0)}"
                    f"_{mark}.npz")
                if lead:
                    writer.save(path, params, bn_state, epoch - 1,
                                opt_state=opt_state, meta=arch_meta(config))
                history["preempted"] = epoch
                msg = (f"SIGTERM: preempted at epoch {epoch}; checkpoint "
                       f"saved -> {path} (resume=True continues)")
                if log:
                    print(msg)
                    logging.warning(msg)
                break
            if not losses:
                raise ValueError(
                    f"every batch was dropped: no batch of {config.batch_sz} "
                    "divides into the pipeline's microbatches x data shards")
            loss_epoch = float(torch.mean(torch.stack(losses)))
            history["loss"].append(loss_epoch)

            if epoch % config.eval_every == 0 or epoch == config.epoch_nums - 1:
                metrics = evaluate(eval_step, params, bn_state, test_ds,
                                   config.batch_sz)
                history["eval"][epoch] = metrics
                line = epoch_log_line(config.model_name, epoch, loss_epoch, lr,
                                      metrics)
                if log:
                    print(line)
                    logging.info(line)
                if progress_cb:
                    progress_cb(epoch, loss_epoch, metrics)

            autosave = (config.autosave_every
                        and epoch % config.autosave_every == 0)
            milestone = (epoch == config.epoch_nums - 1
                         or epoch in config.save_epochs)
            if lead and (milestone or autosave):
                # autosaves have their own file name namespace, so rotation
                # never deletes a milestone (or another model's file)
                tag = "epoch" if milestone else "autosave"
                path = os.path.join(
                    config.out_root,
                    f"{config.model_name}_{tag}_{epoch}_{mark}.npz")
                # the host copy is synchronous (the step updates in place);
                # the write and the rotation overlap the next epochs, and
                # writer.wait() below raises any I/O error
                writer.save(path, params, bn_state, epoch,
                            opt_state=opt_state, meta=arch_meta(config),
                            rotate=None if milestone else (
                                config.out_root, config.autosave_keep,
                                f"{config.model_name}_autosave_*.npz"))
                if log:
                    logging.info("Saved checkpoint at epoch %d: %s", epoch, path)

        writer.wait()
    finally:
        guard.restore()
    if log:
        from onet_tpu_torch.report.curves import save_training_curves

        save_training_curves(
            os.path.join(config.out_root,
                         f"{config.model_name}_train_loss_{mark}.png"),
            history["loss"], history["eval"])
    return params, bn_state, history
