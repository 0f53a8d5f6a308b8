"""The training loop the comparison baselines share
(``onet_tpu/train/baseline.py``).

InfoSeg (``train/infoseg.py``) and IIC (``train/iic.py``) differ only in
the model and the objective: both train on the simulated clutter sets over
shuffled drop-last batches, evaluate with the Hungarian-aligned metric
bundle every ``eval_every`` epochs and at the last, log the reference's
epoch lines, drain on SIGTERM (``train/preempt.py``) and save one final
checkpoint in the JAX package's file format.

Each epoch draws its shuffle (and IIC its views) from a generator derived
from (loop seed, epoch), as the other drivers do.
"""

from __future__ import annotations

import logging
import os

import torch

from onet_tpu_torch.core.checkpoint import datehour_mark, save_checkpoint
from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.prng import derive_seed, make_generator
from onet_tpu_torch.data.arrays import ArrayDataset, batch_iterator
from onet_tpu_torch.report.logs import epoch_log_line, setup_logging
from onet_tpu_torch.train.optim import step_decay
from onet_tpu_torch.train.preempt import PreemptGuard


def evaluate(eval_step, params, state, test_ds: ArrayDataset,
             batch_sz: int):
    """The metric bundle averaged over the test batches; one host read."""
    rows, keys = [], None
    for batch in batch_iterator(test_ds, batch_sz):
        m = eval_step(params, state, batch["imgs"], batch["labels"])
        keys = keys or sorted(m)
        rows.append(torch.stack([m[k].float() for k in keys]))
    means = torch.stack(rows).double().mean(0).tolist()
    return dict(zip(keys, means))


def baseline_training_loop(config, params, state, opt_state, train_step,
                           eval_step, train_ds, test_ds, loop_seed: int, *,
                           step_takes_gen: bool = False, log: bool = True,
                           tag: str = "baseline", device=None):
    """The common epoch loop. ``config`` needs model_name, epoch_nums,
    batch_sz, base_lr, lr_decay_every, lr_decay, eval_every and out_root.
    ``train_step(params, state, opt, x[, gen], lr)`` (the epoch's
    generator where ``step_takes_gen``). Returns (params, state, history):
    history["loss"] per epoch, history["eval"] {epoch: metrics} and, after
    a SIGTERM drain, history["preempted"]."""
    dev = resolve_device(device)
    if log:
        setup_logging(config.out_root, config.model_name)
    history = {"loss": [], "eval": {}}
    guard = PreemptGuard().install()
    try:
        for epoch in range(config.epoch_nums):
            lr = step_decay(config.base_lr, epoch,
                            every=config.lr_decay_every,
                            factor=config.lr_decay)
            losses = []
            g_epoch = make_generator(derive_seed(loop_seed, epoch), dev)
            args = (g_epoch,) if step_takes_gen else ()
            for batch in batch_iterator(train_ds, config.batch_sz,
                                        gen=g_epoch, drop_last=True):
                params, state, opt_state, loss = train_step(
                    params, state, opt_state, batch["imgs"], *args, lr)
                losses.append(loss)
                if guard.triggered:
                    break
            if guard.triggered:
                # the cut epoch is recorded as NOT done
                path = os.path.join(
                    config.out_root,
                    f"{config.model_name}_preempt{max(epoch - 1, 0)}"
                    f"_{datehour_mark()}.npz")
                save_checkpoint(path, params, state, epoch - 1, opt_state)
                history["preempted"] = epoch
                if log:
                    msg = (f"SIGTERM: preempted at epoch {epoch}; "
                           f"checkpoint saved -> {path}")
                    print(msg)
                    logging.warning(msg)
                return params, state, history
            loss_epoch = float(torch.mean(torch.stack(losses)))
            history["loss"].append(loss_epoch)
            if epoch % config.eval_every == 0 or \
                    epoch == config.epoch_nums - 1:
                metrics = evaluate(eval_step, params, state, test_ds,
                                   config.batch_sz)
                history["eval"][epoch] = metrics
                if log:
                    line = epoch_log_line(config.model_name, epoch,
                                          loss_epoch, lr, metrics)
                    print(line)
                    logging.info(line)

        path = os.path.join(
            config.out_root,
            f"{config.model_name}_{datehour_mark()}_epoch_"
            f"{config.epoch_nums - 1}.npz")
        save_checkpoint(path, params, state, config.epoch_nums - 1,
                        opt_state)
        if log:
            print(f"[{tag}] checkpoint: {path}")
        return params, state, history
    finally:
        guard.restore()
