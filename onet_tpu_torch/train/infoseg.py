"""InfoSeg baseline training on simulated clutter ("InfoSeg_Simbg",
``onet_tpu/train/infoseg.py``).

The reference trains its InfoSeg on the simulated background set and
evaluates it on NAU rain frames beside Onet and CFAR; this driver follows
that recipe with ``models/infoseg.py``: clutter generated on ``device``
(default: the card; raises without one), the baselines' shared loop
(``train/baseline.py``), Hungarian-aligned evaluation.
"""

from __future__ import annotations

import dataclasses

import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.core.prng import RngStream
from onet_tpu_torch.data.simclutter import simclutter_datasets
from onet_tpu_torch.metrics.segmentation import (
    align_labels_hungarian, evaluate_binary_segmentation)
from onet_tpu_torch.models.infoseg import (
    compute_infoseg_loss, get_label, infoseg_forward, infoseg_init)
from onet_tpu_torch.train.baseline import baseline_training_loop
from onet_tpu_torch.train.optim import adam_init
from onet_tpu_torch.train.steps import make_grad_step


@dataclasses.dataclass
class InfoSegConfig:
    model_name: str = "infoseg_simbg"
    epoch_nums: int = 60
    batch_sz: int = 10
    input_sz: int = 224
    in_channels: int = 1
    k_classes: int = 2
    low_snr: int = 0
    high_snr: int = 2
    frames_per_level: int = 150
    base_lr: float = 1e-4
    lr_decay_every: int = 30
    lr_decay: float = 0.5
    eval_every: int = 10
    out_root: str = "./checkpoint/infoseg"
    seed: int = 1981
    base_channels: int = 64


def infoseg_loss(params, state, x, *, policy: Policy = DEFAULT):
    """The train step's objective: (loss, new_state)."""
    out, ns = infoseg_forward(params, state, x, train=True, policy=policy)
    return compute_infoseg_loss(out), ns


def make_infoseg_train_step(policy: Policy = DEFAULT):
    """(params, state, opt_state, x, lr) -> (params, state, opt_state,
    loss), Adam in place."""
    return make_grad_step(
        lambda p, s, x: infoseg_loss(p, s, x, policy=policy), policy)


def make_infoseg_eval_step(policy: Policy = DEFAULT):
    """(params, state, x, labels) -> the Hungarian-aligned metric bundle."""
    def step(params, state, x, labels):
        with torch.no_grad(), policy.precision():
            out, _ = infoseg_forward(params, state, x, train=False,
                                     policy=policy)
            lab = labels.to(torch.int32)
            pred = align_labels_hungarian(get_label(out.probs), lab)
            return evaluate_binary_segmentation(pred, lab)

    return step


def train(config: InfoSegConfig = InfoSegConfig(), *,
          policy: Policy = DEFAULT, datasets=None, log: bool = True,
          device=None):
    """Train the InfoSeg baseline on ``device``. Returns (params, state,
    history); ``datasets=(train, test)`` skips generation."""
    dev = resolve_device(device)
    stream = RngStream(config.seed, device=dev)
    g_data = stream.next()
    g_model = stream.next(device="cpu")      # the init draws on the CPU
    loop_seed = stream.next_seed()
    if datasets is None:
        train_ds, test_ds = simclutter_datasets(
            g_data, low_snr=config.low_snr, high_snr=config.high_snr,
            frames_per_level=config.frames_per_level, crop=config.input_sz,
            device=dev)
    else:
        train_ds, test_ds = datasets
    params, state = infoseg_init(g_model, config.in_channels,
                                 config.k_classes, base=config.base_channels,
                                 device=dev)
    return baseline_training_loop(
        config, params, state, adam_init(params),
        make_infoseg_train_step(policy), make_infoseg_eval_step(policy),
        train_ds, test_ds, loop_seed, log=log, tag="infoseg", device=dev)
