"""IIC baseline training on simulated clutter (``onet_tpu/train/iic.py``).

Each step draws one view pair from the epoch's generator; both views go
through one [2N] forward (shared BN statistics), and the IIC objective
couples them through the displacement-window joint (``models/iic.py``).
The loop is the baselines' shared one (``train/baseline.py``); the data
are the simulated clutter sets, generated on ``device`` (default: the
card; raises without one).
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
from onet_tpu_torch.models.iic import (
    get_label, iic_forward, iic_init, iic_pair_loss, iic_pair_transform)
from onet_tpu_torch.train.baseline import baseline_training_loop
from onet_tpu_torch.train.optim import adam_init
from onet_tpu_torch.train.steps import make_grad_step


@dataclasses.dataclass
class IICConfig:
    model_name: str = "iic_simbg"
    epoch_nums: int = 60
    batch_sz: int = 10
    input_sz: int = 224
    in_channels: int = 1
    k_classes: int = 2
    k_aux: int = 6
    low_snr: int = 0
    high_snr: int = 2
    frames_per_level: int = 150
    base_lr: float = 1e-4
    lr_decay_every: int = 30
    lr_decay: float = 0.5
    eval_every: int = 10
    out_root: str = "./checkpoint/iic"
    seed: int = 1981
    base_channels: int = 64
    max_shift: int = 2
    window_radius: int = 1
    mi_lambda: float = 1.0


def make_iic_train_step(config: IICConfig, policy: Policy = DEFAULT):
    """(params, state, opt_state, x, gen, lr) -> (params, state,
    opt_state, loss): the view pair drawn from ``gen``, Adam in place."""
    def loss_fn(params, state, x, gen):
        x2, meta = iic_pair_transform(gen, x, max_shift=config.max_shift)
        return iic_pair_loss(params, state, x, x2, meta, policy=policy,
                             radius=config.window_radius,
                             lam=config.mi_lambda)

    return make_grad_step(loss_fn, policy)


def make_iic_eval_step(policy: Policy = DEFAULT):
    """(params, state, x, labels) -> the Hungarian-aligned metric bundle."""
    def step(params, state, x, labels):
        with torch.no_grad(), policy.precision():
            out, _ = iic_forward(params, state, x, train=False,
                                 policy=policy)
            lab = labels.to(torch.int32)
            pred = align_labels_hungarian(get_label(out.probs), lab)
            return evaluate_binary_segmentation(pred, lab)

    return step


def train(config: IICConfig = IICConfig(), *, policy: Policy = DEFAULT,
          datasets=None, log: bool = True, device=None):
    """Train the IIC baseline on ``device``. Returns (params, state,
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
    params, state = iic_init(g_model, config.in_channels, config.k_classes,
                             k_aux=config.k_aux, base=config.base_channels,
                             device=dev)
    return baseline_training_loop(
        config, params, state, adam_init(params),
        make_iic_train_step(config, policy), make_iic_eval_step(policy),
        train_ds, test_ds, loop_seed, step_takes_gen=True, log=log,
        tag="iic", device=dev)
