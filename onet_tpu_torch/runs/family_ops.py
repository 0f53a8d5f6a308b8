"""Operations one train step of each model family dispatches, counted
without a card.

    python -m onet_tpu_torch.runs.family_ops [--hw 224] [--batch 5]

The step (``train/steps.py::make_train_step`` for the Onet families,
``train/iic.py`` / ``train/infoseg.py``'s for the baselines) runs once on
PyTorch's ``meta`` device at full width: shapes only, no arithmetic, so
the count costs seconds on any host. Two numbers a family:

* ``launches``: the operations that would run a kernel, every aten call
  the step dispatches except views and allocations (an eager step
  launches about one kernel for each; a few launch none or two);
* ``flops``: the matmul and conv operations (``FlopCounterMode``), 2 per
  multiply-add, forward and backward.

Prints one JSON line a family. ``launches`` times the host's cost per
launch bounds an eager step from below where the card waits on the host;
``flops`` over the card's rate bounds it where the card is the limit.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from onet_tpu_torch.core.policy import BF16_COMPUTE

_NO_KERNEL = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "lift_fresh", "detach", "alias"}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and \
                func.overloadpacket.__name__ not in _NO_KERNEL:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _onet_step(name, hw, batch):
    from onet_tpu_torch.models.arch import get_arch
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    arch = get_arch(name)
    cin = 3
    params, state = arch.init(torch.Generator().manual_seed(0), cin,
                              device="meta")
    opt = adam_init(params)
    step = make_train_step(policy=BF16_COMPUTE,
                           forward=None if arch.vanilla else arch.forward)
    x = torch.empty((batch, hw, hw, cin), device="meta")
    return params, lambda: step(params, state, opt, x, 1e-4)


def _baseline_step(name, hw, batch):
    from onet_tpu_torch.train.optim import adam_init

    x = torch.empty((batch, hw, hw, 1), device="meta")
    gen = torch.Generator().manual_seed(0)
    if name == "iic":
        from onet_tpu_torch.models.iic import (PairMeta, iic_init,
                                               iic_pair_loss)
        from onet_tpu_torch.train.steps import make_grad_step
        params, state = iic_init(gen, 1, device="meta")
        flips = torch.zeros(batch, dtype=torch.bool, device="meta")
        shifts = torch.zeros(batch, dtype=torch.int64, device="meta")
        meta = PairMeta(flips, flips, shifts, shifts)
        step = make_grad_step(
            lambda p, s, x: iic_pair_loss(p, s, x, x, meta,
                                          policy=BF16_COMPUTE),
            BF16_COMPUTE)
    else:
        from onet_tpu_torch.models.infoseg import infoseg_init
        from onet_tpu_torch.train.infoseg import make_infoseg_train_step
        params, state = infoseg_init(gen, 1, device="meta")
        step = make_infoseg_train_step(BF16_COMPUTE)
    opt = adam_init(params)
    return params, lambda: step(params, state, opt, x, 1e-4)


def count(name: str, hw: int, batch: int) -> dict:
    """{"family", "launches", "flops", "params"} of one train step."""
    from onet_tpu_torch.models.unet import param_count

    make = _baseline_step if name in ("iic", "infoseg") else _onet_step
    params, run = make(name, hw, batch)
    counter = _Count()
    with counter:
        run()
    flops = FlopCounterMode(display=False)
    with flops:
        run()
    return {"family": name, "hw": hw, "batch": batch,
            "launches": counter.n, "flops": flops.get_total_flops(),
            "params": param_count(params)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hw", type=int, default=224)
    ap.add_argument("--batch", type=int, default=5,
                    help="frames a step (the Onet families run 2x that)")
    ap.add_argument("--families", default="vanilla,swin,convnext,"
                    "transunet,iic,infoseg")
    args = ap.parse_args(argv)
    for name in args.families.split(","):
        batch = 10 if name in ("iic", "infoseg") else args.batch
        print(json.dumps(count(name, args.hw, batch)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
