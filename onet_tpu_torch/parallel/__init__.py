"""Parallel training over ``torch.distributed`` (``onet_tpu/parallel/``):
exact spatial partitioning by halo exchange, exact channel tensor
parallelism, the GPipe pipeline, the collectives they run on and the
multi-process bootstrap. Data parallelism is ``train/steps.py`` on a
``core/mesh.py`` mesh."""

from onet_tpu_torch.parallel.halo import (
    make_halo_ops,
    make_spatial_train_step,
)
from onet_tpu_torch.parallel.tensor import (
    MODEL_AXIS,
    make_tp_train_step,
)
