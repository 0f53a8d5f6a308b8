"""Mixed-precision policy for the compute path (``onet_tpu/core/policy.py``).

Parameters stay float32; conv inputs and weights are cast to
``compute_dtype`` and accumulate in float32 (cuDNN and the hand-written
kernels both accumulate bf16 products in float32); the head runs in
float32.

``allow_tf32`` is the counterpart of the JAX policy's matmul precision.
cuDNN runs float32 convolutions in TF32 unless told otherwise, so the
float32 policy turns TF32 off for both cuDNN and cuBLAS: float32 means
float32 (the JAX policy pins ``Precision.HIGHEST`` for the same reason).
The bf16 policy allows TF32: its only float32 products are of
bf16-valued operands, which TF32 represents exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.float32
    allow_tf32: bool = False

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    @contextlib.contextmanager
    def precision(self):
        """Set cuDNN's and cuBLAS's TF32 switches for this policy and
        restore them on exit (the switches are process-wide)."""
        old = (torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.allow_tf32
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = old


DEFAULT = Policy()
# bf16 operands, fp32 accumulation: the production serving policy.
BF16_COMPUTE = Policy(compute_dtype=torch.bfloat16, allow_tf32=True)
