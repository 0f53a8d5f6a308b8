"""onet-tpu in PyTorch for one NVIDIA H100.

A port of the JAX package ``onet_tpu`` beside it. Module names mirror the
JAX package so each function's counterpart is found under the same path.
The public functions take and return NHWC tensors (the JAX layout) and
parameter dicts with the JAX tree's keys. Entry points run on the card
unless the caller passes ``device="cpu"``.

This package imports ``torch`` and never ``jax`` or ``onet_tpu``.
"""
