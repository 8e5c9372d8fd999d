"""IEEE fp32 matrix products for the duration of a call.

The JAX package runs its fit under ``jax.default_matmul_precision
("highest")``. The PyTorch counterpart turns TF32 off for cuBLAS and
cuDNN and sets the float32 matmul precision to "highest", and restores
the caller's settings on exit.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_fp32():
    old = (torch.get_float32_matmul_precision(),
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cuda.matmul.allow_tf32 = old[1]
        torch.backends.cudnn.allow_tf32 = old[2]
