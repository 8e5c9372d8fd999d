"""Matrix-product precision for the duration of a call.

The JAX package runs its fit under ``jax.default_matmul_precision
(precision)``, "highest" by default. The PyTorch counterpart maps the
same names onto the card's two float32 product modes:

* ``"highest"`` and ``"float32"``: IEEE fp32. TF32 is off for cuBLAS and
  cuDNN, the float32 matmul precision is "highest", and the kernel-free
  product (K2) runs its precise split-TF32 mode. This is
  :func:`ieee_fp32`, and every fit ran under it before the argument
  existed.
* ``"high"``, ``"default"``, ``"fastest"``, ``"tensorfloat32"``,
  ``"bfloat16"`` and ``"bfloat16_3x"``: TF32 on cuBLAS products (float32
  matmul precision "high") and on K2's tile·V (its ``fast_accum`` mode).
  The rank-P distance part of both kernels, and of their plain versions,
  stays IEEE fp32 in every mode: its errors land inside exp().

On the CPU and in float64 the settings change nothing: no TF32 exists
there.
"""
from __future__ import annotations

import contextlib

import torch

IEEE_PRECISIONS = ("highest", "float32")
REDUCED_PRECISIONS = ("high", "default", "fastest", "tensorfloat32",
                      "bfloat16", "bfloat16_3x")


def reduced(precision: str) -> bool:
    """True where ``precision`` allows TF32; raises on an unknown name."""
    if precision in IEEE_PRECISIONS:
        return False
    if precision in REDUCED_PRECISIONS:
        return True
    raise ValueError(f"precision must be one of "
                     f"{IEEE_PRECISIONS + REDUCED_PRECISIONS}, got "
                     f"{precision!r}")


@contextlib.contextmanager
def _settings(tf32: bool):
    old = (torch.get_float32_matmul_precision(),
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cuda.matmul.allow_tf32 = old[1]
        torch.backends.cudnn.allow_tf32 = old[2]


def ieee_fp32():
    """IEEE fp32 products: TF32 off, restored on exit."""
    return _settings(False)


def matmul_precision(precision: str = "highest"):
    """The product settings of ``precision`` (see the module docstring)."""
    return _settings(reduced(precision))


@contextlib.contextmanager
def rank_p_ieee(t):
    """IEEE fp32 for the rank-P products of a plain kernel version on a
    CUDA tensor, whatever the caller's settings; a no-op elsewhere."""
    if t.device.type != "cuda" or not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True
