"""TF32 arithmetic where the card is not at hand: the control's precision.

On the card the control is the reference with
``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` on: its
float32 matmuls and convolutions read their operands at TF32's 10-bit
mantissa and sum in float32. ``emulated()`` does the same on any device
by rounding (to nearest, ties to even) the float32 operands of those
functions before they run, so that the control's test runs on the CPU.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as Fn
from torch.overrides import TorchFunctionMode

_LOW = 13  # float32 keeps 23 mantissa bits, TF32 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x's float32 values at TF32's precision (other dtypes, and the
    dual tensors of forward-mode derivatives, as they are)."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    if fwAD.unpack_dual(x).tangent is not None:
        return x
    b = x.contiguous().view(torch.int32)
    half = (1 << (_LOW - 1)) - 1
    b = (b + half + ((b >> _LOW) & 1)) & ~((1 << _LOW) - 1)
    return b.view(torch.float32).view(x.shape)


_FUNCS = {torch.matmul, torch.mm, torch.bmm, torch.einsum, torch.baddbmm,
          torch.addmm, torch.Tensor.__matmul__, torch.Tensor.matmul,
          torch.Tensor.mm, torch.Tensor.bmm, Fn.conv1d, Fn.conv2d,
          Fn.linear}


class emulated(TorchFunctionMode):
    """Inside ``with emulated():`` the float32 operands of matmuls and
    convolutions are rounded to TF32 first."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FUNCS:
            args = tuple(round_tf32(a) if isinstance(a, torch.Tensor)
                         else a for a in args)
            kwargs = {k: round_tf32(v) if isinstance(v, torch.Tensor) else v
                      for k, v in kwargs.items()}
        return func(*args, **kwargs)
