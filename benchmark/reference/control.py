"""The control: the plain reference computed in float8 (e4m3), the precision
below the configuration's bfloat16.

While :class:`Float8` is open, every product of the reference (``F.linear``,
``F.conv2d``, ``matmul``, ``bmm``, ``einsum``) takes its operands rounded to
float8 e4m3, each tensor scaled by its largest magnitude to e4m3's range
first, as a float8 GEMM with per-tensor scales computes, sums in float32,
and its result is rounded to e4m3 the same way, as a network whose
activations are float8 stores them. A comparison that cannot tell this from
the program is too loose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def to_e4m3(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in its dtype."""
    if not (torch.is_tensor(t) and t.is_floating_point()) or t.numel() == 0:
        return t
    s = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class Float8(TorchFunctionMode):
    """Products with float8 operands and results."""

    PRODUCTS = {F.linear: 2, F.conv2d: 2, torch.matmul: 2, torch.Tensor.matmul: 2,
                torch.Tensor.__matmul__: 2, torch.bmm: 2}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            n = self.PRODUCTS[func]
            args = tuple(to_e4m3(a) if i < n else a for i, a in enumerate(args))
        elif func is torch.einsum:
            args = (args[0],) + tuple(to_e4m3(a) for a in args[1:])
        else:
            return func(*args, **kwargs)
        return to_e4m3(func(*args, **kwargs))
