"""Entry points of the kernel layer for model code.

Each hands the kernel f32 contiguous operands (the kernels compute in f32
from any float dtype, as the Pallas kernels do) and casts the f32 result to
the requested dtype (the input's by default). There is no switch that
sends a CUDA tensor to a plain version: the wrappers take their plain
versions only for tensors on the CPU.
``fused_norm`` and ``attention`` come with the LM slice.
"""
from __future__ import annotations

import torch

from .gconv_matmul import gconv_matmul
from .gconv_spatial import gconv_spatial


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *, post: str = "id",
                   scale: float = 1.0, out_dtype=None) -> torch.Tensor:
    """(G,M,K) x (G,K,N) -> (G,M,N); the MoE-expert / grouped-GCONV
    engine."""
    y = gconv_matmul(_f32(x), _f32(w), post=post, scale=scale)
    return y.to(out_dtype or x.dtype)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                pad: int = 0, out_dtype=None) -> torch.Tensor:
    """NHWC x (KH,KW,C,O) convolution, square stride, symmetric pad."""
    y = gconv_spatial(_f32(x), _f32(w), stride=stride, pad=pad)
    return y.to(out_dtype or x.dtype)
