"""Spatial GCONV: the wrapper of the hand-written CUDA kernel
``csrc/gconv_spatial.cu``, its plain PyTorch version and its launch count.

The port of the JAX package's Pallas kernel (``repro.kernels.gconv_spatial``):
a direct NHWC convolution, x ``(B, H, W, C)`` and w ``(KH, KW, C, O)`` giving
an f32 ``(B, OH, OW, O)``, square stride, symmetric zero padding, groups 1,
with no im2col: every (kh, kw) tap reads a shifted view of one resident
input tile. On the card the tile is an output tile's input halo in shared
memory, staged a chunk of channels at a time (see the source).

:func:`gconv_spatial` takes its plain version only for tensors on the CPU;
on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build
from .common import pick_block

# csrc/gconv_spatial.cu: output tile and channel block of one CUDA block
TILE_H, TILE_W, BLOCK_O = 8, 8, 64
CHUNK_C = 16                 # target input-channel chunk of a staged halo
SMEM_MAX = 232448            # dynamic shared memory one block may use


def out_size(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def smem_bytes(kh: int, kw: int, stride: int, cc: int) -> int:
    """Shared memory one block needs with a chunk of ``cc`` channels:
    the halo ((TH-1)*s + KH) x ((TW-1)*s + KW) x cc plus a (cc, BO) weight
    slice, in f32 (``gconv_spatial_smem_bytes`` in the source)."""
    halo = ((TILE_H - 1) * stride + kh) * ((TILE_W - 1) * stride + kw)
    return 4 * (halo * cc + cc * BLOCK_O)


def channel_chunk(c: int, kh: int, kw: int, stride: int) -> int:
    """The input-channel chunk of a staged halo: ``CHUNK_C`` (masked past
    C), or fewer channels where a large window or stride would not fit the
    halo in one block's shared memory. Raises if one channel does not
    fit."""
    cc = pick_block(c, CHUNK_C, 8)
    while cc > 1 and smem_bytes(kh, kw, stride, cc) > SMEM_MAX:
        cc //= 2
    if smem_bytes(kh, kw, stride, cc) > SMEM_MAX:
        raise ValueError(f"gconv_spatial: a {kh}x{kw} window at stride "
                         f"{stride} does not fit one block's shared memory")
    return cc


def gconv_spatial_plain(x, w, *, stride: int = 1, pad: int = 0):
    """The kernel's arithmetic in plain PyTorch: zero padding, then one f32
    contraction per (kh, kw) tap over a strided view of the padded input."""
    B, H, W, C = x.shape
    KH, KW, _, O = w.shape
    oh, ow = out_size(H, KH, stride, pad), out_size(W, KW, stride, pad)
    xp = F.pad(x.to(torch.float32), (0, 0, pad, pad, pad, pad))
    wf = w.to(torch.float32)
    acc = torch.zeros((B, oh, ow, O), dtype=torch.float32, device=x.device)
    for i in range(KH):
        for j in range(KW):
            win = xp[:, i:i + (oh - 1) * stride + 1:stride,
                     j:j + (ow - 1) * stride + 1:stride, :]
            acc += torch.einsum("bhwc,co->bhwo", win, wf[i, j])
    return acc


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("gconv_spatial")
    i = ctypes.c_int
    lib.gconv_spatial_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        i, i, i, i, i, i, i, i, i, i, i, i, ctypes.c_void_p]
    lib.gconv_spatial_launch.restype = ctypes.c_int
    lib.gconv_spatial_smem_bytes.argtypes = [i, i, i, i]
    lib.gconv_spatial_smem_bytes.restype = ctypes.c_size_t
    if lib.gconv_spatial_smem_bytes(3, 5, 2, 7) != smem_bytes(3, 5, 2, 7):
        raise RuntimeError("csrc/gconv_spatial.cu tiles != kernels/"
                           "gconv_spatial.py TILE_H/TILE_W/BLOCK_O")
    return lib


def gconv_spatial(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  pad: int = 0) -> torch.Tensor:
    """NHWC conv: x (B, H, W, C), w (KH, KW, C, O) -> (B, OH, OW, O) f32.

    On CUDA both tensors must be f32, contiguous and on one device; the
    kernel then runs on the current stream and ``gconv_spatial.launches``
    counts the launch. On the CPU the plain version runs."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"want x (B,H,W,C), w (KH,KW,C,O); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    B, H, W, C = x.shape
    KH, KW, C2, O = w.shape
    if C != C2:
        raise ValueError(f"x has C={C}, w has C={C2}")
    if stride < 1 or pad < 0:
        raise ValueError(f"stride={stride} must be >= 1, pad={pad} >= 0")
    oh, ow = out_size(H, KH, stride, pad), out_size(W, KW, stride, pad)
    if oh < 1 or ow < 1:
        raise ValueError(f"empty output for {H}x{W} input, {KH}x{KW} window")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return gconv_spatial_plain(x, w, stride=stride, pad=pad)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gconv_spatial runs on CPU or CUDA tensors on one "
                         f"device, got {x.device} and {w.device}")
    for t in (x, w):
        if t.dtype != torch.float32:
            raise TypeError(f"gconv_spatial kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("gconv_spatial kernel takes contiguous tensors")
    out = torch.empty((B, oh, ow, O), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    cc = channel_chunk(C, KH, KW, stride)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gconv_spatial_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W, C, O,
            KH, KW, stride, pad, oh, ow, cc, stream)
    build.check_launch(lib, rc, "gconv_spatial")
    gconv_spatial.launches += 1
    return out


gconv_spatial.launches = 0
