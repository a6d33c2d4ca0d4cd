"""Grouped GCONV matmul: the wrapper of the hand-written CUDA kernel
``csrc/gconv_matmul.cu``, its plain PyTorch version and its launch count.

The port of the JAX package's Pallas kernel (``repro.kernels.gconv_matmul``):
any GCONV with ``main=mul, reduce=add`` and no window dims lowers to

    out[g] = epilogue(post(scale * (prologue(x)[g] @ w[g])))

with x ``(G, M, K)``, w ``(G, K, N)`` and an f32 ``(G, M, N)`` result, the
paper's ``pre``/``post`` operators fused as prologue and epilogue (§4.3).
``prologue``/``epilogue`` are ``(name, const, operand_slot)`` sequences over
``core.operators.UNARY``; slot ``i`` reads ``operands[i]``, shaped
``(G|1, M|1, 1)``, ``(G|1, 1, K)`` (prologue) or ``(G|1, 1, N)``
(epilogue). Any other operand shape is rejected, as the Pallas kernel's
``_operand_spec`` rejects it.

:func:`gconv_matmul` takes its plain version only for tensors on the CPU;
on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..core import operators as core_ops
from . import build

# legacy single-op epilogue vocabulary (post=/scale= form)
EPILOGUES = ("id", "relu", "silu", "gelu", "sigmoid", "tanh", "exp",
             "square")

# kernel opcodes: the switch in csrc/gconv_matmul.cu, in this order
OPCODES = ("id", "neg", "abs", "square", "sqrt", "recip", "exp", "log",
           "relu", "gtz", "sigmoid", "silu", "gelu", "tanh", "scale",
           "add_const", "pow", "rsqrt_eps", "leaky_relu", "clip_max", "mul",
           "add", "sub", "rsub", "div", "maximum")
OPCODE = {name: i for i, name in enumerate(OPCODES)}
FUSABLE_OPS = frozenset(core_ops.UNARY)
_NEEDS_CONST = frozenset(("scale", "add_const", "pow", "leaky_relu",
                          "clip_max"))
OPERAND_OPS = frozenset(("mul", "add", "sub", "rsub", "div", "maximum"))

MAX_OPS = 16                 # csrc/gconv_matmul.cu MAX_OPS
KIND_SCALAR, KIND_ROW, KIND_COL = 1, 2, 3

# (name, const, operand_slot): one fused pre/post operator application.
FusedOp = Tuple[str, Optional[float], Optional[int]]


class _FusedSeq(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int),
                ("code", ctypes.c_int * MAX_OPS),
                ("kind", ctypes.c_int * MAX_OPS),
                ("gstride", ctypes.c_int * MAX_OPS),
                ("cst", ctypes.c_float * MAX_OPS),
                ("ptr", ctypes.c_void_p * MAX_OPS)]


def _operand_kind(shape, slot: int, G: int, M: int, L: int,
                  stage: str) -> int:
    """Broadcast kind of a fused-op operand. Legal shapes: (G|1, 1, 1),
    (G|1, M, 1) or (G|1, 1, L) with L = K (prologue) / N (epilogue) —
    anything else is rejected (a mismatched group axis must not silently
    read group 0)."""
    if len(shape) != 3:
        raise ValueError(f"operand {slot}: rank {len(shape)} != 3")
    g, a, b = shape
    if g not in (1, G):
        raise ValueError(f"operand {slot}: group axis {g} != 1 or {G}")
    if (a, b) == (1, 1):
        return KIND_SCALAR
    if (a, b) == (M, 1):
        return KIND_ROW
    if (a, b) == (1, L):
        return KIND_COL
    raise ValueError(
        f"operand {slot}: shape {tuple(shape)} not broadcastable over "
        f"(G={G}, M={M}, {'K' if stage == 'pro' else 'N'}={L})")


def _check_seq(seq: Sequence[FusedOp], operands, G, M, L, stage):
    """Validate one fused sequence; returns [(code, const, kind, slot)]."""
    if len(seq) > MAX_OPS:
        raise ValueError(f"{stage}logue of {len(seq)} ops exceeds the "
                         f"kernel's {MAX_OPS}")
    out = []
    for name, const, slot in seq:
        if name not in FUSABLE_OPS:
            raise ValueError(f"unfusable operator {name!r}")
        if name == "rsqrt_eps" and const is None:
            const = core_ops._EPS_DEFAULT
        if name in _NEEDS_CONST and const is None:
            raise ValueError(f"operator {name!r} needs a const")
        if name in OPERAND_OPS and slot is None:
            raise ValueError(f"operator {name!r} needs an operand slot")
        kind = 0
        if slot is not None:
            if not 0 <= slot < len(operands):
                raise ValueError(f"operand slot {slot} out of range")
            kind = _operand_kind(tuple(operands[slot].shape), slot, G, M, L,
                                 stage)
        out.append((OPCODE[name], const, kind, slot))
    return out


def _apply_fused(seq: Sequence[FusedOp], y, operands):
    for name, const, slot in seq:
        p = operands[slot].to(torch.float32) if slot is not None else None
        y = core_ops.UNARY[name](y, const, p)
    return y


def gconv_matmul_plain(x, w, *, post: str = "id", scale: float = 1.0,
                       prologue: Tuple[FusedOp, ...] = (),
                       epilogue: Tuple[FusedOp, ...] = (),
                       operands: Tuple[torch.Tensor, ...] = ()):
    """The kernel's function in plain PyTorch: prologue, ``torch.matmul``
    in f32, then scale, ``post`` and the epilogue. Operands broadcast
    against ``(G, M, K)`` / ``(G, M, N)`` as their legal shapes imply."""
    x = _apply_fused(prologue, x.to(torch.float32), operands)
    y = torch.matmul(x, w.to(torch.float32))
    if scale != 1.0:
        y = y * scale
    y = core_ops.UNARY[post](y, None, None)
    return _apply_fused(epilogue, y, operands)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("gconv_matmul")
    P = ctypes.POINTER(_FusedSeq)
    lib.gconv_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, P, P, ctypes.c_void_p]
    lib.gconv_matmul_launch.restype = ctypes.c_int
    lib.gconv_matmul_max_ops.restype = ctypes.c_int
    if lib.gconv_matmul_max_ops() != MAX_OPS:
        raise RuntimeError("csrc/gconv_matmul.cu MAX_OPS != kernels/"
                           "gconv_matmul.py MAX_OPS")
    return lib


def _pack(checked, operands, G) -> _FusedSeq:
    s = _FusedSeq()
    s.n = len(checked)
    for i, (code, const, kind, slot) in enumerate(checked):
        s.code[i] = code
        s.cst[i] = 0.0 if const is None else float(const)
        s.kind[i] = kind
        if slot is not None:
            arr = operands[slot]
            s.ptr[i] = arr.data_ptr()
            s.gstride[i] = 1 if (arr.shape[0] == G and G > 1) else 0
    return s


def gconv_matmul(x: torch.Tensor, w: torch.Tensor, *, post: str = "id",
                 scale: float = 1.0,
                 prologue: Tuple[FusedOp, ...] = (),
                 epilogue: Tuple[FusedOp, ...] = (),
                 operands: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """out[g] = epilogue(post(scale * (prologue(x)[g] @ w[g]))), f32.

    x: (G, M, K); w: (G, K, N) -> (G, M, N) f32. On CUDA every tensor must
    be f32, contiguous and on x's device; the kernel then runs on the
    current stream and ``gconv_matmul.launches`` counts the launch. On the
    CPU the plain version runs."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"want x (G,M,K), w (G,K,N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    G, M, K = x.shape
    G2, K2, N = w.shape
    if (G, K) != (G2, K2):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"disagree on G or K")
    if post not in EPILOGUES:
        raise ValueError(f"unknown post {post!r}")
    operands = tuple(operands)
    pro = _check_seq(prologue, operands, G, M, K, "pro")
    epi = _check_seq(epilogue, operands, G, M, N, "epi")
    tensors = (x, w) + operands
    if all(t.device.type == "cpu" for t in tensors):
        return gconv_matmul_plain(x, w, post=post, scale=scale,
                                  prologue=prologue, epilogue=epilogue,
                                  operands=operands)
    if x.device.type != "cuda":
        raise ValueError(f"gconv_matmul runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gconv_matmul kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("gconv_matmul kernel takes contiguous tensors")
    out = torch.empty((G, M, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    pro_s, epi_s = _pack(pro, operands, G), _pack(epi, operands, G)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gconv_matmul_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), G, M, K, N,
            float(scale), OPCODE[post], ctypes.byref(pro_s),
            ctypes.byref(epi_s), stream)
    build.check_launch(lib, rc, "gconv_matmul")
    gconv_matmul.launches += 1
    return out


gconv_matmul.launches = 0
