"""GCONV operator registries (paper §3.1), in PyTorch.

``pre``/``post`` are elementwise unary ops, optionally parameterized by a
scalar ``const`` or a broadcastable tensor ``operand`` (fusion, §4.3).
``main`` combines input and kernel parameter; ``reduce`` folds the Nks taps.

The counterpart of the JAX package's ``repro.core.operators`` entry for
entry, with its semantics kept where the two frameworks differ:
``gelu`` is the tanh approximation (``jax.nn.gelu``'s default),
``rsqrt_eps`` defaults to eps 1e-5, ``gtz`` returns the input dtype, and the
reduce identities (which double as pad values) are 0 and ±inf.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# pre/post unary operators: fn(x, const, operand) -> tensor
# ---------------------------------------------------------------------------
_EPS_DEFAULT = 1e-5


def _need_operand(name):
    raise ValueError(f"operator {name!r} requires an operand tensor")


UNARY: Dict[str, Callable] = {
    "id": lambda x, c, p: x,
    "neg": lambda x, c, p: -x,
    "abs": lambda x, c, p: torch.abs(x),
    "square": lambda x, c, p: x * x,
    "sqrt": lambda x, c, p: torch.sqrt(x),
    "recip": lambda x, c, p: 1.0 / x,
    "exp": lambda x, c, p: torch.exp(x),
    "log": lambda x, c, p: torch.log(x),
    "relu": lambda x, c, p: torch.clamp_min(x, 0),
    "gtz": lambda x, c, p: (x > 0).to(x.dtype),       # relu' (BP mask)
    "sigmoid": lambda x, c, p: torch.sigmoid(x),
    "silu": lambda x, c, p: F.silu(x),
    "gelu": lambda x, c, p: F.gelu(x, approximate="tanh"),
    "tanh": lambda x, c, p: torch.tanh(x),
    # scalar-parameterized ("LUT"-class in the paper)
    "scale": lambda x, c, p: x * c,
    "add_const": lambda x, c, p: x + c,
    "pow": lambda x, c, p: x ** c,
    "rsqrt_eps": lambda x, c, p: torch.rsqrt(
        x + (c if c is not None else _EPS_DEFAULT)),
    "leaky_relu": lambda x, c, p: torch.where(x >= 0, x, x * c),
    "clip_max": lambda x, c, p: torch.clamp_max(x, c),
    # tensor-parameterized (post-fusion pre/post ops, paper §4.3)
    "mul": lambda x, c, p: x * p if p is not None else _need_operand("mul"),
    "add": lambda x, c, p: x + p if p is not None else _need_operand("add"),
    "sub": lambda x, c, p: x - p if p is not None else _need_operand("sub"),
    "rsub": lambda x, c, p: p - x if p is not None else _need_operand("rsub"),
    "div": lambda x, c, p: x / p if p is not None else _need_operand("div"),
    "maximum": lambda x, c, p: (torch.maximum(x, p) if p is not None
                                else _need_operand("maximum")),
}

# ---------------------------------------------------------------------------
# main operators: fn(input_window, kernel_param) -> tensor
# ---------------------------------------------------------------------------
MAIN: Dict[str, Callable] = {
    "mul": lambda i, k: i * k,
    "add": lambda i, k: i + k,
    "sub": lambda i, k: i - k,        # Table 2: FP2, BP4, BP5 use main='-'
    "rsub": lambda i, k: k - i,
    "max": lambda i, k: torch.maximum(i, k),
    "min": lambda i, k: torch.minimum(i, k),
    "sqdiff": lambda i, k: (i - k) * (i - k),
    "div": lambda i, k: i / k,
    # "none" handled by the evaluator: pass input through
}

# ---------------------------------------------------------------------------
# reduce operators: (fn(x, dims), identity) — identity doubles as pad value
# ---------------------------------------------------------------------------
REDUCE: Dict[str, tuple] = {
    "add": (lambda x, dims: torch.sum(x, dim=dims), 0.0),
    "max": (lambda x, dims: torch.amax(x, dim=dims), -math.inf),
    "min": (lambda x, dims: torch.amin(x, dim=dims), math.inf),
    # "none": no reduction (all nks == 1)
}


def pad_value(reduce: str) -> float:
    if reduce == "none":
        return 0.0
    return REDUCE[reduce][1]


def apply_unary_seq(ops, x, operand_lookup: Optional[Callable] = None):
    """Apply a pre/post operator sequence. ``operand_lookup(op) -> tensor``
    resolves tensor operands (already broadcast to x's layout by the
    caller)."""
    for op in ops:
        fn = UNARY.get(op.name)
        if fn is None:
            raise KeyError(f"unknown unary operator {op.name!r}")
        p = (operand_lookup(op)
             if (op.operand is not None and operand_lookup) else None)
        x = fn(x, op.const, p)
    return x


def apply_main(name: str, i, k):
    fn = MAIN.get(name)
    if fn is None:
        raise KeyError(f"unknown main operator {name!r}")
    return fn(i, k)


def apply_reduce(name: str, x, axes):
    if name == "none":
        return x
    if name not in REDUCE:
        raise KeyError(name)
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    if not axes:        # torch reads an empty dim tuple as "all dims"
        return x
    return REDUCE[name][0](x, axes)
