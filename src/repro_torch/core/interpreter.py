"""PyTorch GCONV chain interpreter (the semantic oracle of the port).

Executes a :class:`~repro_torch.core.chain.Chain` node by node, realizing
the paper's nested-loop semantics (Fig. 4) with vectorized tensor ops, as
the JAX package's ``repro.core.interpreter`` does. Per dimension the input
axis (size ``Ng*Nips``) is viewed as ``(Ng, Nips)``, padded with the
*reduce identity*, and expanded into sliding windows ``(Ng, Nopc, Nks)``;
the kernel axis is viewed as ``(Ng, Nop, Nks)``; ``main`` combines them
with broadcasting and ``reduce`` folds every ``Nks`` axis, yielding
``(Ng, Nop, Nopc)`` per dimension, re-flattened to the output axis.

It is the simple, obviously-correct realization and only meant to run at
test sizes (the expanded main-operand tensor has ``macs`` elements). The
compiled engine's ``oracle`` lowering runs :func:`eval_gconv`.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from . import operators as ops
from .chain import Chain, Concat, Movement
from .gconv import DimSpec, GConv


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a chain ``TensorInfo.dtype`` string."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """``result_type(x.dtype, float32)``: the dtype every lowering computes
    in (bf16/f16/f32 -> f32, f64 stays f64)."""
    return torch.promote_types(x.dtype, torch.float32)


def init_chain_params(chain: Chain, generator: torch.Generator,
                      scale: float = 0.1) -> Dict[str, torch.Tensor]:
    """Random parameters for a chain, ``scale * N(0, 1)``, drawn in
    parameter order from ``generator`` on the generator's device. The
    draws are not the JAX package's (``jax.random`` cannot be reproduced);
    tests that compare the two packages share numpy parameters instead
    (:func:`repro_torch.convert.params_from_numpy`)."""
    out = {}
    for name, info in chain.params.items():
        out[name] = scale * torch.randn(info.shape, generator=generator,
                                        dtype=torch_dtype(info.dtype),
                                        device=generator.device)
    return out


def apply_movement(node: Movement, x: torch.Tensor) -> torch.Tensor:
    """Movement semantics (reshape/transpose/flip + the deterministic
    gather stand-in) — the single definition both engines execute.

    Runtime-dependent selection (RoI boxes / NMS) is modeled as a
    deterministic stand-in: cycle through the flattened source (movement
    cost is what matters here)."""
    if node.pre_shape is not None:
        x = x.reshape(node.pre_shape)
    if node.perm is not None:
        x = x.permute(node.perm)
    if node.flip:
        x = torch.flip(x, dims=tuple(node.flip))
    if node.gather:
        flat = x.reshape(-1)
        n = node.out_elems
        reps = -(-n // flat.numel())
        flat = flat.repeat(reps)[:n]
        return flat.reshape(node.out_shape)
    return x.reshape(node.out_shape)


def window_last(x: torch.Tensor, d: DimSpec, pad_val: float) -> torch.Tensor:
    """(…, Nips) -> (…, Nopc, Nks) on the last axis: crop a negative right
    pad, pad with ``pad_val``, then take the ``Nopc`` windows of ``Nks``
    taps at stride ``s`` (a strided view)."""
    if d.padr < 0:                      # crop: trailing elements never read
        x = x[..., : d.nips + d.padr]
    if d.pad > 0 or d.padr > 0:
        x = F.pad(x, (d.pad, max(d.padr, 0)), value=pad_val)
    # padded length is exactly (Nopc-1)*s + Nks, so unfold yields Nopc windows
    return x.unfold(-1, d.nks, d.stride)


def _window_axis(x: torch.Tensor, axis: int, d: DimSpec, pad_val: float):
    """(…, Ng*Nips, …) -> (…, Ng, Nopc, Nks) at the end."""
    x = torch.movedim(x, axis, -1)
    x = x.reshape(x.shape[:-1] + (d.ng, d.nips))
    return window_last(x, d, pad_val)


def eval_gconv(node: GConv,
               x: torch.Tensor,
               k: Optional[torch.Tensor],
               operand_lookup: Optional[Callable] = None) -> torch.Tensor:
    """Evaluate one GCONV on concrete tensors (oracle semantics)."""
    nd = len(node.dims)
    ct = compute_dtype(x)
    x = x.to(ct)
    # pre operators act on the loaded inputs (before windowing / padding)
    x = ops.apply_unary_seq(node.pre, x, operand_lookup)
    pad_val = ops.pad_value(node.reduce)
    # expand each dim into (g, opc, ks); axes triple per original dim
    for i, d in enumerate(node.dims):
        # the i-th original axis sits at 3*i (each processed dim has been
        # replaced by 3 axes in place); bring the new triple back there
        x = _window_axis(x, 3 * i, d, pad_val)
        x = torch.movedim(x, (-3, -2, -1), (3 * i, 3 * i + 1, 3 * i + 2))
    # x now has per-dim axes (g, opc, ks); insert op axis -> (g, op, opc, ks)
    x_shape = []
    for d in node.dims:
        x_shape += [d.ng, 1, d.nopc, d.nks]
    x = x.reshape(x_shape)
    if node.main != "none":
        if k is None:
            raise ValueError(f"GCONV {node.name}: main={node.main!r} "
                             f"needs a kernel tensor")
        k = k.to(ct)
        k_shape = []
        for i, d in enumerate(node.dims):
            if k.shape[i] == 1:
                k_shape += [1, 1, 1, 1]
            else:
                k_shape += [d.ng, d.nop, 1, d.nks]
        k = k.reshape(k_shape)
        y = ops.apply_main(node.main, x, k)
    else:
        y = x
    ks_axes = tuple(4 * i + 3 for i in range(nd))
    y = ops.apply_reduce(node.reduce, y, ks_axes)
    if node.reduce == "none":
        y = y.reshape([s for i, s in enumerate(y.shape) if i % 4 != 3])
    # y axes per dim: (g, op, opc) -> flatten to out axis
    y = y.reshape(node.out_shape)
    y = ops.apply_unary_seq(node.post, y, operand_lookup)
    if node.out_dtype is not None:
        y = y.to(torch_dtype(node.out_dtype))
    return y


class ChainExecutor:
    """Executes a chain on concrete inputs/params, returns all node
    outputs."""

    def __init__(self, chain: Chain):
        chain.validate()
        self.chain = chain

    def init_params(self, generator: torch.Generator,
                    scale: float = 0.1) -> Dict[str, torch.Tensor]:
        return init_chain_params(self.chain, generator, scale)

    def __call__(self,
                 inputs: Mapping[str, torch.Tensor],
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 keep_all: bool = False) -> Dict[str, torch.Tensor]:
        params = params or {}
        env: Dict[str, torch.Tensor] = {}
        for name, info in self.chain.inputs.items():
            if name not in inputs:
                raise ValueError(f"missing chain input {name!r}")
            arr = torch.as_tensor(inputs[name])
            if tuple(arr.shape) != info.shape:
                raise ValueError(
                    f"input {name!r}: got {tuple(arr.shape)}, "
                    f"want {info.shape}")
            env[name] = arr
        for name in self.chain.params:
            if name not in params:
                raise ValueError(f"missing chain param {name!r}")
            env[name] = torch.as_tensor(params[name])

        lookup = lambda op: env[op.operand]
        with torch.inference_mode():
            for name, node in self.chain.nodes.items():
                if isinstance(node, Concat):
                    env[name] = torch.cat([env[r] for r in node.inputs],
                                          dim=node.axis)
                elif isinstance(node, Movement):
                    env[name] = apply_movement(node, env[node.input])
                else:
                    k = env[node.kernel] if node.kernel is not None else None
                    env[name] = eval_gconv(node, env[node.input], k, lookup)
        if keep_all:
            return env
        outs = self.chain.outputs or [list(self.chain.nodes)[-1]]
        return {o: env[o] for o in outs}
