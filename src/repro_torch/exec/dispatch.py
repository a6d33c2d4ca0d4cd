"""Backend dispatch + fused-segment detection for the compiled engine.

The counterpart of the JAX package's ``repro.exec.dispatch``, with its
rules and tag vocabulary; only the implementation suffix changes:
``matmul:pallas`` / ``matmul:jnp`` / ``conv:pallas`` / ``conv:lax`` become
``matmul:cuda`` / ``matmul:torch`` / ``conv:cuda`` / ``conv:torch``, and
``backend`` is ``"auto" | "torch" | "cuda"`` for ``"auto" | "jnp" |
"pallas"``.

Planning is pure: :func:`plan_chain` plans for ``device_type="cuda"``
without a card. With ``device_type="cuda"``, ``auto`` sends a grouped
matmul to the ``gconv_matmul`` kernel under the reference's gate (M >=
``M_ALIGN``, K and N >= ``mxu_min``) and a conv to the ``gconv_spatial``
kernel within the reference's geometry limits, so the card runs the
kernels on the same steps as the TPU. With ``device_type="cpu"``, ``auto``
plans ``:torch`` steps, as the reference plans ``jnp``/``lax`` on the CPU.
``backend="cuda"`` plans every eligible step on the kernels wherever the
chain runs; on CPU tensors the kernels' wrappers run their plain versions.

Segments: the softmax peephole (max / sub-exp / sum / div, in both the
4-node and the §4.3-fused 3-node form) lowers to ``torch.softmax``; its
interior nodes appear in the dispatch table as ``fused:<segment output>``.
The norm and attention segments come with the LM slice; they never match
on a zoo chain.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.chain import Chain, Concat, Movement
from ..core.gconv import GConv, Op
from ..core.interpreter import apply_movement, compute_dtype, torch_dtype
from ..kernels.common import M_ALIGN, MXU_MIN
from . import lowering as low

BACKENDS = ("auto", "torch", "cuda")
DEVICE_TYPES = ("cuda", "cpu")


@dataclass
class Step:
    """One compiled execution step: produces env[name] from env."""

    name: str
    backend: str
    run: Callable                        # fn(env) -> tensor


@dataclass
class Plan:
    steps: List[Step]
    dispatch: Dict[str, str]             # every original node -> backend tag
    signature: str = ""                  # chain name + input shapes +
                                         # per-step backend decisions


# ---------------------------------------------------------------------------
# per-node dispatch
# ---------------------------------------------------------------------------
def _check(backend: str, device_type: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if device_type not in DEVICE_TYPES:
        raise ValueError(f"device_type {device_type!r} not in "
                         f"{DEVICE_TYPES}")


def _kernels(backend: str, device_type: str) -> bool:
    """Whether eligible steps go to the hand-written kernels."""
    return backend == "cuda" or (backend == "auto" and device_type == "cuda")


def _prefer_cuda_matmul(backend: str, device_type: str, mxu_min: int,
                        plan, node) -> bool:
    """The reference's ``_prefer_pallas_matmul`` gate: all three work axes
    must clear a threshold — K/N feed the contraction, and M must at least
    fill one row tile; a tiny-M product stays on ``torch.matmul``. The
    group axis never compensates for small M."""
    if backend == "cuda":
        return True
    if not _kernels(backend, device_type):
        return False
    _G, M, K, N = low.matmul_dims(node, plan)
    return M >= M_ALIGN and K >= mxu_min and N >= mxu_min


def dispatch_gconv(node: GConv, k_shape: Optional[Tuple[int, ...]],
                   backend: str = "auto", mxu_min: int = MXU_MIN,
                   device_type: str = "cuda") -> Tuple[str, Callable]:
    """Pick (backend_tag, fn(x, k, lookup)) for one GCONV node."""
    _check(backend, device_type)
    classes = low.dim_classes(node)
    if all(c == low.BCAST for c in classes):
        return "elementwise", low.lower_elementwise(node)
    if low.GENERAL in classes:
        return "oracle", low.lower_oracle(node)
    if node.main == "none" and node.reduce in ("add", "max", "min"):
        if all(d.nop == 1 for d in node.dims):
            return "reduce", low.lower_reduce(node, classes)
        return "oracle", low.lower_oracle(node)
    if node.main == "mul" and node.reduce == "add":
        if low.WINDOW not in classes:
            plan = low.match_grouped_matmul(node, classes, k_shape)
            if plan is not None:
                if _prefer_cuda_matmul(backend, device_type, mxu_min, plan,
                                       node):
                    return ("matmul:cuda",
                            low.lower_grouped_matmul(node, plan, kernel=True))
                return "matmul:torch", low.lower_grouped_matmul(node, plan)
        cplan = low.match_conv(node, classes, k_shape)
        if cplan is not None:
            if _kernels(backend, device_type):
                fn = low.lower_conv_cuda(node, cplan)
                if fn is not None:
                    return "conv:cuda", fn
            fn = low.lower_conv(node, cplan)
            if fn is not None:            # F.conv*d covers 1-3 window dims
                return "conv:torch", fn
        return "einsum", low.lower_einsum(node, classes)
    return "oracle", low.lower_oracle(node)


# ---------------------------------------------------------------------------
# segment detection
# ---------------------------------------------------------------------------
@dataclass
class Segment:
    kind: str
    out: str                             # the node whose value it produces
    members: Tuple[str, ...]             # interior nodes, never materialized
    run: Callable = None                 # fn(env) -> tensor


def _is_op(op: Op, name: str, operand: Optional[str] = None) -> bool:
    return (op.name == name and op.operand == operand)


def _single_axis_reduce(node: GConv, kind: str) -> Optional[int]:
    """Axis index when the node is a pure one-dim full reduction."""
    if not isinstance(node, GConv):
        return None
    if node.main != "none" or node.reduce != kind:
        return None
    classes = low.dim_classes(node)
    tap_ix = [i for i, d in enumerate(node.dims) if d.nks > 1]
    if len(tap_ix) != 1:
        return None
    i = tap_ix[0]
    if classes[i] != low.CONTRACT or node.dims[i].ng != 1:
        return None
    if node.dims[i].nop != 1:
        return None
    if any(c != low.BCAST for j, c in enumerate(classes) if j != i):
        return None
    return i


def _softmax_parts(chain: Chain, consumers, div_name: str):
    """Match the softmax segment ending at ``div_name``.

    Returns (x, axis, members) or None. Handles both the unfused 4-node
    form (max / sub-exp / sum / div) and the form §4.3 fusion produces
    (max / sum[pre=sub,exp] / div[pre=sub,exp])."""
    div = chain.nodes.get(div_name)
    if not isinstance(div, GConv) or div.main != "div":
        return None
    if div.reduce != "none" or div.post or div.kernel is None:
        return None
    s = chain.nodes.get(div.kernel)
    if not isinstance(s, GConv):
        return None

    def fused_pre(pre, m_name):
        return (len(pre) == 2 and _is_op(pre[0], "sub", m_name)
                and pre[0].const is None and _is_op(pre[1], "exp"))

    if not div.pre:                                      # unfused form
        e = chain.nodes.get(div.input)
        if (not isinstance(e, GConv) or e.main != "sub" or e.reduce != "none"
                or e.pre or len(e.post) != 1 or not _is_op(e.post[0], "exp")):
            return None
        m_name = e.kernel
        if s.input != e.name or s.pre or s.post:
            return None
        ax = _single_axis_reduce(s, "add")
        m = chain.nodes.get(m_name)
        if not isinstance(m, GConv) or m.input != e.input:
            return None
        if m.pre or m.post or _single_axis_reduce(m, "max") != ax:
            return None
        members = (m_name, e.name, s.name)
        x = e.input
        cons_ok = (sorted(consumers.get(e.name, [])) == sorted([s.name,
                                                                div_name])
                   and consumers.get(m_name, []) == [e.name]
                   and consumers.get(s.name, []) == [div_name])
    else:                                                # fused form
        if len(div.pre) != 2:
            return None
        m_name = div.pre[0].operand
        if m_name is None or not fused_pre(div.pre, m_name):
            return None
        if s.input != div.input or s.post or not fused_pre(s.pre, m_name):
            return None
        ax = _single_axis_reduce(s, "add")
        m = chain.nodes.get(m_name)
        if not isinstance(m, GConv) or m.input != div.input:
            return None
        if m.pre or m.post or _single_axis_reduce(m, "max") != ax:
            return None
        members = (m_name, s.name)
        x = div.input
        cons_ok = (sorted(consumers.get(m_name, []))
                   == sorted([s.name, div_name])
                   and consumers.get(s.name, []) == [div_name])
    if ax is None or not cons_ok:
        return None
    if any(n in chain.outputs for n in members):
        return None
    # interior nodes with an out_dtype quantize their intermediate in the
    # oracle; a segment computing end-to-end in f32 would diverge — refuse
    # and let per-node dispatch handle the mixed-precision chain
    if any(chain.nodes[n].out_dtype is not None for n in members):
        return None
    return x, ax, members


def match_softmax(chain: Chain, consumers, div_name: str) -> Optional[Segment]:
    parts = _softmax_parts(chain, consumers, div_name)
    if parts is None:
        return None
    x, ax, members = parts
    out_dtype = chain.nodes[div_name].out_dtype

    def run(env, _x=x, _ax=ax, _od=out_dtype):
        v = env[_x]
        y = torch.softmax(v.to(compute_dtype(v)), dim=_ax)
        return y if _od is None else y.to(torch_dtype(_od))

    return Segment("segment:softmax", div_name, members, run)


# ---------------------------------------------------------------------------
# chain planning
# ---------------------------------------------------------------------------
def plan_chain(chain: Chain, *, backend: str = "auto", mxu_min: int = MXU_MIN,
               segments: bool = True, device_type: str = "cuda") -> Plan:
    """Plan every node of ``chain`` for a device of ``device_type``.
    Pure: it inspects shapes only and needs no device."""
    _check(backend, device_type)
    consumers = chain.consumers()
    segs: Dict[str, Segment] = {}
    claimed: Dict[str, str] = {}         # interior node -> segment out
    if segments:
        for name in chain.nodes:
            if name in claimed or name in segs:
                continue
            seg = match_softmax(chain, consumers, name)
            if seg is None:
                continue
            if any(m in claimed or m in segs for m in seg.members):
                continue
            segs[seg.out] = seg
            for m in seg.members:
                claimed[m] = seg.out

    steps: List[Step] = []
    dispatch: Dict[str, str] = {}
    for name, node in chain.nodes.items():
        if name in claimed:
            dispatch[name] = f"fused:{claimed[name]}"
            continue
        if name in segs:
            seg = segs[name]
            dispatch[name] = seg.kind
            steps.append(Step(name, seg.kind, seg.run))
            continue
        if isinstance(node, Concat):
            dispatch[name] = "concat"
            steps.append(Step(name, "concat", _concat_step(node)))
            continue
        if isinstance(node, Movement):
            dispatch[name] = "movement"
            steps.append(Step(name, "movement", _movement_step(node)))
            continue
        k_shape = (tuple(chain.shape_of(node.kernel))
                   if node.kernel is not None else None)
        tag, fn = dispatch_gconv(node, k_shape, backend, mxu_min, device_type)
        dispatch[name] = tag
        steps.append(Step(name, tag, _gconv_step(node, fn)))
    ins = ";".join(f"{n}:{'x'.join(map(str, i.shape))}:{i.dtype}"
                   for n, i in chain.inputs.items())
    prog = ";".join(f"{s.name}={s.backend}" for s in steps)
    return Plan(steps, dispatch, signature=f"{chain.name}|{ins}|{prog}")


def _gconv_step(node: GConv, fn: Callable) -> Callable:
    def run(env):
        x = env[node.input]
        k = env[node.kernel] if node.kernel is not None else None
        lookup = lambda op: env[op.operand]
        return fn(x, k, lookup)

    return run


def _concat_step(node: Concat) -> Callable:
    def run(env):
        return torch.cat([env[r] for r in node.inputs], dim=node.axis)

    return run


def _movement_step(node: Movement) -> Callable:
    """The oracle's own Movement semantics (shared definition, gather
    stand-in included)."""
    def run(env):
        return apply_movement(node, env[node.input])

    return run
