"""Per-GCONV backend lowerings for the compiled chain engine.

The counterpart of the JAX package's ``repro.exec.lowering``. Every GCONV
dimension falls into one of four classes (derived from its four loop
parameters, paper §3.1):

  * ``bcast``    — no taps, no kernel replication, unit stride/pad: the
                   input axis maps to the output axis identically
                   (``Ng*Nopc`` elements pass through).
  * ``contract`` — ``Nopc == 1``, no padding: the ``Nks`` taps cover the
                   whole (per-group) axis; a pure reduction/contraction
                   with no window overlap (FC's C dim, softmax's axis,
                   batch-norm's batch axis).
  * ``window``   — true sliding windows (``Nopc > 1`` and ``Nks > 1``) with
                   stride/padding: conv/pool spatial dims, LRN's C dim.
  * ``general``  — anything else (strided decimation etc.): falls back to
                   the oracle interpreter semantics.

The class vector decides the backend (see ``dispatch``): elementwise torch
ops, axis reductions, ``F.conv{1,2,3}d`` or the CUDA spatial kernel, grouped
matmul (``torch.matmul`` or the CUDA ``gconv_matmul``), a generic windowed
``einsum``, or — for exotic operator combinations — the
:func:`repro_torch.core.interpreter.eval_gconv` oracle itself.

All lowerings share the signature ``fn(x, k, lookup) -> y`` where ``lookup``
resolves pre/post tensor operands from the execution environment, and
mirror the oracle's dtype discipline: compute in
``result_type(x.dtype, float32)``, cast to ``out_dtype`` at the end.
"""
from __future__ import annotations

import string
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import operators as ops
from ..core.gconv import DimSpec, GConv
from ..core.interpreter import compute_dtype, eval_gconv, torch_dtype, \
    window_last
from ..kernels.gconv_matmul import gconv_matmul
from ..kernels.gconv_spatial import gconv_spatial

BCAST, CONTRACT, WINDOW, GENERAL = "bcast", "contract", "window", "general"


def classify_dim(d: DimSpec) -> str:
    if (d.nks == 1 and d.nop == 1 and d.stride == 1
            and d.pad == 0 and d.padr == 0):
        return BCAST
    if d.nopc == 1 and d.pad == 0 and d.padr == 0:
        return CONTRACT
    if d.ng == 1 and d.nop == 1:
        return WINDOW
    return GENERAL


def dim_classes(node: GConv) -> Tuple[str, ...]:
    return tuple(classify_dim(d) for d in node.dims)


def _prod(xs) -> int:
    return int(np.prod(xs)) if len(xs) else 1


def _finish(node: GConv, y, lookup):
    y = ops.apply_unary_seq(node.post, y, lookup)
    if node.out_dtype is not None:
        y = y.to(torch_dtype(node.out_dtype))
    return y


def _window_gather(x, axis: int, d: DimSpec, pad_val: float):
    """(…, Nips, …) -> (…, Nopc, Nks) at the end; ``axis`` must have
    ng==1."""
    return window_last(torch.movedim(x, axis, -1), d, pad_val)


# ---------------------------------------------------------------------------
# elementwise: all dims bcast (any reduce is a no-op over singleton taps)
# ---------------------------------------------------------------------------
def lower_elementwise(node: GConv) -> Callable:
    dims = node.dims

    def fn(x, k, lookup):
        x = x.to(compute_dtype(x))
        x = ops.apply_unary_seq(node.pre, x, lookup)
        if node.main != "none":
            xs, ks = [], []
            for d, ka in zip(dims, k.shape):
                xs += [d.ng, d.nopc]
                ks += [d.ng, 1] if ka != 1 else [1, 1]
            y = ops.apply_main(node.main, x.reshape(xs),
                               k.to(x.dtype).reshape(ks))
        else:
            y = x
        return _finish(node, y.reshape(node.out_shape), lookup)

    return fn


# ---------------------------------------------------------------------------
# reductions: main == 'none', reduce folds contract/window taps
# ---------------------------------------------------------------------------
def lower_reduce(node: GConv, classes: Sequence[str]) -> Callable:
    dims = node.dims
    red = ops.REDUCE[node.reduce][0]
    pad_val = ops.pad_value(node.reduce)
    window_ix = [i for i, c in enumerate(classes) if c == WINDOW]
    contract_ix = [i for i, c in enumerate(classes) if c == CONTRACT]

    def fn(x, k, lookup):
        x = x.to(compute_dtype(x))
        x = ops.apply_unary_seq(node.pre, x, lookup)
        for i in window_ix:             # window + immediate fold, per dim
            w = red(_window_gather(x, i, dims[i], pad_val), (-1,))
            x = torch.movedim(w, -1, i)  # (…, Nopc) back in place
        if contract_ix:
            shape, axes = [], []
            for i, d in enumerate(dims):
                if i in contract_ix:
                    shape += [d.ng, d.nks]
                    axes.append(len(shape) - 1)
                else:
                    shape.append(x.shape[i])
            x = red(x.reshape(shape), tuple(axes))
        return _finish(node, x.reshape(node.out_shape), lookup)

    return fn


# ---------------------------------------------------------------------------
# conv: main=mul/reduce=add with one grouped channel contraction + sliding
# spatial dims -> F.conv{1,2,3}d (or the CUDA spatial kernel)
# ---------------------------------------------------------------------------
def match_conv(node: GConv, classes: Sequence[str],
               k_shape: Optional[Tuple[int, ...]]):
    """Return (channel_ix, window_ix, batch_ix) or None."""
    if node.main != "mul" or node.reduce != "add" or k_shape is None:
        return None
    channel = [i for i, c in enumerate(classes)
               if c == CONTRACT and k_shape[i] == node.dims[i].k_size]
    if not channel:
        # depthwise: icg == 1 makes the channel dim a pure-Ng (bcast) dim
        # with a full kernel axis — groups = Ng, I = 1
        channel = [i for i, (d, c) in enumerate(zip(node.dims, classes))
                   if c == BCAST and d.nopc == 1 and k_shape[i] == d.k_size
                   and k_shape[i] != 1]
    windows = [i for i, c in enumerate(classes)
               if c == WINDOW and k_shape[i] == node.dims[i].nks]
    batch = [i for i, c in enumerate(classes)
             if c == BCAST and k_shape[i] == 1]
    if len(channel) != 1 or not windows:
        return None
    if sorted(channel + windows + batch) != list(range(len(classes))):
        return None
    return channel[0], windows, batch


_CONVS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def lower_conv(node: GConv, plan) -> Optional[Callable]:
    """``F.conv{1,2,3}d`` with ``groups``; None beyond 3 window dims.

    ``F.conv*d`` pads symmetrically, so a window's (pad, padr) pair is
    applied with an explicit ``F.pad`` and a negative ``padr`` (trailing
    input the windows never read) is cropped first, as the reference's
    ``lax.conv_general_dilated`` padding pairs do."""
    ch, windows, batch = plan
    if len(windows) not in _CONVS:
        return None
    conv = _CONVS[len(windows)]
    dims = node.dims
    dch = dims[ch]
    groups, ocg, icg = dch.ng, dch.nop, dch.nks
    strides = tuple(dims[i].stride for i in windows)
    perm = batch + [ch] + windows
    inv = np.argsort(perm).tolist()
    b_sizes = tuple(dims[i].in_size for i in batch)
    pads = []                               # F.pad order: last dim first
    for i in reversed(windows):
        pads += [dims[i].pad, max(dims[i].padr, 0)]

    def fn(x, k, lookup):
        ct = compute_dtype(x)
        x = x.to(ct)
        x = ops.apply_unary_seq(node.pre, x, lookup)
        # N = flattened batch axes; C = Ng*Nks of the channel dim
        xb = x.permute(perm).reshape((_prod(b_sizes), dch.in_size)
                                     + tuple(dims[i].nips for i in windows))
        for j, i in enumerate(windows):
            if dims[i].padr < 0:        # crop trailing elements never read
                xb = xb.narrow(2 + j, 0, dims[i].nips + dims[i].padr)
        if any(pads):
            xb = F.pad(xb, pads)
        kb = k.to(ct).permute([ch] + windows + batch)
        kb = kb.reshape((groups * ocg, icg)
                        + tuple(dims[i].nks for i in windows))
        y = conv(xb, kb, stride=strides, groups=groups)
        # (N, G*Nop, *Nopc) -> original dim order -> out_shape
        y = y.reshape(b_sizes + (groups * ocg,)
                      + tuple(dims[i].nopc for i in windows))
        y = y.permute(inv).reshape(node.out_shape)
        return _finish(node, y, lookup)

    return fn


def lower_conv_cuda(node: GConv, plan) -> Optional[Callable]:
    """NHWC spatial kernel (``gconv_spatial``) for the plain 2-D case
    (groups=1, square stride, symmetric padding); None when the geometry
    doesn't fit — the reference's ``lower_conv_pallas`` limits."""
    ch, windows, batch = plan
    dims = node.dims
    dch = dims[ch]
    if len(windows) != 2 or dch.ng != 1:
        return None
    dh, dw = dims[windows[0]], dims[windows[1]]
    if (dh.stride, dh.pad) != (dw.stride, dw.pad):
        return None
    if dh.padr != dh.pad or dw.padr != dw.pad:
        return None
    perm = batch + [ch] + windows
    inv = np.argsort(perm).tolist()
    b_sizes = tuple(dims[i].in_size for i in batch)

    def fn(x, k, lookup):
        ct = compute_dtype(x)
        x = x.to(ct)
        x = ops.apply_unary_seq(node.pre, x, lookup)
        xb = x.permute(perm).reshape(_prod(b_sizes), dch.in_size, dh.nips,
                                     dw.nips)
        xb = xb.permute(0, 2, 3, 1).contiguous()                 # NHWC
        kb = k.to(ct).permute([ch] + windows + batch)
        kb = kb.reshape(dch.nop, dch.nks, dh.nks, dw.nks)        # OIHW
        kb = kb.permute(2, 3, 1, 0).contiguous()                 # HWIO
        y = gconv_spatial(xb, kb, stride=dh.stride, pad=dh.pad)
        y = y.permute(0, 3, 1, 2)
        y = y.reshape(b_sizes + (dch.nop, dh.nopc, dw.nopc))
        y = y.permute(inv).reshape(node.out_shape)
        return _finish(node, y, lookup)

    return fn


# ---------------------------------------------------------------------------
# grouped matmul: main=mul/reduce=add, no window dims -> (G,M,K) @ (G,K,N)
# ---------------------------------------------------------------------------
def match_grouped_matmul(node: GConv, classes: Sequence[str],
                         k_shape: Optional[Tuple[int, ...]]):
    """Assign each dim a role in the grouped contraction, or None.

    roles: g_ix (batch groups, kernel varies per group), m_ix (x-only
    output axes), c_ix (contractions contributing N=Nop / K=Nks).
    """
    if node.main != "mul" or node.reduce != "add" or k_shape is None:
        return None
    g_ix, m_ix, c_ix = [], [], []
    for i, (d, c) in enumerate(zip(node.dims, classes)):
        ka = k_shape[i]
        if c == BCAST and ka == 1:
            m_ix.append(i)
        elif c == BCAST and ka == d.k_size and d.nopc == 1:
            g_ix.append(i)
        elif c == CONTRACT and d.ng == 1 and ka == d.k_size:
            c_ix.append(i)
        elif c == CONTRACT and d.ng == 1 and ka == 1 and d.nop == 1:
            c_ix.append(i)              # kernel constant across the taps
        else:
            return None
    return g_ix, m_ix, c_ix


def matmul_dims(node: GConv, plan) -> Tuple[int, int, int, int]:
    """(G, M, K, N) of the grouped contraction a matmul plan lowers to."""
    g_ix, m_ix, c_ix = plan
    dims = node.dims
    return (_prod([dims[i].ng for i in g_ix]),
            _prod([dims[i].in_size for i in m_ix]),
            _prod([dims[i].nks for i in c_ix]),
            _prod([dims[i].nop for i in c_ix]))


def _fused_matmul_seq(seq, dims, g_ix, m_ix, c_ix, stage, lookup):
    """Translate a pre/post Op sequence into the ``gconv_matmul``
    ``prologue``/``epilogue`` form: ``(name, const, slot)`` triples plus
    f32 contiguous operands reshaped to ``(G|1, M|1, 1)`` /
    ``(G|1, 1, L|1)`` (L = K for the prologue, N for the epilogue).
    Returns None when an operand's broadcast pattern doesn't fit those
    layouts — the caller then applies the sequence in torch instead."""
    triples, arrays = [], []
    for op in seq:
        if op.operand is None:
            triples.append((op.name, op.const, None))
            continue
        arr = lookup(op)
        if arr.dim() != len(dims):
            return None
        at = arr.permute(g_ix + m_ix + c_ix)
        ng, nm = len(g_ix), len(m_ix)
        g_sz = tuple(at.shape[:ng])
        m_sz = tuple(at.shape[ng:ng + nm])
        c_sz = tuple(at.shape[ng + nm:])
        g_full = tuple(dims[i].ng for i in g_ix)
        m_full = tuple(dims[i].in_size for i in m_ix)
        c_full = tuple((dims[i].nks if stage == "pro" else dims[i].nop)
                       for i in c_ix)

        def collapse(sz, full):
            if all(s == 1 for s in sz):
                return 1
            if sz == full:
                return _prod(full)
            return None                      # mixed broadcast: not fusable

        gp, mp, cp = (collapse(g_sz, g_full), collapse(m_sz, m_full),
                      collapse(c_sz, c_full))
        if gp is None or mp is None or cp is None:
            return None
        if mp != 1 and cp != 1:              # (G, M, L) has no kernel layout
            return None
        triples.append((op.name, op.const, len(arrays)))
        arrays.append(at.reshape(gp, mp, cp).to(torch.float32).contiguous())
    return tuple(triples), tuple(arrays)


def lower_grouped_matmul(node: GConv, plan, *,
                         kernel: bool = False) -> Callable:
    """``kernel=True``: the CUDA ``gconv_matmul`` with the pre/post
    sequences riding as its prologue/epilogue where their operands fit;
    otherwise ``torch.matmul``."""
    g_ix, m_ix, c_ix = plan
    dims = node.dims
    G, M, K, N = matmul_dims(node, plan)
    order = g_ix + m_ix + c_ix
    inv = np.argsort(order).tolist()
    out_axes = ([dims[i].ng for i in g_ix]
                + [dims[i].in_size for i in m_ix]
                + [dims[i].nop for i in c_ix])

    def fn(x, k, lookup):
        ct = compute_dtype(x)
        x = x.to(ct)
        # on the kernel path, ride the fused pre/post sequences in-register
        # (the §4.3 result) when their operands fit the kernel layouts
        pro = epi = None
        if kernel:
            pro = _fused_matmul_seq(node.pre, dims, g_ix, m_ix, c_ix,
                                    "pro", lookup)
            epi = _fused_matmul_seq(node.post, dims, g_ix, m_ix, c_ix,
                                    "epi", lookup)
        if pro is None:
            x = ops.apply_unary_seq(node.pre, x, lookup)
        xb = x.permute(order).reshape(G, M, K)
        # kernel: per-dim axes (g | squeeze-1 | (nop, nks)) -> (G, K, N)
        kshape, full, g_pos, nop_pos, nks_pos = [], [], [], [], []
        for i in order:
            d, ka = dims[i], k.shape[i]
            if i in g_ix:
                g_pos.append(len(kshape))
                kshape.append(ka)       # kernel always full on g dims
                full.append(ka)
            elif i in m_ix:
                kshape.append(1)
                full.append(1)
            else:
                nop_pos.append(len(kshape))
                kshape.append(d.nop if ka != 1 else 1)
                full.append(d.nop)
                nks_pos.append(len(kshape))
                kshape.append(d.nks if ka != 1 else 1)
                full.append(d.nks)
        kb = k.to(ct).permute(order).reshape(kshape)
        kb = kb.expand(full)            # expand broadcast-1 nop/nks axes
        rest = [p for p in range(len(kshape))
                if p not in g_pos + nop_pos + nks_pos]
        kb = kb.permute(g_pos + nop_pos + nks_pos + rest)
        kb = kb.reshape(G, N, K).transpose(1, 2)             # (G, K, N)
        if kernel:
            pro_seq, pro_ops = pro if pro is not None else ((), ())
            epi_seq, epi_ops = epi if epi is not None else ((), ())
            epi_seq = tuple((nm, c, None if s is None else s + len(pro_ops))
                            for nm, c, s in epi_seq)
            y = gconv_matmul(xb.contiguous(), kb.contiguous(),
                             prologue=pro_seq, epilogue=epi_seq,
                             operands=pro_ops + epi_ops)
        else:
            y = torch.matmul(xb, kb)                         # (G, M, N)
        y = y.reshape(out_axes).permute(inv).reshape(node.out_shape)
        if epi is not None:                  # post already ran in-register
            if node.out_dtype is not None:
                y = y.to(torch_dtype(node.out_dtype))
            return y
        return _finish(node, y, lookup)

    return fn


# ---------------------------------------------------------------------------
# generic windowed einsum: main=mul/reduce=add over any bcast/contract/window
# mix (conv-like weight-gradient patterns, grouped attention exotica)
# ---------------------------------------------------------------------------
def lower_einsum(node: GConv, classes: Sequence[str]) -> Callable:
    dims = node.dims
    letters = iter(string.ascii_letters)
    # per dim: labels (g, op, opc, ks)
    lab = [(next(letters), next(letters), next(letters), next(letters))
           for _ in dims]

    def fn(x, k, lookup):
        ct = compute_dtype(x)
        x = x.to(ct)
        x = ops.apply_unary_seq(node.pre, x, lookup)
        x_sub = []
        offset = 0
        for i, (d, c) in enumerate(zip(dims, classes)):
            g, o, cc, ks = lab[i]
            ax = i + offset
            if c == BCAST:
                x = x.reshape(x.shape[:ax] + (d.ng, d.nopc)
                              + x.shape[ax + 1:])
                x_sub += [g, cc]
            elif c == CONTRACT:
                x = x.reshape(x.shape[:ax] + (d.ng, d.nks)
                              + x.shape[ax + 1:])
                x_sub += [g, ks]
            else:                       # window (ng == 1)
                w = _window_gather(x, ax, d, 0.0)
                x = torch.movedim(w, (-2, -1), (ax, ax + 1))
                x_sub += [cc, ks]
            offset += 1
        k_sub, kshape = [], []
        for i, d in enumerate(dims):
            g, o, cc, ks = lab[i]
            kshape += [1, 1, 1] if k.shape[i] == 1 else [d.ng, d.nop, d.nks]
            k_sub += [g, o, ks]
        kb = k.to(ct).reshape(kshape)
        # drop singleton axes from both operands (einsum labels must agree
        # on size; a broadcast-1 axis simply leaves the label out)
        x_sub2 = [s for s, n in zip(x_sub, x.shape) if n != 1]
        xv = x.reshape([n for n in x.shape if n != 1])
        k_sub2 = [s for s, n in zip(k_sub, kb.shape) if n != 1]
        kv = kb.reshape([n for n in kb.shape if n != 1])
        # output labels: (g, op, opc) per dim, sizes from the dims
        out_sub, out_sizes = [], []
        for i, d in enumerate(dims):
            g, o, cc, ks = lab[i]
            for s, n in ((g, d.ng), (o, d.nop), (cc, d.nopc)):
                out_sub.append(s)
                out_sizes.append(n)
        kept = set(x_sub2) | set(k_sub2)
        out_keep = [s for s, n in zip(out_sub, out_sizes)
                    if n != 1 and s in kept]
        eq = f"{''.join(x_sub2)},{''.join(k_sub2)}->{''.join(out_keep)}"
        y = torch.einsum(eq, xv, kv)
        # re-broadcast output axes whose size>1 label vanished (kernel
        # broadcast across Nop) and restore singleton axes
        full, pos = [], 0
        for s, n in zip(out_sub, out_sizes):
            if n != 1 and s in kept:
                full.append(y.shape[pos])
                pos += 1
            else:
                full.append(1)
        y = y.reshape(full).expand(out_sizes).reshape(node.out_shape)
        return _finish(node, y, lookup)

    return fn


# ---------------------------------------------------------------------------
# oracle fallback
# ---------------------------------------------------------------------------
def lower_oracle(node: GConv) -> Callable:
    def fn(x, k, lookup):
        return eval_gconv(node, x, k, lookup)

    return fn
