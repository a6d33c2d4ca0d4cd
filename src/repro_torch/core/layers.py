"""Layer -> GCONV-chain decompositions (paper §3.2, Table 2).

Every function appends GCONV node(s) realizing one network layer to a
:class:`~repro_torch.core.chain.Chain` and returns the output node name. The
decompositions follow the paper exactly where the paper gives them (batch
normalization FP1–FP4 / BP1–BP6 in Table 2; LRN/conv/pool per §3.1's examples)
and follow the same dependency-analysis recipe for the rest.

``traditional`` metadata marks the LeNet-era layers (conv/FC/maxpool/ReLU/
softmax) that CIP accelerators natively handle (paper §2.2); everything else
is a "non-traditional" layer that baseline CIPs must offload.

A copy of the JAX package's ``repro.core.layers``: the IR is framework-free and
identical in both packages, so chains, parameter names and shapes agree
(``tests/test_torch_ir.py`` holds the copy to its original).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .chain import Chain, Concat, Movement
from .gconv import DimSpec, GConv, Op

# Default CNN layout: (B, C, H, W); 3-D CNNs use (B, C, T, H, W);
# LM chains use (B, T, C) or (B, H, Tq, Tk, D).


def _names(chain: Chain, base: str) -> str:
    """Fresh node-name prefix (multi-GCONV layers create '<base>.fpN' etc.)."""
    taken = list(chain.nodes) + list(chain.params) + list(chain.inputs)

    def clash(cand):
        return any(n == cand or n.startswith(cand + ".") for n in taken)

    if not clash(base):
        return base
    i = 1
    while clash(f"{base}_{i}"):
        i += 1
    return f"{base}_{i}"


def _elemwise_dims(names: Sequence[str], shape: Sequence[int]) -> Tuple[DimSpec, ...]:
    return tuple(DimSpec(name=n, ng=s) for n, s in zip(names, shape))


def _axis_names(rank: int) -> Tuple[str, ...]:
    if rank == 2:
        return ("B", "C")
    if rank == 3:
        return ("B", "T", "C")
    if rank == 4:
        return ("B", "C", "H", "W")
    if rank == 5:
        return ("B", "C", "T", "H", "W")
    return tuple(f"D{i}" for i in range(rank))


# ---------------------------------------------------------------------------
# traditional layers
# ---------------------------------------------------------------------------
def conv2d(chain: Chain, x: str, *, out_c: int, k: int, stride: int = 1,
           pad: int = 0, groups: int = 1, bias: bool = True,
           name: Optional[str] = None) -> str:
    """Standard/grouped/depthwise 2-D convolution as ONE GCONV (paper Fig. 5).

    Weight layout: ``(1, OC*ICg, kh, kw)`` — i.e. the standard
    ``(OC, ICg, kh, kw)`` tensor with the leading axes flattened into the C
    axis, which reads as ``(g, op, ks)`` per the GCONV kernel convention.
    """
    B, C, H, W = chain.shape_of(x)
    if C % groups:
        raise ValueError(f"C={C} not divisible by groups={groups}")
    if out_c % groups:
        raise ValueError(f"out_c={out_c} not divisible by groups={groups}")
    icg, ocg = C // groups, out_c // groups
    oh, pr_h = _slide(H, k, stride, pad, False)
    ow, pr_w = _slide(W, k, stride, pad, False)
    name = name or _names(chain, "conv")
    w = chain.add_param(f"{name}.w", (1, groups * ocg * icg, k, k))
    post = ()
    if bias:
        b = chain.add_param(f"{name}.b", (1, out_c, 1, 1))
        post = (Op("add", operand=b),)
    depthwise = (groups == C and ocg >= 1 and icg == 1)
    node = GConv(
        name=name,
        dims=(
            DimSpec("B", nopc=B),
            DimSpec("C", ng=groups, nop=ocg, nks=icg),
            DimSpec("H", nopc=oh, nks=k, stride=stride, pad=pad, pad_r=pr_h),
            DimSpec("W", nopc=ow, nks=k, stride=stride, pad=pad, pad_r=pr_w),
        ),
        input=x, kernel=w, main="mul", reduce="add", post=post)
    return chain.add(node, layer="depthwise_conv" if depthwise else "conv2d",
                     traditional=not depthwise)


def conv3d(chain: Chain, x: str, *, out_c: int, k: int, kt: int,
           stride: int = 1, stride_t: int = 1, pad: int = 0, pad_t: int = 0,
           bias: bool = True, name: Optional[str] = None) -> str:
    """3-D convolution (C3D): GCONV with an extra T dimension (paper §3.1)."""
    B, C, T, H, W = chain.shape_of(x)
    ot, pr_t = _slide(T, kt, stride_t, pad_t, False)
    oh, pr_h = _slide(H, k, stride, pad, False)
    ow, pr_w = _slide(W, k, stride, pad, False)
    name = name or _names(chain, "conv3d")
    w = chain.add_param(f"{name}.w", (1, out_c * C, kt, k, k))
    post = ()
    if bias:
        b = chain.add_param(f"{name}.b", (1, out_c, 1, 1, 1))
        post = (Op("add", operand=b),)
    node = GConv(
        name=name,
        dims=(
            DimSpec("B", nopc=B),
            DimSpec("C", nop=out_c, nks=C),
            DimSpec("T", nopc=ot, nks=kt, stride=stride_t, pad=pad_t, pad_r=pr_t),
            DimSpec("H", nopc=oh, nks=k, stride=stride, pad=pad, pad_r=pr_h),
            DimSpec("W", nopc=ow, nks=k, stride=stride, pad=pad, pad_r=pr_w),
        ),
        input=x, kernel=w, main="mul", reduce="add", post=post)
    return chain.add(node, layer="conv3d", traditional=False)


def fc(chain: Chain, x: str, *, out_f: int, bias: bool = True,
       name: Optional[str] = None) -> str:
    """Fully-connected layer: GCONV whose kernel covers the whole input."""
    B, C = chain.shape_of(x)
    name = name or _names(chain, "fc")
    w = chain.add_param(f"{name}.w", (1, out_f * C))
    post = ()
    if bias:
        b = chain.add_param(f"{name}.b", (1, out_f))
        post = (Op("add", operand=b),)
    node = GConv(
        name=name,
        dims=(DimSpec("B", nopc=B), DimSpec("C", nop=out_f, nks=C)),
        input=x, kernel=w, main="mul", reduce="add", post=post)
    return chain.add(node, layer="fc", traditional=True)


def linear(chain: Chain, x: str, *, out_f: int, bias: bool = False,
           name: Optional[str] = None) -> str:
    """Linear over the last axis of a rank-3 (B, T, C) tensor (LM layers)."""
    B, T, C = chain.shape_of(x)
    name = name or _names(chain, "linear")
    w = chain.add_param(f"{name}.w", (1, 1, out_f * C))
    post = ()
    if bias:
        b = chain.add_param(f"{name}.b", (1, 1, out_f))
        post = (Op("add", operand=b),)
    node = GConv(
        name=name,
        dims=(DimSpec("B", ng=B), DimSpec("T", nopc=T),
              DimSpec("C", nop=out_f, nks=C)),
        input=x, kernel=w, main="mul", reduce="add", post=post)
    return chain.add(node, layer="linear", traditional=True)


def activation(chain: Chain, x: str, fn: str = "relu", const: float = None,
               name: Optional[str] = None) -> str:
    shape = chain.shape_of(x)
    names = _axis_names(len(shape))
    name = name or _names(chain, fn)
    node = GConv(name=name, dims=_elemwise_dims(names, shape), input=x,
                 main="none", reduce="none", post=(Op(fn, const=const),))
    return chain.add(node, layer=fn, traditional=(fn == "relu"))


def relu(chain: Chain, x: str, name: Optional[str] = None) -> str:
    return activation(chain, x, "relu", name=name)


def _slide(size: int, k: int, stride: int, pad: int, ceil_mode: bool):
    """Output count + right padding for possibly-inexact sliding geometry."""
    num = size + 2 * pad - k
    n_out = (-(-num // stride) if ceil_mode else num // stride) + 1
    span = (n_out - 1) * stride + k
    pad_r = span - size - pad           # may differ from pad; may be negative
    return n_out, pad_r


def _pool(chain: Chain, x: str, k, stride, pad, mode: str, kt=None,
          stride_t=None, ceil_mode=False, name=None) -> str:
    shape = chain.shape_of(x)
    rank = len(shape)
    name = name or _names(chain, f"{mode}pool")
    if rank == 4:
        B, C, H, W = shape
        oh, pr_h = _slide(H, k, stride, pad, ceil_mode)
        ow, pr_w = _slide(W, k, stride, pad, ceil_mode)
        dims = (DimSpec("B", ng=B), DimSpec("C", ng=C),
                DimSpec("H", nopc=oh, nks=k, stride=stride, pad=pad, pad_r=pr_h),
                DimSpec("W", nopc=ow, nks=k, stride=stride, pad=pad, pad_r=pr_w))
        win = k * k
        layer = f"{mode}pool2d"
        traditional = (mode == "max")
    else:
        B, C, T, H, W = shape
        kt = kt or k
        stride_t = stride_t or stride
        ot, pr_t = _slide(T, kt, stride_t, 0, ceil_mode)
        oh, pr_h = _slide(H, k, stride, pad, ceil_mode)
        ow, pr_w = _slide(W, k, stride, pad, ceil_mode)
        dims = (DimSpec("B", ng=B), DimSpec("C", ng=C),
                DimSpec("T", nopc=ot, nks=kt, stride=stride_t, pad_r=pr_t),
                DimSpec("H", nopc=oh, nks=k, stride=stride, pad=pad, pad_r=pr_h),
                DimSpec("W", nopc=ow, nks=k, stride=stride, pad=pad, pad_r=pr_w))
        win = k * k * kt
        layer = f"{mode}pool3d"
        traditional = False
    post = (Op("scale", const=1.0 / win),) if mode == "avg" else ()
    node = GConv(name=name, dims=dims, input=x, main="none",
                 reduce="max" if mode == "max" else "add", post=post)
    return chain.add(node, layer=layer, traditional=traditional)


def maxpool2d(chain, x, *, k, stride, pad=0, ceil_mode=False, name=None) -> str:
    return _pool(chain, x, k, stride, pad, "max", ceil_mode=ceil_mode, name=name)


def avgpool2d(chain, x, *, k, stride, pad=0, ceil_mode=False, name=None) -> str:
    return _pool(chain, x, k, stride, pad, "avg", ceil_mode=ceil_mode, name=name)


def maxpool3d(chain, x, *, k, stride, kt, stride_t, pad=0, name=None) -> str:
    return _pool(chain, x, k, stride, pad, "max", kt=kt, stride_t=stride_t,
                 name=name)


def global_avgpool2d(chain, x, name=None) -> str:
    _, _, H, W = chain.shape_of(x)
    return _pool(chain, x, H, 1, 0, "avg", name=name)


def softmax(chain: Chain, x: str, axis: int = -1,
            name: Optional[str] = None) -> str:
    """Softmax over one axis: 4 GCONVs (max, sub+exp, sum, div)."""
    shape = chain.shape_of(x)
    rank = len(shape)
    axis = axis % rank
    names = _axis_names(rank)
    name = name or _names(chain, "softmax")

    def dims(reduce_axis: bool):
        out = []
        for i, (n, s) in enumerate(zip(names, shape)):
            if i == axis and reduce_axis:
                out.append(DimSpec(n, nks=s))
            else:
                out.append(DimSpec(n, ng=s))
        return tuple(out)

    m = chain.add(GConv(name=f"{name}.max", dims=dims(True), input=x,
                        main="none", reduce="max"),
                  layer="softmax", traditional=True)
    e = chain.add(GConv(name=f"{name}.exp", dims=dims(False), input=x,
                        kernel=m, main="sub", reduce="none",
                        post=(Op("exp"),)),
                  layer="softmax", traditional=True)
    s = chain.add(GConv(name=f"{name}.sum", dims=dims(True), input=e,
                        main="none", reduce="add"),
                  layer="softmax", traditional=True)
    node = GConv(name=name, dims=dims(False), input=e, kernel=s,
                 main="div", reduce="none")
    return chain.add(node, layer="softmax", traditional=True)


# ---------------------------------------------------------------------------
# non-traditional layers
# ---------------------------------------------------------------------------
def lrn(chain: Chain, x: str, *, n: int = 5, alpha: float = 1e-4,
        beta: float = 0.75, k_const: float = 2.0,
        name: Optional[str] = None) -> str:
    """Local response normalization (AlexNet): GCONV in the C dimension
    (paper §1: "LRN can be viewed as a general convolution in the channel
    dimension"). b = a / (k + (alpha/n) * sum_window a^2)^beta."""
    B, C, H, W = chain.shape_of(x)
    assert n % 2 == 1
    name = name or _names(chain, "lrn")
    denom = chain.add(
        GConv(name=f"{name}.den",
              dims=(DimSpec("B", ng=B),
                    DimSpec("C", nopc=C, nks=n, pad=n // 2),
                    DimSpec("H", ng=H), DimSpec("W", ng=W)),
              input=x, main="none", reduce="add",
              pre=(Op("square"),),
              post=(Op("scale", const=alpha / n),
                    Op("add_const", const=k_const),
                    Op("pow", const=-beta))),
        layer="lrn", traditional=False)
    node = GConv(name=name, dims=_elemwise_dims(("B", "C", "H", "W"),
                                                (B, C, H, W)),
                 input=x, kernel=denom, main="mul", reduce="none")
    return chain.add(node, layer="lrn", traditional=False)


def dropout(chain: Chain, x: str, rate: float = 0.5,
            name: Optional[str] = None) -> str:
    """Training-mode dropout: elementwise multiply with a mask tensor
    (the mask is a chain input — RNG happens outside the accelerator)."""
    shape = chain.shape_of(x)
    names = _axis_names(len(shape))
    name = name or _names(chain, "dropout")
    mask = chain.add_input(f"{name}.mask", shape)
    node = GConv(name=name, dims=_elemwise_dims(names, shape), input=x,
                 kernel=mask, main="mul", reduce="none",
                 post=(Op("scale", const=1.0 / (1.0 - rate)),))
    return chain.add(node, layer="dropout", traditional=False)


def batch_norm_fp(chain: Chain, x: str, eps: float = 1e-5,
                  name: Optional[str] = None,
                  spatial: bool = False) -> Tuple[str, dict]:
    """Batch normalization forward, paper Table 2 FP1–FP4 (exact).

    ``spatial=False`` reproduces Table 2 literally (statistics over the batch
    dimension only — per-activation normalization). ``spatial=True`` also
    reduces H/W (the convnet-usual per-channel statistics); the GCONV
    decomposition is identical, with Nks instead of Nopc on H/W in FP1/FP3.
    Returns (output node, dict of intermediate node names FP1..FP4).
    """
    B, C, H, W = chain.shape_of(x)
    name = name or _names(chain, "bn")
    nred = B * (H * W if spatial else 1)

    def stat_dims():
        # FP1/FP3 rows of Table 2: [Nks: Nbs] in B; Nopc elsewhere.
        if spatial:
            return (DimSpec("B", nks=B), DimSpec("C", nopc=C),
                    DimSpec("H", nks=H), DimSpec("W", nks=W))
        return (DimSpec("B", nks=B), DimSpec("C", nopc=C),
                DimSpec("H", nopc=H), DimSpec("W", nopc=W))

    def bcast_dims():
        # FP2/FP4 rows: [Nopc: Nbs] in B; Ng elsewhere.
        return (DimSpec("B", nopc=B), DimSpec("C", ng=C),
                DimSpec("H", ng=H), DimSpec("W", ng=W))

    fp1 = chain.add(GConv(name=f"{name}.fp1", dims=stat_dims(), input=x,
                          main="none", reduce="add",
                          post=(Op("scale", const=1.0 / nred),)),
                    layer="batchnorm", traditional=False)        # mu
    fp2 = chain.add(GConv(name=f"{name}.fp2", dims=bcast_dims(), input=x,
                          kernel=fp1, main="sub", reduce="none"),
                    layer="batchnorm", traditional=False)        # t1 = I - mu
    fp3 = chain.add(GConv(name=f"{name}.fp3", dims=stat_dims(), input=fp2,
                          pre=(Op("square"),), main="none", reduce="add",
                          post=(Op("scale", const=1.0 / nred),
                                Op("rsqrt_eps", const=eps))),
                    layer="batchnorm", traditional=False)        # t2
    fp4 = chain.add(GConv(name=f"{name}.fp4", dims=bcast_dims(), input=fp2,
                          kernel=fp3, main="mul", reduce="none"),
                    layer="batchnorm", traditional=False)        # O
    return fp4, dict(fp1=fp1, fp2=fp2, fp3=fp3, fp4=fp4)


def batch_norm_bp(chain: Chain, g_out: str, fp: dict,
                  name: Optional[str] = None,
                  spatial: bool = False) -> Tuple[str, dict]:
    """Batch normalization backward, paper Table 2 BP1–BP6 + Eq. (5).

    ``g_out`` is the upstream gradient gO; ``fp`` is the dict returned by
    :func:`batch_norm_fp` (needs fp3 = 1/sqrt(var+eps) and fp4 = O).
    """
    B, C, H, W = chain.shape_of(g_out)
    name = name or _names(chain, "bn_bp")
    nred = B * (H * W if spatial else 1)

    def stat_dims():
        if spatial:
            return (DimSpec("B", nks=B), DimSpec("C", nopc=C),
                    DimSpec("H", nks=H), DimSpec("W", nks=W))
        return (DimSpec("B", nks=B), DimSpec("C", nopc=C),
                DimSpec("H", nopc=H), DimSpec("W", nopc=W))

    def kstat_dims():
        # Table 2 BP1 row: [Nks:Nbs][Ng:Nic][Ng:Nix][Ng:Niy] — with a kernel
        # the per-position independence is groups, so the kernel (= FP4 = O)
        # varies across C/H/W while the taps reduce the batch.
        if spatial:
            return (DimSpec("B", nks=B), DimSpec("C", ng=C),
                    DimSpec("H", nks=H), DimSpec("W", nks=W))
        return (DimSpec("B", nks=B), DimSpec("C", ng=C),
                DimSpec("H", ng=H), DimSpec("W", ng=W))

    def bcast_dims():
        return (DimSpec("B", nopc=B), DimSpec("C", ng=C),
                DimSpec("H", ng=H), DimSpec("W", ng=W))

    def elem_dims():
        return (DimSpec("B", ng=B), DimSpec("C", ng=C),
                DimSpec("H", ng=H), DimSpec("W", ng=W))

    bp1 = chain.add(GConv(name=f"{name}.bp1", dims=kstat_dims(), input=g_out,
                          kernel=fp["fp4"], main="mul", reduce="add",
                          post=(Op("scale", const=1.0 / nred),)),
                    layer="batchnorm_bp", traditional=False)  # t3
    bp2 = chain.add(GConv(name=f"{name}.bp2", dims=bcast_dims(),
                          input=fp["fp4"], kernel=bp1, main="mul",
                          reduce="none"),
                    layer="batchnorm_bp", traditional=False)  # t4 = O*t3
    bp3 = chain.add(GConv(name=f"{name}.bp3", dims=stat_dims(), input=g_out,
                          main="none", reduce="add",
                          post=(Op("scale", const=1.0 / nred),)),
                    layer="batchnorm_bp", traditional=False)  # t5
    bp4 = chain.add(GConv(name=f"{name}.bp4", dims=bcast_dims(), input=g_out,
                          kernel=bp3, main="sub", reduce="none"),
                    layer="batchnorm_bp", traditional=False)  # t6 = gO - t5
    bp5 = chain.add(GConv(name=f"{name}.bp5", dims=elem_dims(), input=bp4,
                          kernel=bp2, main="sub", reduce="none"),
                    layer="batchnorm_bp", traditional=False)  # t7 = t6 - t4
    bp6 = chain.add(GConv(name=f"{name}.bp6", dims=elem_dims(), input=bp5,
                          kernel=fp["fp3"], main="mul", reduce="none"),
                    layer="batchnorm_bp", traditional=False)  # gI = t7 * t2
    return bp6, dict(bp1=bp1, bp2=bp2, bp3=bp3, bp4=bp4, bp5=bp5, bp6=bp6)


def scale_layer(chain: Chain, x: str, name: Optional[str] = None) -> str:
    """Caffe Scale layer (DenseNet): per-channel y = gamma*x + beta."""
    B, C, H, W = chain.shape_of(x)
    name = name or _names(chain, "scale")
    gamma = chain.add_param(f"{name}.gamma", (1, C, 1, 1))
    beta = chain.add_param(f"{name}.beta", (1, C, 1, 1))
    node = GConv(name=name,
                 dims=(DimSpec("B", nopc=B), DimSpec("C", ng=C),
                       DimSpec("H", ng=H), DimSpec("W", ng=W)),
                 input=x, kernel=gamma, main="mul", reduce="none",
                 post=(Op("add", operand=beta),))
    return chain.add(node, layer="scale", traditional=False)


def add_tensors(chain: Chain, a: str, b: str, name: Optional[str] = None,
                layer: str = "add", traditional: bool = False) -> str:
    """Elementwise residual add: GCONV with main=add, kernel = other tensor."""
    shape = chain.shape_of(a)
    names = _axis_names(len(shape))
    name = name or _names(chain, "add")
    node = GConv(name=name, dims=_elemwise_dims(names, shape), input=a,
                 kernel=b, main="add", reduce="none")
    return chain.add(node, layer=layer, traditional=traditional)


def mul_tensors(chain: Chain, a: str, b: str, name: Optional[str] = None,
                layer: str = "mul", traditional: bool = False) -> str:
    shape = chain.shape_of(a)
    names = _axis_names(len(shape))
    name = name or _names(chain, "mul")
    node = GConv(name=name, dims=_elemwise_dims(names, shape), input=a,
                 kernel=b, main="mul", reduce="none")
    return chain.add(node, layer=layer, traditional=traditional)


def concat(chain: Chain, xs: Sequence[str], axis: int = 1,
           name: Optional[str] = None) -> str:
    name = name or _names(chain, "concat")
    return chain.add(Concat(name=name, inputs=tuple(xs), axis=axis),
                     layer="concat", traditional=False)


def view(chain: Chain, x: str, out_shape: Sequence[int],
         perm: Optional[Sequence[int]] = None,
         pre_shape: Optional[Sequence[int]] = None,
         name: Optional[str] = None) -> str:
    name = name or _names(chain, "view")
    return chain.add(Movement(name=name, input=x,
                              perm=tuple(perm) if perm else None,
                              pre_shape=tuple(pre_shape) if pre_shape
                              else None,
                              out_shape=tuple(out_shape)),
                     layer="view", traditional=True)


# ---------------------------------------------------------------------------
# LM-era layers (framework integration; DESIGN.md §3)
# ---------------------------------------------------------------------------
def rms_norm(chain: Chain, x: str, eps: float = 1e-6,
             name: Optional[str] = None) -> str:
    """RMSNorm: 2 GCONVs (square-mean-rsqrt; scale) + learned gamma."""
    B, T, C = chain.shape_of(x)
    name = name or _names(chain, "rmsnorm")
    gamma = chain.add_param(f"{name}.gamma", (1, 1, C))
    denom = chain.add(
        GConv(name=f"{name}.ms",
              dims=(DimSpec("B", ng=B), DimSpec("T", ng=T),
                    DimSpec("C", nks=C)),
              input=x, pre=(Op("square"),), main="none", reduce="add",
              post=(Op("scale", const=1.0 / C), Op("rsqrt_eps", const=eps))),
        layer="rmsnorm", traditional=False)
    node = GConv(name=name,
                 dims=(DimSpec("B", ng=B), DimSpec("T", ng=T),
                       DimSpec("C", ng=C)),
                 input=x, kernel=denom, main="mul", reduce="none",
                 post=(Op("mul", operand=gamma),))
    return chain.add(node, layer="rmsnorm", traditional=False)


def attention_scores(chain: Chain, q: str, k: str, scale: float,
                     name: Optional[str] = None) -> str:
    """QK^T as a 5-D GCONV. q: (B,H,Tq,1,D) kernel view; k: (B,H,1,Tk,D).

    Dims: B[Ng], H[Ng], Tq[Nop], Tk[Nopc], D[Nks]; input=K, kernel=Q —
    exactly the paper's "kernel covers the entire input" FC pattern, with the
    query axis playing Nop and the key axis playing Nopc.
    """
    Bq, Hq, Tq, oneq, D = chain.shape_of(q)
    Bk, Hk, onek, Tk, Dk = chain.shape_of(k)
    assert (Bq, Hq, D) == (Bk, Hk, Dk) and oneq == 1 and onek == 1
    name = name or _names(chain, "scores")
    node = GConv(
        name=name,
        dims=(DimSpec("B", ng=Bq), DimSpec("H", ng=Hq),
              DimSpec("Tq", nop=Tq), DimSpec("Tk", nopc=Tk),
              DimSpec("D", nks=D)),
        input=k, kernel=q, main="mul", reduce="add",
        post=(Op("scale", const=scale),))
    return chain.add(node, layer="attention", traditional=True)


def attention_values(chain: Chain, probs: str, v: str,
                     name: Optional[str] = None) -> str:
    """P @ V as a 5-D GCONV: input=probs (B,H,Tq,Tk,1), kernel=V (B,H,1,Tk,D).

    Dims: B[Ng], H[Ng], Tq[Ng], Tk[Nks], D[Nop]: per (b,h,tq) the kernel's
    D-many taps reduce over the key axis.
    """
    B, H, Tq, Tk, one = chain.shape_of(probs)
    Bv, Hv, onev, Tkv, D = chain.shape_of(v)
    assert (B, H, Tk) == (Bv, Hv, Tkv) and one == 1 and onev == 1
    name = name or _names(chain, "attnv")
    node = GConv(
        name=name,
        dims=(DimSpec("B", ng=B), DimSpec("H", ng=H), DimSpec("Tq", ng=Tq),
              DimSpec("Tk", nks=Tk), DimSpec("D", nop=D)),
        input=probs, kernel=v, main="mul", reduce="add")
    return chain.add(node, layer="attention", traditional=True)
