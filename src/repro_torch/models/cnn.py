"""The paper's seven benchmark CNNs as GCONV chains (Table 1(a)).

  AN    AlexNet            — LRN, dropout
  GLN   GoogLeNet          — ave pool, concat
  DN    DenseNet-121       — batch norm, scale
  MN    MobileNet v1       — depthwise conv
  ZFFR  ZFNet+Faster R-CNN — RoI pooling, proposal
  C3D   C3D                — 3-D conv, 3-D pool
  CapNN CapsNet            — primary/digit capsules (dynamic routing)

Every builder returns a full-size analysis :class:`Chain` (chains are
metadata — nothing is allocated; the interpreter only ever executes reduced
variants, see ``reduced=True``). Layer/traditional tags drive the Table-1 and
baseline-offload benchmarks.

Training-mode microbenchmarks (FP+BP) are provided for the paper's own
example (batch norm, Table 2) via :func:`training_block_chain`.

A copy of the JAX package's ``repro.models.cnn`` (held to it by
``tests/test_torch_ir.py``), except that :func:`random_inputs` draws with
numpy: the port cannot reproduce ``jax.random``.
"""
from __future__ import annotations


from ..core import layers as L
from ..core.chain import Chain, Movement
from ..core.gconv import DimSpec, GConv, Op


# ---------------------------------------------------------------------------
# AlexNet
# ---------------------------------------------------------------------------
def alexnet(batch: int = 32, reduced: bool = False) -> Chain:
    if reduced:
        return _alexnet_reduced(batch)
    c = Chain("AN")
    x = c.add_input("x", (batch, 3, 227, 227))
    x = L.conv2d(c, x, out_c=96, k=11, stride=4, name="conv1")
    x = L.relu(c, x)
    x = L.lrn(c, x)
    x = L.maxpool2d(c, x, k=3, stride=2)
    x = L.conv2d(c, x, out_c=256, k=5, pad=2, groups=2, name="conv2")
    x = L.relu(c, x)
    x = L.lrn(c, x)
    x = L.maxpool2d(c, x, k=3, stride=2)
    x = L.conv2d(c, x, out_c=384, k=3, pad=1, name="conv3")
    x = L.relu(c, x)
    x = L.conv2d(c, x, out_c=384, k=3, pad=1, groups=2, name="conv4")
    x = L.relu(c, x)
    x = L.conv2d(c, x, out_c=256, k=3, pad=1, groups=2, name="conv5")
    x = L.relu(c, x)
    x = L.maxpool2d(c, x, k=3, stride=2)
    x = L.view(c, x, (batch, 256 * 6 * 6))
    x = L.fc(c, x, out_f=4096, name="fc6")
    x = L.relu(c, x)
    x = L.dropout(c, x)
    x = L.fc(c, x, out_f=4096, name="fc7")
    x = L.relu(c, x)
    x = L.dropout(c, x)
    x = L.fc(c, x, out_f=1000, name="fc8")
    x = L.softmax(c, x)
    c.mark_output(x)
    return c


def _alexnet_reduced(batch: int) -> Chain:
    c = Chain("AN-reduced")
    x = c.add_input("x", (batch, 3, 19, 19))
    x = L.conv2d(c, x, out_c=8, k=3, stride=2, name="conv1")
    x = L.relu(c, x)
    x = L.lrn(c, x, n=3)
    x = L.maxpool2d(c, x, k=3, stride=2)
    x = L.conv2d(c, x, out_c=16, k=3, pad=1, groups=2, name="conv2")
    x = L.relu(c, x)
    x = L.view(c, x, (batch, 16 * 4 * 4))
    x = L.fc(c, x, out_f=32, name="fc6")
    x = L.relu(c, x)
    x = L.dropout(c, x)
    x = L.fc(c, x, out_f=10, name="fc8")
    x = L.softmax(c, x)
    c.mark_output(x)
    return c


# ---------------------------------------------------------------------------
# GoogLeNet (Inception v1)
# ---------------------------------------------------------------------------
_INCEPTION = {  # name: (b1, b3r, b3, b5r, b5, pool_proj)
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def _inception(c: Chain, x: str, cfg, name: str) -> str:
    b1, b3r, b3, b5r, b5, pp = cfg
    y1 = L.conv2d(c, x, out_c=b1, k=1, name=f"{name}.1x1")
    y1 = L.relu(c, y1)
    y3 = L.conv2d(c, x, out_c=b3r, k=1, name=f"{name}.3x3r")
    y3 = L.relu(c, y3)
    y3 = L.conv2d(c, y3, out_c=b3, k=3, pad=1, name=f"{name}.3x3")
    y3 = L.relu(c, y3)
    y5 = L.conv2d(c, x, out_c=b5r, k=1, name=f"{name}.5x5r")
    y5 = L.relu(c, y5)
    y5 = L.conv2d(c, y5, out_c=b5, k=5, pad=2, name=f"{name}.5x5")
    y5 = L.relu(c, y5)
    yp = L.maxpool2d(c, x, k=3, stride=1, pad=1, name=f"{name}.pool")
    yp = L.conv2d(c, yp, out_c=pp, k=1, name=f"{name}.proj")
    yp = L.relu(c, yp)
    return L.concat(c, [y1, y3, y5, yp], axis=1, name=f"{name}.concat")


def googlenet(batch: int = 32, reduced: bool = False) -> Chain:
    if reduced:
        return _googlenet_reduced(batch)
    c = Chain("GLN")
    x = c.add_input("x", (batch, 3, 224, 224))
    x = L.conv2d(c, x, out_c=64, k=7, stride=2, pad=3, name="conv1")
    x = L.relu(c, x)
    x = L.maxpool2d(c, x, k=3, stride=2, ceil_mode=True)
    x = L.lrn(c, x)
    x = L.conv2d(c, x, out_c=64, k=1, name="conv2r")
    x = L.relu(c, x)
    x = L.conv2d(c, x, out_c=192, k=3, pad=1, name="conv2")
    x = L.relu(c, x)
    x = L.lrn(c, x)
    x = L.maxpool2d(c, x, k=3, stride=2, ceil_mode=True)
    for n in ("3a", "3b"):
        x = _inception(c, x, _INCEPTION[n], n)
    x = L.maxpool2d(c, x, k=3, stride=2, ceil_mode=True)
    for n in ("4a", "4b", "4c", "4d", "4e"):
        x = _inception(c, x, _INCEPTION[n], n)
    x = L.maxpool2d(c, x, k=3, stride=2, ceil_mode=True)
    for n in ("5a", "5b"):
        x = _inception(c, x, _INCEPTION[n], n)
    x = L.global_avgpool2d(c, x)
    x = L.dropout(c, x, rate=0.4)
    x = L.view(c, x, (batch, 1024))
    x = L.fc(c, x, out_f=1000, name="loss3")
    x = L.softmax(c, x)
    c.mark_output(x)
    return c


def _googlenet_reduced(batch: int) -> Chain:
    c = Chain("GLN-reduced")
    x = c.add_input("x", (batch, 3, 16, 16))
    x = L.conv2d(c, x, out_c=8, k=3, stride=2, pad=1, name="conv1")
    x = L.relu(c, x)
    x = _inception(c, x, (4, 4, 8, 2, 4, 4), "3a")
    x = L.global_avgpool2d(c, x)
    x = L.view(c, x, (batch, 20))
    x = L.fc(c, x, out_f=10)
    x = L.softmax(c, x)
    c.mark_output(x)
    return c


# ---------------------------------------------------------------------------
# DenseNet-121
# ---------------------------------------------------------------------------
def _bn_scale_relu(c: Chain, x: str, name: str) -> str:
    y, _ = L.batch_norm_fp(c, x, name=f"{name}.bn")
    y = L.scale_layer(c, y, name=f"{name}.scale")
    return L.relu(c, y)


def densenet121(batch: int = 32, reduced: bool = False,
                growth: int = 32) -> Chain:
    if reduced:
        return _densenet_reduced(batch)
    blocks = (6, 12, 24, 16)
    c = Chain("DN")
    x = c.add_input("x", (batch, 3, 224, 224))
    x = L.conv2d(c, x, out_c=64, k=7, stride=2, pad=3, bias=False,
                 name="conv1")
    x = _bn_scale_relu(c, x, "conv1")
    x = L.maxpool2d(c, x, k=3, stride=2, pad=1)
    ch = 64
    for bi, n_layers in enumerate(blocks):
        for li in range(n_layers):
            name = f"b{bi}l{li}"
            y = _bn_scale_relu(c, x, f"{name}.a")
            y = L.conv2d(c, y, out_c=4 * growth, k=1, bias=False,
                         name=f"{name}.conv1x1")
            y = _bn_scale_relu(c, y, f"{name}.b")
            y = L.conv2d(c, y, out_c=growth, k=3, pad=1, bias=False,
                         name=f"{name}.conv3x3")
            x = L.concat(c, [x, y], axis=1, name=f"{name}.cat")
            ch += growth
        if bi < len(blocks) - 1:
            name = f"t{bi}"
            x = _bn_scale_relu(c, x, name)
            ch //= 2
            x = L.conv2d(c, x, out_c=ch, k=1, bias=False, name=f"{name}.conv")
            x = L.avgpool2d(c, x, k=2, stride=2, name=f"{name}.pool")
    x = _bn_scale_relu(c, x, "final")
    x = L.global_avgpool2d(c, x)
    x = L.view(c, x, (batch, ch))
    x = L.fc(c, x, out_f=1000)
    x = L.softmax(c, x)
    c.mark_output(x)
    return c


def _densenet_reduced(batch: int) -> Chain:
    c = Chain("DN-reduced")
    x = c.add_input("x", (batch, 3, 16, 16))
    x = L.conv2d(c, x, out_c=8, k=3, stride=2, pad=1, bias=False)
    x = _bn_scale_relu(c, x, "stem")
    for li in range(2):
        y = _bn_scale_relu(c, x, f"l{li}.a")
        y = L.conv2d(c, y, out_c=8, k=1, bias=False, name=f"l{li}.c1")
        y = _bn_scale_relu(c, y, f"l{li}.b")
        y = L.conv2d(c, y, out_c=4, k=3, pad=1, bias=False, name=f"l{li}.c3")
        x = L.concat(c, [x, y], axis=1, name=f"l{li}.cat")
    x = L.global_avgpool2d(c, x)
    x = L.view(c, x, (batch, 16))
    x = L.fc(c, x, out_f=10)
    x = L.softmax(c, x)
    c.mark_output(x)
    return c


# ---------------------------------------------------------------------------
# MobileNet v1
# ---------------------------------------------------------------------------
_MOBILENET_CFG = [  # (out_c, stride) for depthwise-separable pairs
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]


def mobilenet(batch: int = 32, reduced: bool = False) -> Chain:
    if reduced:
        return _mobilenet_reduced(batch)
    c = Chain("MN")
    x = c.add_input("x", (batch, 3, 224, 224))
    x = L.conv2d(c, x, out_c=32, k=3, stride=2, pad=1, bias=False,
                 name="conv1")
    x = _bn_scale_relu(c, x, "conv1")
    ch = 32
    for i, (out_c, s) in enumerate(_MOBILENET_CFG):
        x = L.conv2d(c, x, out_c=ch, k=3, stride=s, pad=1, groups=ch,
                     bias=False, name=f"dw{i}")
        x = _bn_scale_relu(c, x, f"dw{i}")
        x = L.conv2d(c, x, out_c=out_c, k=1, bias=False, name=f"pw{i}")
        x = _bn_scale_relu(c, x, f"pw{i}")
        ch = out_c
    x = L.global_avgpool2d(c, x)
    x = L.view(c, x, (batch, 1024))
    x = L.fc(c, x, out_f=1000)
    x = L.softmax(c, x)
    c.mark_output(x)
    return c


def _mobilenet_reduced(batch: int) -> Chain:
    c = Chain("MN-reduced")
    x = c.add_input("x", (batch, 3, 16, 16))
    x = L.conv2d(c, x, out_c=8, k=3, stride=2, pad=1, bias=False)
    x = _bn_scale_relu(c, x, "stem")
    x = L.conv2d(c, x, out_c=8, k=3, pad=1, groups=8, bias=False, name="dw0")
    x = _bn_scale_relu(c, x, "dw0")
    x = L.conv2d(c, x, out_c=16, k=1, bias=False, name="pw0")
    x = _bn_scale_relu(c, x, "pw0")
    x = L.global_avgpool2d(c, x)
    x = L.view(c, x, (batch, 16))
    x = L.fc(c, x, out_f=10)
    x = L.softmax(c, x)
    c.mark_output(x)
    return c


# ---------------------------------------------------------------------------
# ZFNet + Faster R-CNN
# ---------------------------------------------------------------------------
def zffr(batch: int = 1, n_rois: int = 128, reduced: bool = False) -> Chain:
    if reduced:
        batch, n_rois, hw = 1, 4, 35
    else:
        hw = 224
    c = Chain("ZFFR" + ("-reduced" if reduced else ""))
    x = c.add_input("x", (batch, 3, hw, hw))
    if reduced:
        x = L.conv2d(c, x, out_c=8, k=7, stride=2, pad=1, name="conv1")
        feat_c = 8
    else:
        x = L.conv2d(c, x, out_c=96, k=7, stride=2, pad=1, name="conv1")
        x = L.relu(c, x)
        x = L.lrn(c, x)
        x = L.maxpool2d(c, x, k=3, stride=2, pad=1, ceil_mode=True)
        x = L.conv2d(c, x, out_c=256, k=5, stride=2, pad=1, name="conv2")
        x = L.relu(c, x)
        x = L.lrn(c, x)
        x = L.maxpool2d(c, x, k=3, stride=2, pad=1, ceil_mode=True)
        x = L.conv2d(c, x, out_c=384, k=3, pad=1, name="conv3")
        x = L.relu(c, x)
        x = L.conv2d(c, x, out_c=384, k=3, pad=1, name="conv4")
        x = L.relu(c, x)
        x = L.conv2d(c, x, out_c=256, k=3, pad=1, name="conv5")
        feat_c = 256
    x = L.relu(c, x)
    _, _, fh, fw = c.shape_of(x)
    # RPN head
    r = L.conv2d(c, x, out_c=feat_c, k=3, pad=1, name="rpn.conv")
    r = L.relu(c, r)
    cls = L.conv2d(c, r, out_c=18, k=1, name="rpn.cls")
    cls = L.view(c, cls, (batch, 2, 9 * fh, fw), name="rpn.cls_view")
    cls = L.softmax(c, cls, axis=1, name="rpn.cls_prob")
    bbox = L.conv2d(c, r, out_c=36, k=1, name="rpn.bbox")
    # proposal layer: anchor scoring + NMS — pure data movement/sort on the
    # scored anchors (non-traditional; offloaded by CIP baselines)
    prop = c.add(Movement(name="proposal", input=cls,
                          out_shape=(n_rois, 4), gather=True),
                 layer="proposal", traditional=False)
    # RoI pooling: gather (movement) + per-RoI max-pool to 6x6
    roi_sz = 6
    gather = c.add(Movement(name="roi.gather", input=x, perm=None,
                            out_shape=(n_rois, feat_c,
                                       2 * roi_sz, 2 * roi_sz),
                            gather=True),
                   layer="roi_pool", traditional=False)
    # NB: gather re-tiles (fh,fw) -> per-roi 12x12 regions; element count
    # changes are movement-level detail, modeled by the out_shape above.
    pooled = c.add(
        GConv(name="roi.pool",
              dims=(DimSpec("B", ng=n_rois), DimSpec("C", ng=feat_c),
                    DimSpec("H", nopc=roi_sz, nks=2, stride=2),
                    DimSpec("W", nopc=roi_sz, nks=2, stride=2)),
              input=gather, main="none", reduce="max"),
        layer="roi_pool", traditional=False)
    x = L.view(c, pooled, (n_rois, feat_c * roi_sz * roi_sz))
    fcw = 128 if reduced else 4096
    x = L.fc(c, x, out_f=fcw, name="fc6")
    x = L.relu(c, x)
    x = L.dropout(c, x)
    x = L.fc(c, x, out_f=fcw, name="fc7")
    x = L.relu(c, x)
    cls_s = L.fc(c, x, out_f=21, name="cls_score")
    cls_p = L.softmax(c, cls_s, name="cls_prob")
    bbox_p = L.fc(c, x, out_f=84, name="bbox_pred")
    c.mark_output(cls_p)
    c.mark_output(bbox_p)
    return c


# ---------------------------------------------------------------------------
# C3D
# ---------------------------------------------------------------------------
def c3d(batch: int = 8, reduced: bool = False) -> Chain:
    c = Chain("C3D" + ("-reduced" if reduced else ""))
    if reduced:
        x = c.add_input("x", (batch, 3, 4, 12, 12))
        x = L.conv3d(c, x, out_c=8, k=3, kt=3, pad=1, pad_t=1, name="conv1a")
        x = L.relu(c, x)
        x = L.maxpool3d(c, x, k=2, stride=2, kt=1, stride_t=1)
        x = L.view(c, x, (batch, 8 * 4 * 6 * 6))
        x = L.fc(c, x, out_f=32, name="fc6")
        x = L.relu(c, x)
        x = L.fc(c, x, out_f=10, name="fc8")
        x = L.softmax(c, x)
        c.mark_output(x)
        return c
    x = c.add_input("x", (batch, 3, 16, 112, 112))
    x = L.conv3d(c, x, out_c=64, k=3, kt=3, pad=1, pad_t=1, name="conv1a")
    x = L.relu(c, x)
    x = L.maxpool3d(c, x, k=2, stride=2, kt=1, stride_t=1, name="pool1")
    x = L.conv3d(c, x, out_c=128, k=3, kt=3, pad=1, pad_t=1, name="conv2a")
    x = L.relu(c, x)
    x = L.maxpool3d(c, x, k=2, stride=2, kt=2, stride_t=2, name="pool2")
    for i, ch in ((3, 256), (4, 512), (5, 512)):
        x = L.conv3d(c, x, out_c=ch, k=3, kt=3, pad=1, pad_t=1,
                     name=f"conv{i}a")
        x = L.relu(c, x)
        x = L.conv3d(c, x, out_c=ch, k=3, kt=3, pad=1, pad_t=1,
                     name=f"conv{i}b")
        x = L.relu(c, x)
        x = L.maxpool3d(c, x, k=2, stride=2, kt=2, stride_t=2,
                        name=f"pool{i}")
    x = L.view(c, x, (batch, 512 * 1 * 3 * 3))
    x = L.fc(c, x, out_f=4096, name="fc6")
    x = L.relu(c, x)
    x = L.dropout(c, x)
    x = L.fc(c, x, out_f=4096, name="fc7")
    x = L.relu(c, x)
    x = L.dropout(c, x)
    x = L.fc(c, x, out_f=487, name="fc8")
    x = L.softmax(c, x)
    c.mark_output(x)
    return c


# ---------------------------------------------------------------------------
# CapsNet (dynamic routing, 3 iterations unrolled)
# ---------------------------------------------------------------------------
def _squash(c: Chain, x: str, name: str) -> str:
    """v = (||s||^2 / (1+||s||^2)) * s / ||s|| over the capsule D axis.
    x: (B, NCaps, D). GCONVs: squared-norm reduce, two coefficient nodes,
    two elementwise multiplies (same recipe as Table 2's LUT-class posts)."""
    B, N, D = c.shape_of(x)
    nrm = c.add(GConv(name=f"{name}.n2",
                      dims=(DimSpec("B", ng=B), DimSpec("N", ng=N),
                            DimSpec("D", nks=D)),
                      input=x, pre=(Op("square"),), main="none",
                      reduce="add"),
                layer="capsule", traditional=False)       # ||s||^2
    coef = c.add(GConv(name=f"{name}.coef",
                       dims=(DimSpec("B", ng=B), DimSpec("N", ng=N),
                             DimSpec("D", ng=1)),
                       input=nrm, main="none", reduce="none",
                       post=(Op("add_const", const=1.0), Op("recip"),
                             Op("mul", operand=nrm))),
                 layer="capsule", traditional=False)      # n2/(1+n2)
    rs = c.add(GConv(name=f"{name}.rs",
                     dims=(DimSpec("B", ng=B), DimSpec("N", ng=N),
                           DimSpec("D", ng=1)),
                     input=nrm, main="none", reduce="none",
                     post=(Op("rsqrt_eps", const=1e-7),)),
               layer="capsule", traditional=False)        # 1/||s||
    scaled = c.add(GConv(name=f"{name}.v",
                         dims=(DimSpec("B", ng=B), DimSpec("N", ng=N),
                               DimSpec("D", ng=D)),
                         input=x, kernel=coef, main="mul", reduce="none"),
                   layer="capsule", traditional=False)
    v = c.add(GConv(name=f"{name}.out",
                    dims=(DimSpec("B", ng=B), DimSpec("N", ng=N),
                          DimSpec("D", ng=D)),
                    input=scaled, kernel=rs, main="mul", reduce="none"),
              layer="capsule", traditional=False)
    return v


def capsnet(batch: int = 32, reduced: bool = False,
            routing_iters: int = 3) -> Chain:
    c = Chain("CapNN" + ("-reduced" if reduced else ""))
    if reduced:
        x = c.add_input("x", (batch, 1, 12, 12))
        x = L.conv2d(c, x, out_c=16, k=5, name="conv1")
        x = L.relu(c, x)
        x = L.conv2d(c, x, out_c=16, k=5, stride=2, name="prim.conv")
        n_caps, caps_d, n_out, out_d = 2 * 2 * 2, 8, 4, 8
        x = L.view(c, x, (batch, n_caps, caps_d), name="prim.view")
    else:
        x = c.add_input("x", (batch, 1, 28, 28))
        x = L.conv2d(c, x, out_c=256, k=9, name="conv1")
        x = L.relu(c, x)
        x = L.conv2d(c, x, out_c=256, k=9, stride=2, name="prim.conv")
        n_caps, caps_d, n_out, out_d = 32 * 6 * 6, 8, 10, 16
        x = L.view(c, x, (batch, n_caps, caps_d), name="prim.view")
    for n in list(c.nodes)[-2:]:
        c.meta.setdefault(n, {}).update(layer="primary_caps",
                                        traditional=False)
    u = _squash(c, x, "prim.squash")
    # u_hat[b, i, j, d_out] = sum_d W[i, j, d_out, d] u[b, i, d]
    B = batch
    uv = L.view(c, u, (B, n_caps, 1, 1, caps_d), name="uhat.view")
    w = c.add_param("digit.W", (1, n_caps, n_out, out_d, caps_d))
    uhat = c.add(GConv(name="uhat",
                       dims=(DimSpec("B", ng=B), DimSpec("I", ng=n_caps),
                             DimSpec("J", nop=n_out), DimSpec("Do", nop=out_d),
                             DimSpec("D", nks=caps_d)),
                       input=uv, kernel=w, main="mul", reduce="add"),
                 layer="digit_caps", traditional=False)   # (B,I,J,Do,1)
    uhat = L.view(c, uhat, (B, n_caps, n_out, out_d), name="uhat.sq")
    # routing logits start at zero; they are a (zero-filled) chain input —
    # RNG/initialization happens outside the accelerator, like dropout masks.
    blogit = c.add_input("route.b0", (B, n_caps, n_out))
    v = None
    for it in range(routing_iters):
        cprob = L.softmax(c, blogit, axis=2, name=f"route{it}.softmax")
        # s[b,j,do] = sum_i c[b,i,j] * uhat[b,i,j,do]
        cview = L.view(c, cprob, (B, n_caps, n_out, 1),
                       name=f"route{it}.cview")
        s = c.add(GConv(name=f"route{it}.s",
                        dims=(DimSpec("B", ng=B), DimSpec("I", nks=n_caps),
                              DimSpec("J", ng=n_out), DimSpec("Do", ng=out_d)),
                        input=uhat, kernel=cview, main="mul", reduce="add"),
                  layer="digit_caps", traditional=False)   # (B,1,J,Do)
        s = L.view(c, s, (B, n_out, out_d), name=f"route{it}.sview")
        v = _squash(c, s, f"route{it}.squash")
        if it < routing_iters - 1:
            # agreement: b[b,i,j] += sum_do uhat[b,i,j,do] * v[b,j,do]
            vv = L.view(c, v, (B, 1, n_out, out_d), name=f"route{it}.vview")
            agree = c.add(GConv(
                name=f"route{it}.agree",
                dims=(DimSpec("B", ng=B), DimSpec("I", ng=n_caps),
                      DimSpec("J", ng=n_out), DimSpec("Do", nks=out_d)),
                input=uhat, kernel=vv, main="mul", reduce="add"),
                layer="digit_caps", traditional=False)     # (B,I,J,1)
            agree = L.view(c, agree, (B, n_caps, n_out),
                           name=f"route{it}.aview")
            blogit = L.add_tensors(c, blogit, agree, name=f"route{it}.b",
                                   layer="digit_caps")
    c.mark_output(v)
    return c


def zero_inputs(chain: Chain):
    """Zero-filled arrays for every chain input (dropout masks, routing
    logits, images) — convenient for smoke/stat runs."""
    import numpy as np
    return {name: np.zeros(info.shape, dtype="float32")
            for name, info in chain.inputs.items()}


def random_inputs(chain: Chain, seed: int = 1):
    """:func:`zero_inputs` with a non-degenerate first input (the image),
    drawn from ``numpy.random.default_rng(seed)``: the shared recipe of the
    execution tests and ``chip_smoke.py``. Numpy arrays, so one draw can be
    fed to both packages."""
    import numpy as np
    inputs = zero_inputs(chain)
    first = next(iter(chain.inputs))
    rng = np.random.default_rng(seed)
    inputs[first] = rng.standard_normal(
        chain.inputs[first].shape).astype(np.float32)
    return inputs


# ---------------------------------------------------------------------------
# training microbenchmark: conv -> BN -> ReLU forward + full backward
# ---------------------------------------------------------------------------
def training_block_chain(batch: int = 8, ch: int = 16, hw: int = 14) -> Chain:
    """FP+BP chain for a conv/BN/ReLU block — the paper's Table-2 scenario."""
    c = Chain("train_block")
    x = c.add_input("x", (batch, ch, hw, hw))
    g = c.add_input("gO", (batch, ch, hw, hw))
    y = L.conv2d(c, x, out_c=ch, k=3, pad=1, bias=False, name="conv")
    bn, fp = L.batch_norm_fp(c, y, name="bn")
    r = L.relu(c, bn, name="relu")
    # ---- backward ----
    # relu BP: gate the gradient by (bn > 0): mask = relu'(bn)
    mask = c.add(GConv(name="relu_bp.mask",
                       dims=tuple(DimSpec(n, ng=s) for n, s in
                                  zip("BCHW", (batch, ch, hw, hw))),
                       input=bn, main="none", reduce="none",
                       post=(Op("gtz"),)),
                 layer="relu_bp", traditional=False)
    g1 = c.add(GConv(name="relu_bp",
                     dims=tuple(DimSpec(n, ng=s) for n, s in
                                zip("BCHW", (batch, ch, hw, hw))),
                     input=g, kernel=mask, main="mul", reduce="none"),
               layer="relu_bp", traditional=False)
    gbn, _ = L.batch_norm_bp(c, g1, fp, name="bn_bp")
    # conv BP (stride 1): gI = gO conv W^T(rot180). Weight view via Movement.
    # W viewed (ic, oc, kh', kw') with spatially flipped taps (rot180)
    wt = c.add(Movement(name="conv_bp.wt", input="conv.w",
                        pre_shape=(ch, ch, 3, 3), perm=(1, 0, 2, 3),
                        flip=(2, 3), out_shape=(1, ch * ch, 3, 3)),
               layer="conv_bp", traditional=True)
    gi = c.add(GConv(name="conv_bp.gi",
                     dims=(DimSpec("B", nopc=batch),
                           DimSpec("C", nop=ch, nks=ch),
                           DimSpec("H", nopc=hw, nks=3, pad=1),
                           DimSpec("W", nopc=hw, nks=3, pad=1)),
                     input=gbn, kernel=wt, main="mul", reduce="add"),
               layer="conv_bp", traditional=True)
    # gW[ic,oc,kh,kw] = sum_b sum_hw x[b,ic,h+kh-1,w+kw-1] gbn[b,oc,h,w]:
    # a GCONV whose kernel is the upstream gradient (taps cover H/W/batch)
    gx = L.view(c, gbn, (batch, 1, ch, hw, hw), name="conv_bp.gview")
    xv = L.view(c, x, (batch, ch, 1, hw, hw), name="conv_bp.xview")
    gw = c.add(GConv(name="conv_bp.gw",
                     dims=(DimSpec("B", nks=batch),
                           DimSpec("Ci", ng=ch),
                           DimSpec("Co", nop=ch),
                           DimSpec("H", nopc=3, nks=hw, pad=1),
                           DimSpec("W", nopc=3, nks=hw, pad=1)),
                     input=xv, kernel=gx, main="mul", reduce="add"),
               layer="conv_bp", traditional=True)   # (1, ch_i, ch_o, 3, 3)
    c.mark_output(r)
    c.mark_output(gi)
    return c


ZOO = {
    "AN": alexnet, "GLN": googlenet, "DN": densenet121, "MN": mobilenet,
    "ZFFR": zffr, "C3D": c3d, "CapNN": capsnet,
}


def build(name: str, reduced: bool = False, **kw) -> Chain:
    return ZOO[name](reduced=reduced, **kw)
