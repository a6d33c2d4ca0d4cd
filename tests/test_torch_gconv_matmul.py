"""The port's gconv_matmul on CPU tensors (its plain version) against the
JAX package's Pallas gconv_matmul in interpret mode, on the same numpy
operands (rtol=atol=1e-4, the reference's tolerance), plus the wrapper's
contract: operand shapes, op names, devices and the launch count. The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as r_ops
from repro.kernels import ops as r_kops
from repro.kernels.gconv_matmul import gconv_matmul as r_gconv_matmul
from repro_torch.kernels import gconv_matmul as gcm
from repro_torch.kernels import ops as t_kops
from repro_torch.kernels.gconv_matmul import (EPILOGUES, OPCODES,
                                              OPERAND_OPS, gconv_matmul,
                                              gconv_matmul_plain)

TOL = dict(rtol=1e-4, atol=1e-4)


def arrays(seed, *shapes):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32) for s in shapes]


def both(x, w, **kw):
    """(port on CPU tensors, reference in interpret mode) on one draw."""
    ops = kw.pop("operands", ())
    got = gconv_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       operands=tuple(torch.from_numpy(o) for o in ops),
                       **kw)
    want = r_gconv_matmul(jnp.asarray(x), jnp.asarray(w),
                          operands=tuple(jnp.asarray(o) for o in ops),
                          interpret=True, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("g,m,k,n", [
    (1, 8, 16, 8), (2, 17, 33, 9), (3, 130, 257, 129), (1, 300, 140, 1),
])
def test_ragged_and_grouped_shapes(g, m, k, n):
    x, w = arrays(g * m + k, (g, m, k), (g, k, n))
    got, want = both(x, w)
    assert got.shape == (g, m, n)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("op,const", [("add_const", 0.75), ("exp", None),
                                      ("rsqrt_eps", None)])
def test_prologue_that_does_not_keep_zero(op, const):
    """K=200 pads to 256 in the Pallas kernel; its re-zeroing of the tail
    after the prologue is what the port's masked K loop must equal."""
    x, w = arrays(1, (2, 24, 200), (2, 200, 40))
    x = np.abs(x) if op == "rsqrt_eps" else x
    got, want = both(x, w, prologue=((op, const, None),))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(2, 24, 1), (1, 24, 1), (2, 1, 40),
                                   (1, 1, 40), (2, 1, 1), (1, 1, 1)])
def test_epilogue_operand_shapes(shape):
    x, w, o = arrays(2, (2, 24, 50), (2, 50, 40), shape)
    got, want = both(x, w, epilogue=(("mul", None, 0), ("add_const", 0.1,
                                                         None)),
                     operands=(o,))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(2, 24, 1), (1, 24, 1), (2, 1, 50),
                                   (1, 1, 50), (2, 1, 1), (1, 1, 1)])
def test_prologue_operand_shapes(shape):
    x, w, o = arrays(3, (2, 24, 50), (2, 50, 40), shape)
    got, want = both(x, w, prologue=(("sub", None, 0), ("relu", None, None)),
                     operands=(o,))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("post", EPILOGUES)
def test_scale_then_post_then_epilogue(post):
    x, w, b = arrays(4, (1, 20, 30), (1, 30, 12), (1, 1, 12))
    got, want = both(x * 0.3, w, scale=0.5, post=post,
                     epilogue=(("add", None, 0), ("tanh", None, None)),
                     operands=(b,))
    np.testing.assert_allclose(got, want, **TOL)


def test_long_fused_sequences_across_the_vocabulary():
    x, w, gam, ms, bias = arrays(5, (2, 17, 33), (2, 33, 9), (1, 1, 33),
                                 (2, 17, 1), (1, 1, 9))
    pro = (("mul", None, 0), ("add", None, 1), ("abs", None, None),
           ("add_const", 0.5, None), ("log", None, None),
           ("leaky_relu", 0.2, None), ("gelu", None, None))
    epi = (("add", None, 2), ("silu", None, None), ("clip_max", 0.8, None),
           ("maximum", None, 2), ("sigmoid", None, None),
           ("pow", 1.5, None), ("rsub", None, 2), ("square", None, None),
           ("neg", None, None), ("gtz", None, None))
    got, want = both(x, w, prologue=pro, epilogue=epi,
                     operands=(gam, ms, bias))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bad", [(2, 24, 40), (3, 24, 1), (2, 5, 1),
                                 (2, 1, 39), (24, 1)])
def test_operand_shapes_outside_the_legal_set_raise(bad):
    x, w, o = arrays(6, (2, 24, 50), (2, 50, 40), bad)
    with pytest.raises(ValueError):
        gconv_matmul(torch.from_numpy(x), torch.from_numpy(w),
                     epilogue=(("add", None, 0),),
                     operands=(torch.from_numpy(o),))
    with pytest.raises(ValueError):          # the reference rejects it too
        r_gconv_matmul(jnp.asarray(x), jnp.asarray(w),
                       epilogue=(("add", None, 0),),
                       operands=(jnp.asarray(o),), interpret=True)


def test_rejects_bad_calls():
    x, w = (torch.zeros(1, 4, 8), torch.zeros(1, 8, 3))
    with pytest.raises(ValueError, match="unfusable"):
        gconv_matmul(x, w, epilogue=(("softplus", None, None),))
    with pytest.raises(ValueError, match="post"):
        gconv_matmul(x, w, post="softplus")
    with pytest.raises(ValueError, match="const"):
        gconv_matmul(x, w, epilogue=(("scale", None, None),))
    with pytest.raises(ValueError, match="disagree"):
        gconv_matmul(x, torch.zeros(1, 7, 3))
    with pytest.raises(ValueError, match="exceeds"):
        gconv_matmul(x, w, epilogue=(("relu", None, None),) * 17)
    with pytest.raises(ValueError, match="slot"):
        gconv_matmul(x, w, epilogue=(("add", None, 0),))


def test_plain_version_only_for_cpu_tensors():
    """Off the CPU the wrapper launches its kernel or raises; it never
    falls back. The plain version does not count as a launch."""
    before = gconv_matmul.launches
    x, w = (torch.from_numpy(a) for a in arrays(8, (1, 4, 8), (1, 8, 3)))
    torch.testing.assert_close(gconv_matmul(x, w),
                               gconv_matmul_plain(x, w))
    assert gconv_matmul.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gconv_matmul(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gconv_matmul(x.to("meta"), w)


@pytest.mark.parametrize("op", sorted(OPERAND_OPS))
@pytest.mark.parametrize("stage", ["prologue", "epilogue"])
def test_tensor_operand_op_without_a_slot_raises(op, stage):
    """The kernel would read 0 for a missing operand; the wrapper refuses
    the sequence as the plain version does."""
    x, w = (torch.zeros(1, 4, 8), torch.zeros(1, 8, 3))
    with pytest.raises(ValueError, match="operand slot"):
        gconv_matmul(x, w, **{stage: ((op, None, None),)})
    with pytest.raises(ValueError):
        r_ops.UNARY[op](jnp.zeros(3), None, None)


def test_opcodes_cover_the_unary_vocabulary():
    assert set(OPCODES) == set(r_ops.UNARY)
    assert len(OPCODES) == len(set(OPCODES))
    assert set(EPILOGUES) <= set(OPCODES)
    assert OPERAND_OPS == {n for n in r_ops.UNARY
                           if n in ("mul", "add", "sub", "rsub", "div",
                                    "maximum")}


def test_kernel_switch_follows_opcodes():
    """``apply_op`` in csrc/gconv_matmul.cu switches on the position in
    OPCODES; each case is labelled with its op's name."""
    src = (Path(gcm.__file__).parent / "csrc" / "gconv_matmul.cu").read_text()
    body = src.split("apply_op(", 1)[1].split("default:", 1)[0]
    cases = re.findall(r"case (\d+):.*?// (\w+)", body)
    assert [(int(i), name) for i, name in cases] == list(enumerate(OPCODES))


def test_ops_grouped_matmul_matches_reference():
    x, w = arrays(7, (3, 16, 24), (3, 24, 8))
    got = t_kops.grouped_matmul(torch.from_numpy(x).to(torch.bfloat16),
                                torch.from_numpy(w), post="relu", scale=0.5,
                                out_dtype=torch.float32)
    want = r_kops.grouped_matmul(jnp.asarray(x).astype(jnp.bfloat16),
                                 jnp.asarray(w), post="relu", scale=0.5,
                                 out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert t_kops.grouped_matmul(torch.from_numpy(x).to(torch.bfloat16),
                                 torch.from_numpy(w)).dtype == torch.bfloat16
