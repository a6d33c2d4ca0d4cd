"""Card-only tests of the port (marked ``cuda``; each skips without a CUDA
device): the hand-written kernels against their plain versions on the
card, their wrappers' refusals, and a reduced GoogLeNet through
``compile_chain`` on the kernels against the oracle. This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.convert import inputs_from_numpy, resolve_device
from repro_torch.core.interpreter import ChainExecutor
from repro_torch.exec import compile_chain
from repro_torch.kernels.gconv_matmul import (EPILOGUES, OPCODES,
                                              OPERAND_OPS, gconv_matmul,
                                              gconv_matmul_plain)
from repro_torch.kernels.gconv_spatial import (gconv_spatial,
                                               gconv_spatial_plain)
from repro_torch.models import cnn

TOL = dict(rtol=1e-4, atol=1e-4)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


@pytest.mark.parametrize("g,m,k,n", [(1, 1, 1, 1), (3, 130, 257, 129),
                                     (1, 25088, 256, 128)])
def test_gconv_matmul_kernel_matches_plain(cuda, g, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(g, m, k, generator=gen, device=cuda) * 0.1
    w = torch.randn(g, k, n, generator=gen, device=cuda)
    ops = (torch.randn(1, 1, k, generator=gen, device=cuda),
           torch.randn(g, m, 1, generator=gen, device=cuda),
           torch.randn(g, 1, n, generator=gen, device=cuda))
    kw = dict(prologue=(("mul", None, 0), ("add", None, 1),
                        ("exp", None, None)),
              epilogue=(("add", None, 2), ("relu", None, None)),
              operands=ops, scale=0.25, post="tanh")
    before = gconv_matmul.launches
    got = gconv_matmul(x, w, **kw)
    assert gconv_matmul.launches == before + 1
    torch.testing.assert_close(got, gconv_matmul_plain(x, w, **kw), **TOL)


CONST = {"scale": 0.3, "add_const": 0.3, "pow": 1.5, "leaky_relu": 0.2,
         "clip_max": 0.3}
POSITIVE_DOMAIN = ("sqrt", "log", "recip", "pow", "rsqrt_eps")


def fused_case(op, stage, g, m, length, gen, dev):
    """A ``stage`` sequence that applies ``op`` once per operand kind
    (scalar, per-row, per-column) if it takes an operand, else once after
    ``abs`` and ``add_const`` where its domain is the positive reals."""
    if op in OPERAND_OPS:
        ops = tuple(torch.randn(s, generator=gen, device=dev)
                    for s in ((g, 1, 1), (1, m, 1), (g, 1, length)))
        if op == "div":
            ops = tuple(o.abs() + 0.5 for o in ops)
        return tuple((op, None, i) for i in range(3)), ops
    seq = ((op, CONST.get(op), None),)
    if op in POSITIVE_DOMAIN:
        seq = (("abs", None, None), ("add_const", 0.5, None)) + seq
    return seq, ()


@pytest.mark.parametrize("stage", ["prologue", "epilogue"])
@pytest.mark.parametrize("op", OPCODES)
def test_gconv_matmul_kernel_matches_plain_for_every_opcode(cuda, op, stage):
    """Every entry of the kernel's opcode switch, in the prologue and in
    the epilogue, with an operand of each legal kind where it takes one."""
    g, m, k, n = 2, 70, 37, 45
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(g, m, k, generator=gen, device=cuda) * 0.5
    w = torch.randn(g, k, n, generator=gen, device=cuda) * 0.3
    seq, ops = fused_case(op, stage, g, m, k if stage == "prologue" else n,
                          gen, cuda)
    kw = {stage: seq, "operands": ops}
    got = gconv_matmul(x, w, **kw)
    torch.testing.assert_close(got, gconv_matmul_plain(x, w, **kw), **TOL)


@pytest.mark.parametrize("post", EPILOGUES)
def test_gconv_matmul_kernel_matches_plain_for_every_post(cuda, post):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(1, 33, 20, generator=gen, device=cuda) * 0.5
    w = torch.randn(1, 20, 17, generator=gen, device=cuda) * 0.3
    got = gconv_matmul(x, w, post=post, scale=0.5)
    torch.testing.assert_close(
        got, gconv_matmul_plain(x, w, post=post, scale=0.5), **TOL)


def test_gconv_matmul_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 8, 16, device=cuda)
    w = torch.zeros(1, 16, 4, device=cuda)
    with pytest.raises(TypeError):
        gconv_matmul(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        gconv_matmul(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        gconv_matmul(x, w.cpu())


@pytest.mark.parametrize("b,h,w,c,o,k,stride,pad", [
    (1, 1, 1, 1, 1, 1, 1, 0), (2, 11, 9, 6, 130, 5, 2, 2),
    (3, 17, 17, 19, 70, 3, 1, 1), (1, 23, 23, 3, 8, 11, 4, 0),
    (32, 56, 56, 64, 192, 3, 1, 1),
])
def test_gconv_spatial_kernel_matches_plain(cuda, b, h, w, c, o, k, stride,
                                            pad):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, h, w, c, generator=gen, device=cuda)
    wt = torch.randn(k, k, c, o, generator=gen, device=cuda)
    before = gconv_spatial.launches
    got = gconv_spatial(x, wt, stride=stride, pad=pad)
    assert gconv_spatial.launches == before + 1
    torch.testing.assert_close(
        got, gconv_spatial_plain(x, wt, stride=stride, pad=pad), **TOL)


def test_gconv_spatial_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 6, 6, 3, device=cuda)
    w = torch.zeros(3, 3, 3, 4, device=cuda)
    with pytest.raises(TypeError):
        gconv_spatial(x.half(), w.half())
    with pytest.raises(ValueError, match="contiguous"):
        gconv_spatial(x.permute(0, 2, 1, 3), w)
    with pytest.raises(ValueError):
        gconv_spatial(x, w.cpu())


@pytest.mark.parametrize("name", ["GLN", "DN"])
def test_reduced_chain_on_the_kernels_matches_the_oracle(cuda, name):
    chain = cnn.build(name, reduced=True, batch=2)
    params = ChainExecutor(chain).init_params(torch.Generator().manual_seed(0))
    inputs = inputs_from_numpy(cnn.random_inputs(chain, 1), "cpu")
    eng = compile_chain(chain, backend="cuda")
    assert eng.device.type == "cuda"
    # the oracle runs the fused chain, whose nodes carry the fused members
    want = ChainExecutor(eng.chain)(inputs, params, keep_all=True)
    before = (gconv_matmul.launches, gconv_spatial.launches)
    got = eng(inputs, params, keep_all=True)
    tags = list(eng.dispatch.values())
    assert (gconv_matmul.launches - before[0], gconv_spatial.launches
            - before[1]) == (tags.count("matmul:cuda"),
                             tags.count("conv:cuda"))
    for node in eng.chain.nodes:
        if node in got:
            torch.testing.assert_close(got[node].cpu(), want[node], **TOL,
                                       msg=lambda m, n=node: f"{n}: {m}")
