"""Every UNARY, MAIN and REDUCE entry of the port's core.operators against
the JAX package's on the same numpy arrays, plus the port's oracle
interpreter against the JAX package's (rtol=atol=1e-4 throughout, the
reference's own tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import interpreter as r_interp
from repro.core import operators as r_ops
from repro.models import cnn as rcnn
from repro_torch.convert import inputs_from_numpy, params_from_numpy
from repro_torch.core import interpreter as t_interp
from repro_torch.core import operators as t_ops
from repro_torch.core.gconv import DimSpec, GConv, Op
from repro_torch.models import cnn as tcnn

TOL = dict(rtol=1e-4, atol=1e-4)
rng = np.random.default_rng(0)
X = rng.standard_normal((3, 5, 7)).astype(np.float32)
POS = (rng.random((3, 5, 7)) * 2 + 0.1).astype(np.float32)
P = rng.standard_normal((1, 5, 1)).astype(np.float32) + 2.5
# inputs for which the op is defined over the reals
POSITIVE_ONLY = {"sqrt", "log", "pow", "rsqrt_eps", "recip"}
CONSTS = {"scale": 0.37, "add_const": -1.25, "pow": -0.75, "leaky_relu": 0.1,
          "clip_max": 0.3, "rsqrt_eps": 1e-3}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_registries_cover_the_same_names():
    assert set(t_ops.UNARY) == set(r_ops.UNARY)
    assert set(t_ops.MAIN) == set(r_ops.MAIN)
    assert set(t_ops.REDUCE) == set(r_ops.REDUCE)


@pytest.mark.parametrize("name", sorted(r_ops.UNARY))
def test_unary_matches_reference(name):
    x = POS if name in POSITIVE_ONLY else X
    c = CONSTS.get(name)
    p = P if name in ("mul", "add", "sub", "rsub", "div", "maximum") else None
    want = np.asarray(r_ops.UNARY[name](jnp.asarray(x), c,
                                        None if p is None else jnp.asarray(p)))
    got = t_ops.UNARY[name](_t(x), c, None if p is None else _t(p))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)


def test_unary_defaults_and_traps():
    x = _t(X)
    # rsqrt_eps without a const uses eps 1e-5, as the reference does
    np.testing.assert_allclose(
        t_ops.UNARY["rsqrt_eps"](_t(POS), None, None).numpy(),
        np.asarray(r_ops.UNARY["rsqrt_eps"](jnp.asarray(POS), None, None)),
        **TOL)
    # gelu is the tanh approximation (jax.nn.gelu's default)
    exact = torch.nn.functional.gelu(x * 3)
    tanh = t_ops.UNARY["gelu"](x * 3, None, None)
    assert (exact - tanh).abs().max() > 1e-5
    np.testing.assert_allclose(
        tanh.numpy(), np.asarray(jax.nn.gelu(jnp.asarray(X * 3))), **TOL)
    # gtz keeps the input dtype
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        assert t_ops.UNARY["gtz"](x.to(dt), None, None).dtype == dt
    with pytest.raises(ValueError, match="operand"):
        t_ops.UNARY["mul"](x, None, None)


@pytest.mark.parametrize("name", sorted(r_ops.MAIN))
def test_main_matches_reference(name):
    k = P if name != "div" else np.abs(P) + 0.5
    want = np.asarray(r_ops.apply_main(name, jnp.asarray(X), jnp.asarray(k)))
    got = t_ops.apply_main(name, _t(X), _t(k))
    np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)


@pytest.mark.parametrize("name", sorted(r_ops.REDUCE) + ["none"])
@pytest.mark.parametrize("axes", [(1,), (0, 2), 2])
def test_reduce_matches_reference(name, axes):
    want = np.asarray(r_ops.apply_reduce(name, jnp.asarray(X), axes))
    got = t_ops.apply_reduce(name, _t(X), axes)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert t_ops.pad_value(name) == float(r_ops.pad_value(name))


def test_apply_unary_seq_resolves_operands():
    ops = (Op("mul", operand="p"), Op("add_const", const=0.5), Op("relu"))
    env_t, env_r = {"p": _t(P)}, {"p": jnp.asarray(P)}
    got = t_ops.apply_unary_seq(ops, _t(X), lambda op: env_t[op.operand])
    want = r_ops.apply_unary_seq(ops, jnp.asarray(X),
                                 lambda op: env_r[op.operand])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(KeyError):
        t_ops.apply_unary_seq((Op("nope"),), _t(X))


# ---------------------------------------------------------------------------
# the oracle interpreter, node for node
# ---------------------------------------------------------------------------
def _shared_operands(name, seed=0):
    if name == "train_block":
        r_chain = rcnn.training_block_chain(batch=2, ch=4, hw=6)
        t_chain = tcnn.training_block_chain(batch=2, ch=4, hw=6)
    else:
        r_chain = rcnn.build(name, reduced=True, batch=2)
        t_chain = tcnn.build(name, reduced=True, batch=2)
    params = {k: np.asarray(v) for k, v in r_interp.init_chain_params(
        r_chain, jax.random.PRNGKey(seed)).items()}
    g = np.random.default_rng(seed + 1)
    inputs = {k: g.standard_normal(i.shape).astype(np.float32)
              for k, i in t_chain.inputs.items()}
    return r_chain, t_chain, params, inputs


@pytest.mark.parametrize("name", ["GLN", "train_block"])
def test_oracle_matches_reference_node_for_node(name):
    r_chain, t_chain, params, inputs = _shared_operands(name)
    r_ex = r_interp.ChainExecutor(r_chain)
    want = jax.jit(lambda i, p: r_ex(i, p, keep_all=True))(inputs, params)
    got = t_interp.ChainExecutor(t_chain)(
        inputs_from_numpy(inputs, "cpu"), params_from_numpy(params, "cpu"),
        keep_all=True)
    assert set(got) == set(want)
    for node in t_chain.nodes:
        np.testing.assert_allclose(got[node].numpy(), np.asarray(want[node]),
                                   err_msg=node, **TOL)


def test_eval_gconv_broadcast_kernel_and_crop():
    """A kernel broadcast over the batch axis, a negative right pad (crop)
    and a max reduce with -inf padding, against the reference."""
    g = GConv("n", dims=(DimSpec("B", ng=2), DimSpec("C", nop=3, nks=4),
                         DimSpec("W", nopc=3, nks=3, stride=2, pad=1,
                                 pad_r=-1)),
              input="x", kernel="k", main="max", reduce="max")
    x = rng.standard_normal(g.in_shape).astype(np.float32)
    k = rng.standard_normal((1,) + g.k_shape[1:]).astype(np.float32)
    want = r_interp.eval_gconv(g, jnp.asarray(x), jnp.asarray(k))
    got = t_interp.eval_gconv(g, _t(x), _t(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_chain_params_uses_the_generator():
    chain = tcnn.build("GLN", reduced=True, batch=2)
    a = t_interp.init_chain_params(chain, torch.Generator().manual_seed(3))
    b = t_interp.init_chain_params(chain, torch.Generator().manual_seed(3))
    c = t_interp.init_chain_params(chain, torch.Generator().manual_seed(4))
    assert list(a) == list(chain.params)
    for name, info in chain.params.items():
        assert tuple(a[name].shape) == info.shape
        assert torch.equal(a[name], b[name])
    assert not torch.equal(a["conv1.w"], c["conv1.w"])
    assert 0.05 < float(a["3a.1x1.w"].std()) < 0.2      # scale 0.1


def test_apply_movement_gather_stand_in():
    from repro.core.chain import Movement as RMovement
    from repro_torch.core.chain import Movement
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    for kw in (dict(out_shape=(5, 7), gather=True),
               dict(perm=(2, 0, 1), out_shape=(4, 6)),
               dict(pre_shape=(6, 4), perm=(1, 0), flip=(0,),
                    out_shape=(4, 6))):
        got = t_interp.apply_movement(Movement("m", "x", **kw), _t(x))
        want = r_interp.apply_movement(RMovement("m", "x", **kw),
                                       jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
