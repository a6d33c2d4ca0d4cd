"""The port's compiled engine against the JAX package's, on the same numpy
parameters and inputs (rtol=atol=1e-4, the reference's tolerance,
tests/test_exec.py): outputs, plans tag for tag, and every surviving node;
the kernel path (``backend="cuda"``, plain versions on CPU tensors)
against the reference's Pallas path in interpret mode; and the full-size
GoogLeNet plan for the card against the reference's plan for the TPU."""
import collections

import jax
import numpy as np
import pytest
import torch

import repro.exec.dispatch as r_dispatch
from repro.core.interpreter import init_chain_params as r_init
from repro.exec import compile_chain as r_compile
from repro.exec.partition import partition_chain as r_partition
from repro.models import cnn as rcnn
from repro_torch.convert import inputs_from_numpy, params_from_numpy
from repro_torch.exec import compile_chain, plan_chain
from repro_torch.exec.partition import partition_chain
from repro_torch.models import cnn as tcnn

TOL = dict(rtol=1e-4, atol=1e-4)
TAG = {"matmul:pallas": "matmul:cuda", "matmul:jnp": "matmul:torch",
       "conv:pallas": "conv:cuda", "conv:lax": "conv:torch"}


def _chains(name):
    if name == "train_block":
        return (rcnn.training_block_chain(batch=2, ch=8, hw=8),
                tcnn.training_block_chain(batch=2, ch=8, hw=8))
    return (rcnn.build(name, reduced=True, batch=2),
            tcnn.build(name, reduced=True, batch=2))


def _operands(r_chain, t_chain, seed=0):
    """One numpy draw for both packages: the reference's parameters, a
    random image and random 0/1 dropout masks (so no mask zeroes a whole
    layer)."""
    params = {k: np.asarray(v)
              for k, v in r_init(r_chain, jax.random.PRNGKey(seed)).items()}
    inputs = tcnn.random_inputs(t_chain, seed + 1)
    g = np.random.default_rng(seed + 2)
    for name, arr in inputs.items():
        if name.endswith(".mask"):
            inputs[name] = (g.random(arr.shape) < 0.7).astype(np.float32)
        elif not arr.any():
            inputs[name] = g.standard_normal(arr.shape).astype(np.float32)
    return params, inputs


def _run(name, r_kw, t_kw, keep_all=False):
    r_chain, t_chain = _chains(name)
    params, inputs = _operands(r_chain, t_chain)
    r_eng = r_compile(r_chain, lint="off", **r_kw)
    want = r_eng(inputs, params, keep_all=keep_all)
    t_eng = compile_chain(t_chain, device="cpu", **t_kw)
    got = t_eng(inputs_from_numpy(inputs, "cpu"),
                params_from_numpy(params, "cpu"), keep_all=keep_all)
    return r_eng, t_eng, want, got


def _assert_close(got, want, names):
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   err_msg=n, **TOL)


def _mapped(dispatch):
    return {n: TAG.get(t, t) for n, t in dispatch.items()}


@pytest.mark.parametrize("name", list(rcnn.ZOO))
def test_zoo_outputs_and_plans_match_reference(name):
    r_eng, t_eng, want, got = _run(name, {}, {})
    assert set(got) == set(want)
    _assert_close(got, want, want)
    assert t_eng.dispatch == _mapped(r_eng.dispatch)
    assert ([(s.name, s.backend) for s in t_eng.steps]
            == [(s.name, TAG.get(s.backend, s.backend))
                for s in r_eng.steps])
    assert not any(t.endswith(":cuda") for t in t_eng.dispatch.values())


@pytest.mark.parametrize("name", ["GLN", "train_block"])
def test_every_surviving_node_matches_reference(name):
    r_eng, t_eng, want, got = _run(name, {}, {}, keep_all=True)
    assert set(got) == set(want)
    _assert_close(got, want, [n for n in got if n in t_eng.chain.nodes])


@pytest.mark.parametrize("name", ["GLN", "DN"])
def test_kernel_path_matches_reference_pallas_path(name):
    """backend='cuda' (the kernels' plain versions on CPU tensors, with the
    fused prologue/epilogue sequences) against backend='pallas' (interpret
    mode), node for node."""
    r_eng, t_eng, want, got = _run(name, dict(backend="pallas"),
                                   dict(backend="cuda"), keep_all=True)
    assert t_eng.dispatch == _mapped(r_eng.dispatch)
    tags = set(t_eng.dispatch.values())
    assert {"matmul:cuda", "conv:cuda"} <= tags
    assert set(got) == set(want)
    _assert_close(got, want, [n for n in got if n in t_eng.chain.nodes])


def test_full_googlenet_plan_for_the_card_equals_the_tpu_plan(monkeypatch):
    """Planning only, batch 32: the reference plans for the TPU when
    use_interpret() is False; nothing executes."""
    monkeypatch.setattr(r_dispatch, "use_interpret", lambda: False)
    r_fused, _, _ = r_partition(rcnn.googlenet(batch=32))
    ref = r_dispatch.plan_chain(r_fused, backend="auto")
    t_fused, _, _ = partition_chain(tcnn.googlenet(batch=32))
    port = plan_chain(t_fused, device_type="cuda")
    assert ([(s.name, s.backend) for s in port.steps]
            == [(s.name, TAG.get(s.backend, s.backend)) for s in ref.steps])
    counts = collections.Counter(s.backend for s in port.steps)
    assert counts == {"matmul:cuda": 17, "matmul:torch": 21,
                      "conv:cuda": 19, "conv:torch": 1, "reduce": 16,
                      "elementwise": 37, "concat": 9, "movement": 1,
                      "segment:softmax": 1}
    # conv1: pad 3 with right pad 2 stays off the spatial kernel
    assert port.dispatch["conv1"] == "conv:torch"
    cpu = plan_chain(t_fused, device_type="cpu")
    assert not any(s.backend.endswith(":cuda") for s in cpu.steps)


def test_conv_torch_takes_asymmetric_padding_and_crops():
    """Ceil-mode geometry (padr > pad) and floor-mode crops (padr < 0) on
    conv:torch, against the reference's padding pairs."""
    from repro.core import layers as RL
    from repro.core.chain import Chain as RChain
    from repro_torch.core import layers as TL
    from repro_torch.core.chain import Chain as TChain

    def build(mod_l, mod_c):
        c = mod_c("asym")
        x = c.add_input("x", (2, 3, 12, 11))
        y = mod_l.conv2d(c, x, out_c=4, k=4, stride=3, pad=2, name="a")
        y = mod_l.conv2d(c, y, out_c=5, k=2, stride=2, name="b")
        c.mark_output(y)
        return c

    r_chain, t_chain = build(RL, RChain), build(TL, TChain)
    assert {d.padr for n in t_chain.nodes.values()
            for d in n.dims[2:]} & {-1, 0, 1}
    params, inputs = _operands(r_chain, t_chain)
    want = r_compile(r_chain, lint="off")(inputs, params, keep_all=True)
    eng = compile_chain(t_chain, device="cpu", backend="cuda")
    assert eng.dispatch == {"a": "conv:torch", "b": "conv:torch"}
    got = eng(inputs_from_numpy(inputs, "cpu"),
              params_from_numpy(params, "cpu"), keep_all=True)
    _assert_close(got, want, ["a", "b"])


def test_engine_introspection_and_input_checks():
    r_chain, t_chain = _chains("GLN")
    params, inputs = _operands(r_chain, t_chain)
    eng = compile_chain(t_chain, device="cpu", backend="cuda")
    assert eng.signature.startswith("GLN-reduced|x:2x3x16x16:float32|")
    assert "3a.3x3=conv:cuda" in eng.signature
    hist = eng.backend_histogram()
    assert sum(hist.values()) == len(t_chain.nodes)
    assert hist["fused"] == sum(1 for t in eng.dispatch.values()
                                if t.startswith("fused:"))
    assert "conv1: conv:torch" in eng.pretty()
    assert eng.init_params(torch.Generator().manual_seed(0)).keys() \
        == t_chain.params.keys()
    with pytest.raises(ValueError, match="missing chain input"):
        eng({}, params)
    with pytest.raises(ValueError, match="missing chain param"):
        eng(inputs, {})
    with pytest.raises(ValueError, match="want"):
        eng({"x": np.zeros((3, 3, 16, 16), np.float32)}, params)
    out = eng(inputs, params)                  # numpy operands are taken
    assert set(out) == {"softmax"} and out["softmax"].shape == (2, 10)
    with pytest.raises(ValueError, match="backend"):
        compile_chain(t_chain, device="cpu", backend="pallas")


def test_unfused_and_unsegmented_compiles_match():
    r_chain, t_chain = _chains("AN")
    params, inputs = _operands(r_chain, t_chain)
    ref = r_compile(r_chain, lint="off", fuse=False, segments=False)(
        inputs, params)
    eng = compile_chain(t_chain, device="cpu", fuse=False, segments=False)
    assert "segment:softmax" not in eng.dispatch.values()
    got = eng(inputs_from_numpy(inputs, "cpu"),
              params_from_numpy(params, "cpu"))
    _assert_close(got, ref, ref)
