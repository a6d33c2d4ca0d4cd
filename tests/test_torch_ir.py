"""The port's copies of the framework-free IR (core.gconv, core.chain,
core.layers, core.fusion, models.cnn, exec.partition) build and fuse
exactly the chains the JAX package builds, on the full-size zoo."""
import dataclasses

import pytest

from repro.core.fusion import execution_partitions as r_partitions
from repro.core.fusion import fuse_chain as r_fuse
from repro.exec.partition import partition_chain as r_partition_chain
from repro.models import cnn as rcnn
from repro_torch.core.fusion import execution_partitions as t_partitions
from repro_torch.core.fusion import fuse_chain as t_fuse
from repro_torch.exec.partition import partition_chain as t_partition_chain
from repro_torch.models import cnn as tcnn

BUILDERS = [(name, dict(reduced=False)) for name in rcnn.ZOO]


def _build(cnn_mod, name, kw):
    if name == "train_block":
        return cnn_mod.training_block_chain()
    return cnn_mod.build(name, **kw)


def canonical(chain):
    """Everything a chain holds, as plain data (class names + fields)."""
    nodes = [(name, type(n).__name__, dataclasses.asdict(n))
             for name, n in chain.nodes.items()]
    return dict(
        name=chain.name,
        inputs={k: (v.shape, v.dtype) for k, v in chain.inputs.items()},
        params={k: (v.shape, v.dtype) for k, v in chain.params.items()},
        nodes=nodes, outputs=list(chain.outputs), meta=chain.meta,
        stats=chain.stats())


IDS = [n for n, _ in BUILDERS] + ["train_block"]
CASES = BUILDERS + [("train_block", {})]


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_chain_copies_build_identical_chains(name, kw):
    ref, port = _build(rcnn, name, kw), _build(tcnn, name, kw)
    assert canonical(port) == canonical(ref)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_fusion_copy_fuses_identically(name, kw):
    ref, r_report = r_fuse(_build(rcnn, name, kw))
    port, t_report = t_fuse(_build(tcnn, name, kw))
    assert canonical(port) == canonical(ref)
    assert dataclasses.asdict(t_report) == dataclasses.asdict(r_report)
    assert ([dataclasses.asdict(g) for g in t_partitions(port, t_report)]
            == [dataclasses.asdict(g) for g in r_partitions(ref, r_report)])


@pytest.mark.parametrize("fuse", [True, False])
def test_partition_copy_matches(fuse):
    r_chain, r_report, r_parts = r_partition_chain(
        rcnn.build("GLN", reduced=True, batch=2), fuse=fuse)
    t_chain, t_report, t_parts = t_partition_chain(
        tcnn.build("GLN", reduced=True, batch=2), fuse=fuse)
    assert canonical(t_chain) == canonical(r_chain)
    assert dataclasses.asdict(t_report) == dataclasses.asdict(r_report)
    assert ([dataclasses.asdict(g) for g in t_parts]
            == [dataclasses.asdict(g) for g in r_parts])


def test_random_inputs_draw_with_numpy():
    chain = tcnn.build("AN", reduced=True, batch=2)
    a, b = tcnn.random_inputs(chain, 3), tcnn.random_inputs(chain, 3)
    assert set(a) == set(chain.inputs)
    for name, info in chain.inputs.items():
        assert a[name].shape == info.shape and a[name].dtype == "float32"
        assert (a[name] == b[name]).all()
    assert a["x"].std() > 0.5                    # the image is random
    assert not a["dropout.mask"].any()           # the rest are zeros
    assert (tcnn.random_inputs(chain, 4)["x"] != a["x"]).any()
