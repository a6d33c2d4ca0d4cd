"""The port's gconv_spatial on CPU tensors (its plain version) against the
JAX package's Pallas gconv_spatial in interpret mode, on the same numpy
operands (rtol=atol=1e-4, the reference's tolerance), plus the wrapper's
contract and the CUDA kernel's tiling arithmetic. The CUDA kernel itself is
held against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as r_kops
from repro.kernels.gconv_spatial import gconv_spatial as r_gconv_spatial
from repro_torch.kernels import common
from repro_torch.kernels import ops as t_kops
from repro_torch.kernels.gconv_spatial import (SMEM_MAX, channel_chunk,
                                               gconv_spatial,
                                               gconv_spatial_plain,
                                               smem_bytes)

TOL = dict(rtol=1e-4, atol=1e-4)


def arrays(seed, *shapes):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pad", [0, 1, 2])
def test_matches_reference(k, stride, pad):
    x, w = arrays(k * 10 + stride * 3 + pad, (2, 11, 9, 6), (k, k, 6, 130))
    got = gconv_spatial(torch.from_numpy(x), torch.from_numpy(w),
                        stride=stride, pad=pad)
    want = r_gconv_spatial(jnp.asarray(x), jnp.asarray(w), stride=stride,
                           pad=pad, interpret=True)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_version_is_the_convolution():
    """Independent of JAX: the tap loop equals F.conv2d on the NCHW view."""
    x, w = arrays(1, (3, 13, 10, 7), (3, 5, 7, 9))
    got = gconv_spatial(torch.from_numpy(x), torch.from_numpy(w), stride=2,
                        pad=1)
    want = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                    padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, **TOL)


def test_rejects_bad_calls():
    x, w = torch.zeros(1, 5, 5, 3), torch.zeros(3, 3, 3, 4)
    with pytest.raises(ValueError, match="C="):
        gconv_spatial(x, torch.zeros(3, 3, 2, 4))
    with pytest.raises(ValueError, match="stride"):
        gconv_spatial(x, w, stride=0)
    with pytest.raises(ValueError, match="empty"):
        gconv_spatial(x, torch.zeros(7, 7, 3, 4))
    with pytest.raises(ValueError, match="want"):
        gconv_spatial(x[0], w)


def test_plain_version_only_for_cpu_tensors():
    before = gconv_spatial.launches
    x, w = (torch.from_numpy(a) for a in arrays(8, (1, 6, 6, 3), (3, 3, 3, 4)))
    torch.testing.assert_close(gconv_spatial(x, w, pad=1),
                               gconv_spatial_plain(x, w, pad=1))
    assert gconv_spatial.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gconv_spatial(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gconv_spatial(x, w.to("meta"))


@pytest.mark.parametrize("c,k,stride", [(3, 7, 2), (16, 5, 1), (64, 3, 1),
                                        (192, 3, 1), (20, 3, 2),
                                        (512, 11, 4), (8, 41, 1)])
def test_channel_chunk_fits_shared_memory(c, k, stride):
    cc = channel_chunk(c, k, k, stride)
    assert 1 <= cc <= 16
    assert smem_bytes(k, k, stride, cc) <= SMEM_MAX
    if smem_bytes(k, k, stride, min(c, 16)) <= SMEM_MAX:
        assert cc == common.pick_block(c, 16, 8)


def test_channel_chunk_rejects_a_window_that_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        channel_chunk(4, 300, 300, 1)


@pytest.mark.parametrize("n,target,align", [(1, 16, 8), (3, 16, 8),
                                            (8, 16, 8), (20, 16, 8),
                                            (200, 64, 8), (129, 256, 128),
                                            (1000, 256, 128)])
def test_pick_block_contract(n, target, align):
    b = common.pick_block(n, target, align)
    assert common.block_contract_ok(n, b, align)
    assert b <= max(target, 1)
    assert not common.block_contract_ok(n, common.round_up(n, align) + align,
                                         align)
    assert common.cdiv(n, b) * b >= n


def test_ops_conv2d_nhwc_matches_reference():
    x, w = arrays(9, (2, 8, 8, 4), (3, 3, 4, 6))
    got = t_kops.conv2d_nhwc(torch.from_numpy(x).to(torch.bfloat16),
                             torch.from_numpy(w), stride=1, pad=1,
                             out_dtype=torch.float32)
    want = r_kops.conv2d_nhwc(jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(w), stride=1, pad=1,
                              out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
