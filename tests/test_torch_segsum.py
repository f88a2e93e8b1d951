"""opensplat_tpu_torch segment sum against the JAX package's
pallas_segment_sum (interpret mode) on the CPU.

The JAX kernel takes its gradient records as bf16 pairs, so the values
are rounded to bf16 in numpy first and both sides sum the same numbers;
what remains is summation order, hence rtol 1e-5 (atol 1e-5 for sums
that cancel). The port's stream is in tile order, not Gaussian order,
and carries sentinel ids (C) for culled rows, as in the rasterizer."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opensplat_tpu.ops.pallas.raster import pack_bf16_pair
from opensplat_tpu.ops.pallas.segsum import pallas_segment_sum
from opensplat_tpu_torch.ops.kernels import segsum as tseg

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _case(cnt, n_sentinel, seed):
    rng = np.random.default_rng(seed)
    c = cnt.shape[0]
    total = int(cnt.sum())
    gid = np.repeat(np.arange(c), cnt).astype(np.int32)
    vals = _bf16(rng.normal(0, 1, (total, 9)).astype(np.float32))
    # JAX side: Gaussian-sorted stream, bf16-pair planes
    planes = (
        pack_bf16_pair(jnp.asarray(vals[:, 0]), jnp.asarray(vals[:, 1])),
        pack_bf16_pair(jnp.asarray(vals[:, 2]), jnp.asarray(vals[:, 3])),
        pack_bf16_pair(jnp.asarray(vals[:, 4]), jnp.asarray(vals[:, 5])),
        pack_bf16_pair(jnp.asarray(vals[:, 6]), jnp.asarray(vals[:, 7])),
        jnp.asarray(vals[:, 8]),
    )
    ends = jnp.asarray(np.cumsum(cnt), jnp.int32)
    ref = np.asarray(pallas_segment_sum(jnp.asarray(gid), planes, ends,
                                        interpret=True))
    # port side: the same records shuffled (tile order) plus sentinels
    order = rng.permutation(total)
    ids = np.concatenate([gid[order], np.full(n_sentinel, c, np.int32)])
    recs = np.concatenate([vals[order],
                           rng.normal(size=(n_sentinel, 9)).astype(np.float32)])
    got = tseg.segment_sum(torch.from_numpy(ids),
                           torch.from_numpy(cnt.astype(np.int32)),
                           torch.from_numpy(recs))
    assert tseg.segment_sum_sorted.launches == 0  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,max_cnt,n_sentinel,seed", [
    (700, 12, 300, 0),   # capacity not a multiple of the JAX block
    (384, 2, 0, 2),      # short stream, mostly empty segments
])
def test_segsum_matches_pallas(c, max_cnt, n_sentinel, seed):
    cnt = np.random.default_rng(seed).integers(0, max_cnt, (c,))
    _case(cnt, n_sentinel, seed)


def test_segsum_hot_gaussian():
    """One Gaussian whose segment spans thousands of records."""
    cnt = np.zeros((600,), np.int64)
    cnt[117] = 6000
    cnt[118] = 1
    cnt[599] = 500
    _case(cnt, 64, 3)
