"""opensplat_tpu_torch segment sum against the JAX package's
pallas_segment_sum (interpret mode) on the CPU.

The JAX kernel takes its gradient records as bf16 pairs, so the values
are rounded to bf16 in numpy first and both sides sum the same numbers;
what remains is summation order, hence rtol 1e-5 (atol 1e-5 for sums
that cancel). The port's rows are in Gaussian order, as the backward
writes them (each record at its candidate row): Gaussian g's segment
holds its kept records and, at random places among them, the zero rows
of its culled candidates."""
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


def _case(cnt, n_culled, seed):
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
    # port side: each segment its kept rows plus its culled candidates'
    # zero rows, in a random order within the segment
    culled = np.bincount(rng.integers(0, c, n_culled), minlength=c)
    cand_count = (cnt + culled).astype(np.int32)
    cand_start = np.cumsum(cand_count) - cand_count
    rows = np.zeros((int(cand_count.sum()), 9), np.float32)
    kept_at = np.concatenate(
        [cand_start[g] + np.sort(rng.permutation(cand_count[g])[:cnt[g]])
         for g in range(c)]).astype(np.int64)
    rows[kept_at] = vals
    got = tseg.segment_sum(torch.from_numpy(rows),
                           torch.from_numpy(cand_start.astype(np.int64)),
                           torch.from_numpy(cand_count))
    assert tseg.segment_sum.launches == 0  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,max_cnt,n_culled,seed", [
    (700, 12, 300, 0),   # capacity not a multiple of the JAX block
    (384, 2, 0, 2),      # short stream, mostly empty segments
])
def test_segsum_matches_pallas(c, max_cnt, n_culled, seed):
    cnt = np.random.default_rng(seed).integers(0, max_cnt, (c,))
    _case(cnt, n_culled, seed)


def test_segsum_hot_gaussian():
    """One Gaussian whose segment spans thousands of records."""
    cnt = np.zeros((600,), np.int64)
    cnt[117] = 6000
    cnt[118] = 1
    cnt[599] = 500
    _case(cnt, 64, 3)
