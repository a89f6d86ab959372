"""Fused matcher (K3): the plain version behind ``repro_torch.kernels.
ops.match_rectify_fused`` against the JAX package's
``ops.match_rectify_fused(impl="ref")`` on identical inputs.  Every
output (dist, idx, rxy, sad) is bit-equal: Hamming and SAD are integer
arithmetic, the argmins take the first occurrence on both sides, and
centers round half to even."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

from parity import matcher_case as _case

@pytest.mark.parametrize("case", [
    dict(seed=0), dict(seed=1, ties=True), dict(seed=2, half_centers=True),
    dict(seed=3, k=5, m=130),
], ids=["random", "ties", "half_centers", "more_right_than_a_tile"])
@pytest.mark.parametrize("max_hamming", [64, 200])
def test_matcher_matches_jax(case, max_hamming):
    dl, ml, dr, mr, il, ir = _case(**case)
    kw = dict(row_band=2.0, max_disparity=24.0, max_hamming=max_hamming,
              sad_window=11, sad_range=5)
    want = jops.match_rectify_fused(jnp.asarray(dl), jnp.asarray(ml),
                                    jnp.asarray(dr), jnp.asarray(mr),
                                    jnp.asarray(il), jnp.asarray(ir),
                                    impl="ref", **kw)
    got = ops.match_rectify_fused(
        torch.from_numpy(dl.view(np.int32)), torch.from_numpy(ml),
        torch.from_numpy(dr.view(np.int32)), torch.from_numpy(mr),
        torch.from_numpy(il), torch.from_numpy(ir), **kw)
    for name, a, b in zip(("dist", "idx", "rxy", "sad"), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert (got[1].numpy() >= 0).sum() > 5       # real candidates exist
