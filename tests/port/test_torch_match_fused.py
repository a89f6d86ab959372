"""Match-only (K4) and SAD-only (K5) matchers: the plain versions behind
``repro_torch.kernels.ops`` against the JAX package's
``ops.match_rectify_fused`` in match-only mode and
``ops.sad_patch_search`` (``impl="ref"``) on identical inputs.

Every output is bit-equal: Hamming and SAD are integer arithmetic, the
argmin takes the first occurrence on both sides, centers round half to
even and clamp, and the temporal window's shifted x is the same float32
sum on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.localization import pose

from parity import matcher_case as _case

CASES = [dict(seed=0), dict(seed=1, ties=True),
         dict(seed=3, k=5, m=130), dict(seed=4, k=64, m=64, p=3)]
IDS = ["random", "ties", "more_right_than_a_tile", "three_rows"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("window", [(2.0, 24.0, 0.0), (6.0, 12.0, 6.0),
                                    (6.3, 12.6, 6.3)],
                         ids=["stereo", "temporal", "temporal_inexact"])
def test_match_only_matches_jax(case, window):
    """(row_band, max_disparity, shift): the temporal window adds the
    radius to the left x first (float32 on both sides), then searches
    [0, 2r]."""
    row_band, max_disp, shift = window
    dl, ml, dr, mr, _, _ = _case(**case)
    ml_j = jnp.asarray(ml).at[..., 0].add(shift)
    want = jops.match_rectify_fused(jnp.asarray(dl), ml_j, jnp.asarray(dr),
                                    jnp.asarray(mr), row_band=row_band,
                                    max_disparity=max_disp, impl="ref")
    tml = pose.shift_x(_t(ml), shift)
    np.testing.assert_array_equal(tml.numpy(), np.asarray(ml_j))
    got = ops.match_rectify_fused(_t(dl.view(np.int32)), tml,
                                  _t(dr.view(np.int32)), _t(mr),
                                  row_band=row_band, max_disparity=max_disp)
    assert len(got) == 2
    for name, a, b in zip(("dist", "idx"), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert (got[1].numpy() >= 0).sum() > 3       # real candidates exist
    assert (got[1].numpy() < 0).sum() > 0        # and rows with none


def _centers(kind, ml, mr, h, w):
    if kind == "half":          # on .5: round half to even decides
        return (np.round(ml[..., :2] * 2) / 2,
                np.round(mr[:, :ml.shape[1], :2] * 2) / 2)
    # centers beyond every border: both reads clamp
    rng = np.random.RandomState(9)
    xy = rng.uniform(-20, 20, ml.shape[:2] + (2,)) + np.where(
        rng.rand(*ml.shape[:2], 2) < 0.5, 0.0, [w, h])
    return xy, xy[:, ::-1] + 0.5


@pytest.mark.parametrize("kind", ["half", "border"])
@pytest.mark.parametrize("window,sad_range", [(11, 5), (7, 3)])
def test_sad_only_matches_jax(kind, window, sad_range):
    _, ml, _, mr, il, ir = _case(seed=5)
    h, w = il.shape[1:]
    xy_l, xy_r = (a.astype(np.float32) for a in _centers(kind, ml, mr, h, w))
    want = jops.sad_patch_search(jnp.asarray(il), jnp.asarray(ir),
                                 jnp.asarray(xy_l), jnp.asarray(xy_r),
                                 sad_window=window, sad_range=sad_range,
                                 impl="ref")
    got = ops.sad_patch_search(_t(il), _t(ir), _t(xy_l), _t(xy_r),
                               sad_window=window, sad_range=sad_range)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == xy_l.shape[:2] + (2 * sad_range + 1,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
