"""Helpers shared by the port's parity tests (``tests/port``): inputs
made with numpy from a seed, conversions at the numpy boundary, and the
tolerance rules the tests state.

Tolerances, and why:

* integer and bool outputs, blur and score: bit-equal — the same
  arithmetic in the same order (or exact integer arithmetic).
* theta: within 1 ulp on integer-valued frames.  The moments are then
  integers below 2**24, exact in any summation order, and only atan2
  differs (XLA's against torch's).
* moments on float frames: within 2 * gamma_961 * sum|x * p| — the
  worst-case float32 error of two 961-term sums taken in different
  orders (gamma_n = n u / (1 - n u), u = 2**-24).
* steering bins and descriptors: a bin may differ only where theta lies
  within the theta difference of a bin edge (4 ulp on integer frames,
  the moment bound carried through atan2 on float frames); descriptors
  are equal wherever the bins agree.
* the stereo VO backend (``core.backend``) against the JAX package's on
  the same seeded numpy inputs: ``triangulate`` and ``_masked_median``
  bit-equal (the same elementwise float32 operations; a sort).
  ``reprojection_residuals`` within ``RESIDUAL_RTOL`` of the projected
  pixel coordinates' magnitude: the (K, 3) x (3, 3) product rounds
  differently in XLA's and torch's CPU dots (XLA's own eager and jitted
  dots differ by an ulp), and a residual subtracts two coordinates of
  ~1e2 pixels, so its error is an ulp of the coordinate, not of the
  residual.  ``_so3_exp`` within ``SO3_ATOL``.  ``gauss_newton_refine``
  and ``estimate_relative_pose``: R and t within ``VO_POSE_ATOL`` and
  inlier counts equal (float32 forward-mode iterations and median gates
  on products that round as above).  ``integrate_trajectory`` within
  ``TRAJECTORY_ATOL`` (a chain of 3 x 3 products).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

U = 2.0 ** -24
GAMMA_961 = 961 * U / (1 - 961 * U)
INV_ANGLE_STEP = float(np.float32(12 / (2 * np.pi)))
RESIDUAL_RTOL = 1e-6
SO3_ATOL = 1e-6
VO_POSE_ATOL = 1e-4
TRAJECTORY_ATOL = 1e-6


def np_of(x) -> np.ndarray:
    """torch/jax array -> numpy; int32 descriptor bit-views stay int32."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def desc_u32(x) -> np.ndarray:
    a = np_of(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def ulp_diff(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def near_bin_edge(theta, tol) -> np.ndarray:
    """theta within ``tol`` radians of a steering-bin edge."""
    t = np.asarray(theta, np.float64) * INV_ANGLE_STEP
    dist = np.abs(t - (np.floor(t) + 0.5)) / INV_ANGLE_STEP
    return dist <= np.asarray(tol, np.float64)


def bins(theta) -> np.ndarray:
    t = torch.from_numpy(np.asarray(theta, np.float32).copy())
    return np.remainder(torch.round(t * INV_ANGLE_STEP).long().numpy(), 12)


@functools.lru_cache(maxsize=8)
def scene_frames(h: int = 96, w: int = 128, n_points: int = 300,
                 baseline: float = 0.3):
    """(4, h, w) float32 frames of the quad scene (the port's renderer,
    pinned equal to the JAX package's) and the scene intrinsics."""
    from repro_torch.data import scenes
    frame, intr = scenes.render_frame(scenes.SceneConfig(
        height=h, width=w, n_points=n_points, baseline=baseline))
    frame.setflags(write=False)
    return frame, intr


def textured_levels(seed: int, shapes, b: int = 4, integer: bool = False):
    """Random level batches with corner-rich texture: bright and dark
    squares on a noisy gradient, float or rounded."""
    rng = np.random.RandomState(seed)
    out = []
    for h, w in shapes:
        yy, xx = np.mgrid[0:h, 0:w]
        img = (60.0 + 40.0 * xx / w + 20.0 * yy / h)[None].repeat(b, 0)
        img = img + rng.normal(0.0, 2.0, (b, h, w))
        for cam in range(b):
            for _ in range(h * w // 150):
                y, x = rng.randint(2, h - 6), rng.randint(2, w - 6)
                img[cam, y:y + 4, x:x + 4] = rng.uniform(0.0, 255.0)
        img = np.clip(img, 0.0, 255.0).astype(np.float32)
        out.append(np.round(img) if integer else img)
    return out


def feed_jax_pyramid(monkeypatch, jcfg, precision: str = "f32"):
    """Make the port's FE run on the JAX package's pyramid levels:
    ``pyramid.build_pyramid_batched`` returns the JAX package's levels
    of whatever images it is given (``precision`` as both packages take
    it), after holding them to the port's own (level 0 equal, resized
    levels within a grey level, ``test_torch_pyramid``'s A2 rule), so
    that every row of every level is compared with the JAX schedule's.
    Returns the list of the images of each call."""
    import jax
    import jax.numpy as jnp

    from repro.core import pyramid as jpyramid
    from repro_torch.core import pyramid

    own = pyramid.build_pyramid_batched
    build = jax.jit(jpyramid.build_pyramid_batched,
                    static_argnames=("cfg", "precision"))
    calls = []

    def levels(images, cfg, *, precision=precision):
        calls.append(images)
        jlv = build(jnp.asarray(images.numpy()), cfg=jcfg,
                    precision=precision)
        for a, b in zip(jlv, own(images, cfg, precision=precision)):
            assert np.abs(np.asarray(a, np.int32)
                          - b.numpy().astype(np.int32)).max() <= 1
        assert np.array_equal(np.asarray(jlv[0]), images.numpy())
        return [torch.from_numpy(np.array(lv)) for lv in jlv]

    monkeypatch.setattr(pyramid, "build_pyramid_batched", levels)
    return calls


def assert_sparse_parity(theta_a, mom_a, desc_a, theta_b, mom_b, desc_b,
                         patches_abs_sum, integer: bool) -> int:
    """The sparse-FE tolerance rule of the module note, ``a`` the
    reference.  Returns the count of keypoints near a bin edge."""
    theta_a, theta_b = np_of(theta_a), np_of(theta_b)
    mom_a, mom_b = np_of(mom_a), np_of(mom_b)
    dmom = np.abs(mom_a.astype(np.float64) - mom_b)
    spacing = np.spacing(np.abs(theta_a))
    if integer:
        np.testing.assert_array_equal(mom_a, mom_b)
        assert ulp_diff(theta_a, theta_b).max(initial=0) <= 1
        tol = 4.0 * spacing
    else:
        assert np.all(dmom <= 2 * GAMMA_961 * np_of(patches_abs_sum))
        hyp = np.maximum(np.hypot(mom_a[..., 0], mom_a[..., 1]), 1e-30)
        tol = dmom.sum(-1) / hyp * 1.01 + 4.0 * spacing
        assert np.all(np.abs(theta_a.astype(np.float64) - theta_b) <= tol)
    edge = near_bin_edge(theta_a, tol)
    bins_differ = bins(theta_a) != bins(theta_b)
    assert not np.any(bins_differ & ~edge)
    same_bin = ~bins_differ
    np.testing.assert_array_equal(desc_u32(desc_a)[same_bin],
                                  desc_u32(desc_b)[same_bin])
    return int(edge.sum())


def abs_moment_sums(patches: torch.Tensor) -> torch.Tensor:
    """(..., 31, 31) raw patches -> (..., 2) sum|x * p| and sum|y * p|,
    the scale of the float-frame moment bound."""
    from repro_torch.kernels.ref import moment_grids
    xg, yg = moment_grids(patches.device)
    return torch.stack([(patches * xg).abs().sum((-2, -1)),
                        (patches * yg).abs().sum((-2, -1))], -1)


def _level_keys(xy, valid):
    """{(x, y) of a valid row (level-0 float coords): row index}."""
    return {tuple(map(float, xy[i])): i for i in np.flatnonzero(valid)}


def _near(key, diff_yx, scale, radius=20.0) -> bool:
    """Is a level-0 keypoint within ``radius`` level px (Chebyshev) of
    a differing level pixel?"""
    if len(diff_yx) == 0:
        return False
    x, y = key[0] / scale, key[1] / scale
    return bool(np.any(np.maximum(np.abs(diff_yx[:, 0] - y),
                                  np.abs(diff_yx[:, 1] - x)) <= radius))


def assert_stereo_parity(jo, to, k0: int, scale: float, left_cams,
                         right_cams, lvl1_diff, integer: bool, abs_sums,
                         moments):
    """Whole-slice rule for a ``StereoOutput`` (``jo`` the JAX one).

    Level-0 rows (the first ``k0`` of each pair): every field bit-equal,
    theta and descriptors under the sparse-FE rule, and match/depth
    rows exempt only where a descriptor involved lies at a bin edge.
    Level-1 rows: the same where the two level-1 pyramids agree on the
    pair's cameras; otherwise compared as keypoint sets, and every
    difference must lie within 20 px of a differing level-1 pixel (or
    at the top-K cut).  ``lvl1_diff[c]`` is the (n, 2) (y, x) list of
    camera ``c``'s differing level-1 pixels; ``abs_sums``/``moments``
    the per-side (P, K, 2) moment abs-sums and moments of the port's
    patches (for the float-frame theta tolerance).  Returns the number
    of descriptors at a bin edge."""
    n_pairs = np.asarray(jo.matches.valid).shape[0]
    flagged = {}
    n_edge = 0
    for side, cams in (("features_l", left_cams), ("features_r", right_cams)):
        jf, tf = getattr(jo, side), getattr(to, side)
        jth, tth = np.asarray(jf.theta), np_of(tf.theta)
        if integer:
            tol = 4.0 * np.spacing(np.abs(jth))
        else:
            dth = np.abs(jth.astype(np.float64) - tth)
            mom = moments[side]
            hyp = np.maximum(np.hypot(mom[..., 0], mom[..., 1]), 1e-30)
            tol = (2 * GAMMA_961 * abs_sums[side].sum(-1) / hyp * 1.01
                   + 4.0 * np.spacing(np.abs(jth)))
        edge = near_bin_edge(jth, tol)
        bdiff = bins(jth) != bins(tth)
        ddiff = (desc_u32(jf.desc) != desc_u32(tf.desc)).any(-1)
        flagged[side] = edge
        for p in range(n_pairs):
            rows = np.arange(jth.shape[1])
            strict = rows < k0
            if len(lvl1_diff[cams[p]]) == 0:
                strict = np.ones_like(strict)
            sl = strict
            for name in ("xy", "level", "score", "valid"):
                np.testing.assert_array_equal(
                    np_of(getattr(tf, name))[p][sl],
                    np.asarray(getattr(jf, name))[p][sl], err_msg=name)
            if integer:
                assert ulp_diff(jth[p][sl], tth[p][sl]).max(initial=0) <= 1
            else:
                assert np.all(dth[p][sl] <= tol[p][sl])
            assert not np.any((bdiff[p] | ddiff[p]) & sl & ~edge[p])
            n_edge += int((edge[p] & sl).sum())
            if strict.all():
                continue
            # level-1 rows of a camera whose level-1 pixels differ
            jk = _level_keys(np.asarray(jf.xy)[p][k0:],
                             np.asarray(jf.valid)[p][k0:])
            tk = _level_keys(np_of(tf.xy)[p][k0:], np_of(tf.valid)[p][k0:])
            js, ts = np.asarray(jf.score)[p][k0:], np_of(tf.score)[p][k0:]
            cut_j = js[list(jk.values())].min(initial=np.inf)
            cut_t = ts[list(tk.values())].min(initial=np.inf)
            for key in set(jk) ^ set(tk):
                score = js[jk[key]] if key in jk else ts[tk[key]]
                cut = cut_t if key in jk else cut_j
                assert (_near(key, lvl1_diff[cams[p]], scale)
                        or score <= cut), key
            for key in set(jk) & set(tk):
                i, j = k0 + jk[key], k0 + tk[key]
                same = (js[jk[key]] == ts[tk[key]]
                        and (desc_u32(jf.desc)[p, i]
                             == desc_u32(tf.desc)[p, j]).all())
                assert same or _near(key, lvl1_diff[cams[p]], scale) \
                    or edge[p, i], key
    _assert_match_rows(jo, to, k0, scale, left_cams, right_cams, lvl1_diff,
                       flagged)
    return n_edge


def _assert_match_rows(jo, to, k0, scale, left_cams, right_cams, lvl1_diff,
                       flagged):
    n_pairs, k = np.asarray(jo.matches.valid).shape
    jm, tm, jd, td = jo.matches, to.matches, jo.depth, to.depth
    fields = ("disparity", "depth", "xy_right", "valid")
    for p in range(n_pairs):
        jxr, txr = np.asarray(jo.features_r.xy)[p], np_of(to.features_r.xy)[p]
        jxl, txl = np.asarray(jo.features_l.xy)[p], np_of(to.features_l.xy)[p]
        jri = np.asarray(jm.right_index)[p]
        tri = np_of(tm.right_index)[p]
        strict_pair = (len(lvl1_diff[left_cams[p]]) == 0
                       and len(lvl1_diff[right_cams[p]]) == 0)
        t_rows = {tuple(map(float, txl[i])): i for i in range(k0, k)}
        for i in range(k):
            if i >= k0 and not strict_pair:
                j = t_rows.get(tuple(map(float, jxl[i])))
                if j is None or not np.asarray(jo.features_l.valid)[p, i]:
                    continue
            else:
                j = i
            exempt = (flagged["features_l"][p, i]
                      or flagged["features_r"][p, jri[i]]
                      or flagged["features_r"][p, tri[j]])
            if i >= k0 and not strict_pair:
                exempt = exempt or any(
                    _near(tuple(map(float, xy)), lvl1_diff[c], scale)
                    for xy, c in ((jxl[i], left_cams[p]),
                                  (jxr[jri[i]], right_cams[p]),
                                  (txr[tri[j]], right_cams[p])))
            if exempt:
                continue
            assert tuple(jxr[jri[i]]) == tuple(txr[tri[j]]), (p, i)
            assert np.asarray(jm.valid)[p, i] == np_of(tm.valid)[p, j]
            assert np.asarray(jm.distance)[p, i] == np_of(tm.distance)[p, j]
            if i < k0 or strict_pair:
                assert jri[i] == tri[j], (p, i)
            for name in fields:
                np.testing.assert_array_equal(
                    np_of(getattr(td, name))[p, j],
                    np.asarray(getattr(jd, name))[p, i], err_msg=name)


def matcher_case(seed, k=40, m=48, p=2, ties=False, half_centers=False,
                 h=48, w=72):
    """Fused-matcher inputs: right descriptors at random, left ones
    noisy copies of them (so real matches exist), meta rows near their
    sources, float images; ``ties`` duplicates right features,
    ``half_centers`` puts centers on .5 (round half to even)."""
    rng = np.random.RandomState(seed)
    dr = rng.randint(0, 2**32, (p, m, 8), dtype=np.uint64).astype(np.uint32)
    # left descriptors are noisy copies of right ones -> real matches
    src = rng.randint(0, m, (p, k))
    dl = dr[np.arange(p)[:, None], src].copy()
    flips = rng.randint(0, 32, (p, k, 8))
    dl ^= (rng.rand(p, k, 8) < 0.3) * (np.uint32(1) << flips.astype(np.uint32))
    if ties:
        dr[:, m // 2:] = dr[:, :m - m // 2]       # duplicated right features
    mr = np.stack([rng.uniform(-3, w + 3, (p, m)), rng.uniform(0, h, (p, m)),
                   rng.randint(0, 2, (p, m)), rng.rand(p, m) < 0.9], -1)
    ml = np.stack([mr[np.arange(p)[:, None], src, 0] + rng.uniform(0, 20, (p, k)),
                   mr[np.arange(p)[:, None], src, 1] + rng.uniform(-2, 2, (p, k)),
                   mr[np.arange(p)[:, None], src, 2], rng.rand(p, k) < 0.9], -1)
    if ties:
        mr[:, m // 2:] = mr[:, :m - m // 2]
    if half_centers:
        ml[..., :2] = np.round(ml[..., :2] * 2) / 2
        mr[..., :2] = np.round(mr[..., :2] * 2) / 2
    il = rng.uniform(0, 255, (p, h, w)).astype(np.float32)
    ir = rng.uniform(0, 255, (p, h, w)).astype(np.float32)
    return (dl, ml.astype(np.float32), dr, mr.astype(np.float32), il, ir)


def _flip(desc: np.ndarray, n: int, rng, avoid=()) -> np.ndarray:
    """``desc`` (8,) uint32 with ``n`` distinct bits flipped, none of the
    bit positions in ``avoid``."""
    free = np.setdiff1d(np.arange(256), np.asarray(avoid, np.int64))
    out = desc.copy()
    for b in rng.choice(free, n, replace=False):
        out[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def _images(rng, p, h, w):
    return tuple(rng.uniform(0, 255, (p, h, w)).astype(np.float32)
                 for _ in range(2))


def adversarial_matcher_cases():
    """[(name, (dl, ml, dr, mr, il, ir))] fused-matcher inputs aimed at the
    search's and the SAD sweep's corners (descriptors uint32, meta rows
    float32 (x, y, level, valid), float images of 48 x 72):

    * ``crowded``: M = 1100 right features (more than one 1024-row
      staging chunk), every one inside every left feature's row band, at
      distances 1-3 from the left descriptor except planted zeros: in
      pair 0 only at indices 1030 and 1057 (the second chunk, lanes 6
      and 1), in pair 1 at 37, 70 and 1029 (lanes 5, 6 and 5, both
      chunks); the lowest index must win;
    * ``gate``: each left feature sees one candidate, at distance exactly
      64 (= max_hamming, accepted) or 65 (rejected: fallback to right
      feature 0);
    * ``empty``: every other left feature invalid, and the second half
      with no candidate (every right feature to its right);
    * ``edges``: window centers on, half a pixel inside and past the
      image edges (the clamps);
    * ``ragged``: K = 17 and M = 37, multiples of neither the 16-feature
      tile nor the 32 lanes;
    * ``k0``: no left feature; ``m0``: no right feature (a match-only
      case: the fused matcher's fallback needs right feature 0).
    """
    rng = np.random.RandomState(11)
    h, w = 48, 72
    cases = []

    p, k, m = 2, 20, 1100
    base = rng.randint(0, 2**32, (p, 8), dtype=np.uint64).astype(np.uint32)
    dl = np.repeat(base[:, None], k, 1)
    zeros = ((1030, 1057), (37, 70, 1029))
    dr = np.stack([np.stack([base[q] if j in zeros[q] else
                             _flip(base[q], rng.randint(1, 4), rng)
                             for j in range(m)]) for q in range(p)])
    mr = np.stack([rng.uniform(40.0, 46.0, (p, m)),
                   20.0 + rng.uniform(-1.0, 1.0, (p, m)),
                   np.zeros((p, m)), np.ones((p, m))], -1)
    ml = np.stack([rng.uniform(64.0, 70.0, (p, k)), np.full((p, k), 20.0),
                   np.zeros((p, k)), np.ones((p, k))], -1)
    cases.append(("crowded", (dl, ml, dr, mr) + _images(rng, p, h, w)))

    p, k = 2, 16
    base = rng.randint(0, 2**32, (p, 8), dtype=np.uint64).astype(np.uint32)
    dl = np.repeat(base[:, None], k, 1)
    dr = np.stack([np.stack([_flip(base[q], 64 + j % 2, rng)
                             for j in range(k)]) for q in range(p)])
    ys = np.tile(np.arange(k) * 2.9 + 1.0, (p, 1))
    mr = np.stack([rng.uniform(10.0, 60.0, (p, k)), ys, np.ones((p, k)),
                   np.ones((p, k))], -1)
    ml = mr.copy()
    ml[..., 0] += rng.uniform(0.0, 10.0, (p, k))
    cases.append(("gate", (dl, ml, dr, mr) + _images(rng, p, h, w)))

    dl, ml, dr, mr, il, ir = matcher_case(12, k=16, m=40, h=h, w=w)
    ml = ml.copy()
    ml[:, ::2, 3] = 0.0
    ml[:, 8:, 0] = -10.0
    cases.append(("empty", (dl, ml, dr, mr, il, ir)))

    edge_x = np.array([-3.0, -0.5, 0.0, 0.5, 4.5, w - 1.5, w - 1.0, w - 0.5,
                       w + 2.0, 5.5, 2.0, w - 3.0, 36.0, 0.0, w - 1.0, 10.0])
    edge_y = np.array([-2.0, 0.5, 0.0, h - 0.5, h + 5.0, 1.5, h - 1.0, -0.5,
                       3.0, h - 1.5, h - 2.0, 2.5, 0.0, h - 1.0, h + 1.0,
                       h - 0.5])
    dl, _, dr, _, il, ir = matcher_case(13, k=16, m=16, h=h, w=w)
    meta = np.stack([np.tile(edge_x, (2, 1)), np.tile(edge_y, (2, 1)),
                     np.zeros((2, 16)), np.ones((2, 16))], -1)
    dr = dl.copy()
    cases.append(("edges", (dl, meta.astype(np.float32), dr,
                            meta.astype(np.float32), il, ir)))

    cases.append(("ragged", matcher_case(14, k=17, m=37, h=h, w=w)))
    dl, ml, dr, mr, il, ir = matcher_case(15, h=h, w=w)
    cases.append(("k0", (dl[:, :0], ml[:, :0], dr, mr, il, ir)))
    cases.append(("m0", (dl, ml, dr[:, :0], mr[:, :0], il, ir)))
    return [(name, tuple(np.ascontiguousarray(
        a, np.uint32 if a.dtype == np.uint32 else np.float32) for a in c))
        for name, c in cases]
