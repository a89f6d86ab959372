"""The unfused Feature Matcher schedule — the single-pair Hamming
matcher (K9, ``kernels.hamming_match``), the SAD sweep (K10,
``kernels.sad_rectify``) and ``core.matching.stereo_match_unfused`` /
``sad_rectify_unfused`` / ``match_pair_unfused`` — against the JAX
package's (``impl="ref"``) and its numpy brute-force oracles on
identical inputs made with numpy from a seed; and the port's fused
matcher pinned to its unfused one pair by pair, as
``tests/test_matcher_fused.py`` pins the JAX package's.

Every output is bit-equal, with no tolerance: Hamming distances, SAD
tables, indices and flags are integer or bool, and the disparities and
depths come from the same float32 arithmetic on both sides."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matching as jmatching
from repro.core import types as jtypes
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ORBConfig, matching
from repro_torch.core.types import (CameraIntrinsics, FeatureSet,
                                    MatchSet, combine_fields)
from repro_torch.kernels import hamming_match, ops, sad_rectify

from parity import matcher_case, np_of

ROW_BAND, MAX_DISP = 2.0, 24.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- K9: the single-pair Hamming matcher -------------------------------------

def _hamming_case(name):
    """One pair's (desc_l uint32, meta_l, desc_r uint32, meta_r)."""
    if name == "ties":
        dl, ml, dr, mr, _, _ = matcher_case(seed=1, ties=True, p=1)
    elif name == "more_right_than_a_tile":
        dl, ml, dr, mr, _, _ = matcher_case(seed=3, k=5, m=130, p=1)
    else:
        dl, ml, dr, mr, _, _ = matcher_case(seed=0, k=40, m=48, p=1)
    dl, ml, dr, mr = dl[0], ml[0].copy(), dr[0], mr[0].copy()
    if name == "all_invalid_left":
        ml[:, 3] = 0.0
    if name == "all_invalid_right":
        mr[:, 3] = 0.0
    return dl, ml, dr, mr


def _port_hamming(dl, ml, dr, mr, fn):
    return fn(_t(dl.view(np.int32)), _t(ml), _t(dr.view(np.int32)), _t(mr),
              row_band=ROW_BAND, max_disparity=MAX_DISP)


@pytest.mark.parametrize("name", ["random", "more_right_than_a_tile", "ties",
                                  "all_invalid_left", "all_invalid_right"])
def test_hamming_match_plain_matches_jax_and_bruteforce(name):
    """K and M not multiples of 128; rows with no candidate give
    (``BIG``, -1) on every side."""
    dl, ml, dr, mr = _hamming_case(name)
    want = jops.hamming_match(jnp.asarray(dl), jnp.asarray(ml),
                              jnp.asarray(dr), jnp.asarray(mr),
                              row_band=ROW_BAND, max_disparity=MAX_DISP,
                              impl="ref")
    brute = jref.hamming_match_bruteforce(dl, ml, dr, mr, ROW_BAND, MAX_DISP)
    got = _port_hamming(dl, ml, dr, mr, hamming_match.hamming_match_plain)
    via_ops = _port_hamming(dl, ml, dr, mr, ops.hamming_match)
    for i, field in enumerate(("dist", "idx")):
        assert got[i].dtype == torch.int32
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=field)
        np.testing.assert_array_equal(got[i].numpy(), brute[i],
                                      err_msg=field)
        assert torch.equal(via_ops[i], got[i])
    none = got[1].numpy() < 0
    np.testing.assert_array_equal(got[0].numpy()[none], hamming_match.BIG)
    if name.startswith("all_invalid"):
        assert none.all()
    else:
        assert (~none).sum() >= 3


def test_hamming_match_empty_right_set():
    """M = 0: every row has no candidate, (``BIG``, -1), as the
    brute-force oracle and the JAX package's Pallas path (which pads M
    with invalid rows) give it; the JAX ``impl="ref"`` path raises on
    the empty reduction instead."""
    dl, ml, _, _ = _hamming_case("random")
    dr, mr = dl[:0], ml[:0]
    brute = jref.hamming_match_bruteforce(dl, ml, dr, mr, ROW_BAND, MAX_DISP)
    got = _port_hamming(dl, ml, dr, mr, ops.hamming_match)
    for a, b in zip(got, brute):
        np.testing.assert_array_equal(a.numpy(), b)
    assert (got[1].numpy() == -1).all()


def test_hamming_match_tie_resolves_to_lowest_index():
    """The same descriptor planted at several right indices inside the
    search region: the first occurrence wins (the strict-< running
    minimum of the kernel, the first-occurrence argmin of the oracle)."""
    rng = np.random.RandomState(23)
    k, m = 8, 60
    dl = rng.randint(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)
    dr = rng.randint(0, 2**32, (m, 8), dtype=np.uint64).astype(np.uint32)
    ties = [5, 17, 40, 59]
    dr[ties] = dl[0]
    ml = np.tile(np.float32([50.0, 30.0, 0.0, 1.0]), (k, 1))
    mr = np.tile(np.float32([30.0, 30.0, 0.0, 1.0]), (m, 1))
    want = jops.hamming_match(jnp.asarray(dl), jnp.asarray(ml),
                              jnp.asarray(dr), jnp.asarray(mr),
                              row_band=ROW_BAND, max_disparity=MAX_DISP,
                              impl="ref")
    brute = jref.hamming_match_bruteforce(dl, ml, dr, mr, ROW_BAND, MAX_DISP)
    got = _port_hamming(dl, ml, dr, mr, ops.hamming_match)
    for a, b, c in zip(got, want, brute):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c)
    assert (int(got[0][0]), int(got[1][0])) == (0, ties[0])


# -- K10: the SAD sweep --------------------------------------------------------

@pytest.mark.parametrize("kind", ["integer", "float"])
@pytest.mark.parametrize("window,sad_range", [(11, 5), (7, 3)])
def test_sad_search_plain_matches_jax_and_bruteforce(kind, window,
                                                     sad_range):
    """Float windows hold non-integer and negative pixels: both sides
    truncate toward zero before the differences."""
    rng = np.random.RandomState(7)
    k = 37
    shapes = ((k, window, window), (k, window, window + 2 * sad_range))
    if kind == "integer":
        lp, rs = (rng.randint(0, 256, s).astype(np.float32) for s in shapes)
    else:
        lp, rs = (rng.uniform(-20.0, 255.0, s).astype(np.float32)
                  for s in shapes)
        assert (np.trunc(lp) != np.floor(lp)).any()
    want = jops.sad_search(jnp.asarray(lp), jnp.asarray(rs), impl="ref")
    brute = jref.sad_search_bruteforce(lp, rs)
    got = sad_rectify.sad_search_plain(_t(lp), _t(rs))
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (k, 2 * sad_range + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), brute)
    assert torch.equal(ops.sad_search(_t(lp), _t(rs)), got)


@pytest.mark.parametrize("lp_shape,rs_shape,match", [
    ((4, 17, 17), (4, 17, 27), "15 px"),
    ((4, 11, 11), (4, 11, 45), r"\+-15 px"),
    ((4, 11, 11), (4, 11, 20), "P \\+ 2R"),
])
def test_sad_search_kernel_refuses_what_it_cannot_hold(lp_shape, rs_shape,
                                                       match):
    """The kernel's wrapper names its window and sweep limits (and the
    strip shape it takes) before any launch."""
    lp = torch.zeros(lp_shape, device="meta")
    rs = torch.zeros(rs_shape, device="meta")
    before = sad_rectify.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        sad_rectify.sad_search(lp, rs)
    assert sad_rectify.KERNEL.launches == before


# -- the unfused schedule against the JAX package's ---------------------------

# (h, w, k, m, valid_frac): a random case, more right than left
# features, and every feature masked out.
PAIR_CASES = {"random": (96, 128, 37, 29, 0.8),
              "more_right": (64, 96, 21, 45, 0.8),
              "all_invalid": (64, 96, 17, 13, 0.0)}
KINDS = ["integer", "float"]


def _features(rng, k, h, w, valid_frac, n_levels=2):
    """numpy fields of a random FeatureSet (the JAX tests' generator)."""
    return dict(
        xy=np.stack([rng.uniform(-6, w + 6, k),
                     rng.uniform(-6, h + 6, k)], 1).astype(np.float32),
        level=rng.randint(0, n_levels, k).astype(np.int32),
        score=rng.uniform(1, 50, k).astype(np.float32),
        theta=rng.uniform(-np.pi, np.pi, k).astype(np.float32),
        desc=rng.randint(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32),
        valid=rng.uniform(size=k) > 1.0 - valid_frac)


def _port_feat(f):
    return FeatureSet(**{n: _t(v.view(np.int32) if n == "desc" else v)
                         for n, v in f.items()})


def _jax_feat(f):
    return jtypes.FeatureSet(**{n: jnp.asarray(v) for n, v in f.items()})


def _cfg(h, w):
    return dict(height=h, width=w, row_band=25, max_disparity=250,
                max_hamming=140)


def _intr(h, w):
    return dict(fx=120.0, cx=w / 2.0, cy=h / 2.0, baseline=0.2)


@functools.lru_cache(maxsize=None)
def _pair_inputs(seed, n_pairs, h, w, k, m, valid_frac, kind):
    """Images (n_pairs, h, w) and per-pair left/right feature fields."""
    rng = np.random.RandomState(seed)
    if kind == "integer":
        imgs = rng.randint(0, 256, (2, n_pairs, h, w)).astype(np.float32)
    else:
        imgs = rng.uniform(0.0, 255.0, (2, n_pairs, h, w)).astype(np.float32)
    fls = [_features(rng, k, h, w, valid_frac) for _ in range(n_pairs)]
    frs = [_features(rng, m, h, w, valid_frac) for _ in range(n_pairs)]
    return imgs[0], imgs[1], fls, frs


def _single(case, kind):
    h, w, k, m, vf = PAIR_CASES[case]
    il, ir, fls, frs = _pair_inputs(21, 1, h, w, k, m, vf, kind)
    return il[0], ir[0], fls[0], frs[0], _cfg(h, w), _intr(h, w)


@pytest.fixture(scope="module")
def jax_unfused():
    """The JAX package's three unfused entry points (``impl="ref"``) on
    every case, computed once for the module: {(case, kind): (stereo
    MatchSet, sad_rectify DepthSet on those matches, match_pair
    (MatchSet, DepthSet))} as numpy."""
    out = {}
    for case in PAIR_CASES:
        for kind in KINDS:
            il, ir, fl, fr, cfg, intr = _single(case, kind)
            jcfg = jtypes.ORBConfig(**cfg)
            jintr = jtypes.CameraIntrinsics(**intr)
            jfl, jfr = _jax_feat(fl), _jax_feat(fr)
            sm = jmatching.stereo_match_unfused(jfl, jfr, jcfg, impl="ref")
            sr = jmatching.sad_rectify_unfused(jnp.asarray(il),
                                               jnp.asarray(ir), jfl, jfr, sm,
                                               jcfg, jintr, impl="ref")
            mp = jmatching.match_pair_unfused(jnp.asarray(il),
                                              jnp.asarray(ir), jfl, jfr,
                                              jcfg, jintr, impl="ref")
            out[case, kind] = tuple(
                type(t)(*[np.array(x) for x in t])
                for t in (sm, sr, *mp))
    return out


def _same(got, want, what):
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_array_equal(np_of(b), a, err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_stereo_match_unfused_matches_jax(jax_unfused, case):
    _, _, fl, fr, cfg, _ = _single(case, "integer")
    got = matching.stereo_match_unfused(_port_feat(fl), _port_feat(fr),
                                        ORBConfig(**cfg))
    _same(got, jax_unfused[case, "integer"][0], "stereo_match_unfused")
    if case == "all_invalid":
        assert not got.valid.any()
        assert (got.distance == hamming_match.BIG).all()
        assert (got.right_index == 0).all()
    else:
        assert got.valid.any() and (~got.valid).any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_sad_rectify_unfused_matches_jax(jax_unfused, case, kind):
    """On the JAX package's own matches; float frames put the
    truncation of non-integer pixels on the path."""
    il, ir, fl, fr, cfg, intr = _single(case, kind)
    matches = MatchSet(*[_t(x) for x in jax_unfused[case, kind][0]])
    got = matching.sad_rectify_unfused(_t(il), _t(ir), _port_feat(fl),
                                       _port_feat(fr), matches,
                                       ORBConfig(**cfg),
                                       CameraIntrinsics(**intr))
    _same(got, jax_unfused[case, kind][1], "sad_rectify_unfused")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_match_pair_unfused_matches_jax(jax_unfused, case, kind):
    il, ir, fl, fr, cfg, intr = _single(case, kind)
    with ops.launch_audit() as audit:
        m, d = matching.match_pair_unfused(_t(il), _t(ir), _port_feat(fl),
                                           _port_feat(fr), ORBConfig(**cfg),
                                           CameraIntrinsics(**intr))
    assert audit.count == 0          # the CPU runs the plain versions
    _, _, wm, wd = jax_unfused[case, kind]
    _same(m, wm, "match_pair_unfused matches")
    _same(d, wd, "match_pair_unfused depth")
    if case != "all_invalid":
        assert d.valid.any()


# -- the port's own pin: fused == unfused, pair by pair -----------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w,k,m,n_pairs,valid_frac", [
    (96, 128, 37, 29, 2, 0.8),
    (64, 96, 21, 45, 3, 0.8),
    (64, 96, 9, 5, 1, 0.8),
    (64, 96, 17, 13, 2, 0.0),
], ids=["two_pairs", "more_right_three_pairs", "tiny", "all_invalid"])
def test_fused_equals_unfused_pair_by_pair(h, w, k, m, n_pairs, valid_frac,
                                           kind):
    il, ir, fls, frs = _pair_inputs(22, n_pairs, h, w, k, m, valid_frac,
                                    kind)
    cfg, intr = ORBConfig(**_cfg(h, w)), CameraIntrinsics(**_intr(h, w))
    pfl = [_port_feat(f) for f in fls]
    pfr = [_port_feat(f) for f in frs]
    mf, df = matching.match_pair_fused(
        _t(il), _t(ir), combine_fields(torch.stack, pfl),
        combine_fields(torch.stack, pfr), cfg, intr)
    for p in range(n_pairs):
        mu, du = matching.match_pair_unfused(_t(il[p]), _t(ir[p]), pfl[p],
                                             pfr[p], cfg, intr)
        for got, want in ((mf, mu), (df, du)):
            for name, a, b in zip(want._fields, want, got):
                assert torch.equal(b[p], a), (p, name)
    if valid_frac == 0.0:
        assert not mf.valid.any()
        assert (mf.right_index == 0).all()
    else:
        assert mf.valid.any() and (~mf.valid).any()
