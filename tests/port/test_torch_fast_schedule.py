"""The FAST-9/16 arc-extrema schedules of the dense FE kernels (K1, K6,
K11; ``csrc/frontend_common.cuh``), mirrored in plain torch and held
bit-equal to the port's plain version (``fast_score_plain``,
``ref.fast_score_map_int``) and to the JAX package's pure-jnp
``fast_score_from_taps`` on adversarial inputs.

The kernels take the arc extrema on the raw taps and subtract the centre
once a side: round(x - c) is monotone in x, so it commutes with min and
max.  Float taps go through van Herk / Gil-Werman on two blocks of 8
(``arc_extrema``); uint8 taps through DPX three-input min/max, an arc of
9 as three runs of 3, on 16-bit lanes (``arc_extrema_u16x2``).  The
exact compass pre-test (``fast_live``, ``fast_live_u16x2``) is mirrored
too.
Tolerance: bit-equal (signed zeros included) for thresholds >= 0; equal
in value below 0, where a zero score keeps whichever sign the
association gives it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.frontend_fused import fast_score_from_taps
from repro_torch.kernels.frontend_fused import fast_score_plain
from repro_torch.kernels.ref import CIRCLE16, edge_pad, fast_score_map_int

H, W = 21, 27


def raw_taps(x: torch.Tensor):
    """(B, H, W) -> the 16 circle taps, edge-replicated, in circle
    order."""
    h, w = x.shape[-2:]
    pad = (F.pad(x[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
           if x.is_floating_point() else edge_pad(x, 3))
    return [pad[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] for dx, dy in CIRCLE16]


def van_herk(t):
    """The kernel's float schedule: (lo, hi) = (max over arcs of the arc
    min, min over arcs of the arc max), blocks t[0..7] and t[8..15], in
    the kernel's association."""
    mn, mx = torch.minimum, torch.maximum
    pa, qa, pb, qb = [t[0]], [t[0]], [t[8]], [t[8]]
    for o in range(1, 8):
        pa.append(mn(pa[-1], t[o]))
        qa.append(mx(qa[-1], t[o]))
        pb.append(mn(pb[-1], t[8 + o]))
        qb.append(mx(qb[-1], t[8 + o]))
    sa = ra = t[7]
    sb = rb = t[15]
    lo, hi = [None] * 8, [None] * 8
    for o in range(7, -1, -1):
        if o < 7:
            sa, ra = mn(sa, t[o]), mx(ra, t[o])
            sb, rb = mn(sb, t[8 + o]), mx(rb, t[8 + o])
        lo[o] = mx(mn(sa, pb[o]), mn(sb, pa[o]))
        hi[o] = mn(mx(ra, qb[o]), mx(rb, qa[o]))

    def tree(v, op):
        return op(op(op(v[0], v[1]), op(v[2], v[3])),
                  op(op(v[4], v[5]), op(v[6], v[7])))
    return tree(lo, mx), tree(hi, mn)


def runs_of_three(t):
    """The kernel's uint8 schedule: the min (max) of taps i .. i + 2, an
    arc of 9 as three of those, then the three-input reduction tree."""
    def min3(a, b, c):
        return torch.minimum(torch.minimum(a, b), c)

    def max3(a, b, c):
        return torch.maximum(torch.maximum(a, b), c)
    mn3 = [min3(t[i], t[(i + 1) % 16], t[(i + 2) % 16]) for i in range(16)]
    mx3 = [max3(t[i], t[(i + 1) % 16], t[(i + 2) % 16]) for i in range(16)]
    mn9 = [min3(mn3[i], mn3[(i + 3) % 16], mn3[(i + 6) % 16])
           for i in range(16)]
    mx9 = [max3(mx3[i], mx3[(i + 3) % 16], mx3[(i + 6) % 16])
           for i in range(16)]

    def tree(v, op3, op2):
        return op2(op3(op3(*v[0:3]), op3(*v[3:6]), op3(*v[6:9])),
                   op3(op3(*v[9:12]), op3(*v[12:15]), v[15]))
    return (tree(mn9, max3, torch.maximum), tree(mx9, min3, torch.minimum))


def compass_zero(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """Where the kernels' exact pre-test proves the thresholded score 0:
    the second largest of the compass taps (0, 4, 8, 12) minus the
    centre not above ``threshold`` and the second smallest not below
    -``threshold``; of taps a, b, c, d the second largest is max(x, y)
    and the second smallest min(x, y), x = min(max(a, b), max(c, d)), y
    = max(min(a, b), min(c, d))."""
    t = raw_taps(x)
    a, b, c, d = (t[k] for k in (0, 4, 8, 12))
    mn, mx = torch.minimum, torch.maximum
    lo = mn(mx(a, b), mx(c, d))
    hi = mx(mn(a, b), mn(c, d))
    live = (mx(lo, hi) - x > threshold) | (-(mn(lo, hi) - x) > threshold)
    return ~live


def compass_count_zero(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """The pre-test as counted: fewer than 2 compass differences above
    ``threshold`` and fewer than 2 below -``threshold``."""
    t = raw_taps(x)
    d = [t[k] - x for k in (0, 4, 8, 12)]
    up = sum((v > threshold).int() for v in d)
    dn = sum((v < -threshold).int() for v in d)
    return (up < 2) & (dn < 2)


def mirror_float(x: torch.Tensor, threshold: float) -> torch.Tensor:
    lo, hi = van_herk(raw_taps(x))
    sc = torch.maximum(lo - x, -(hi - x))
    sc = torch.where(sc > threshold, sc, torch.zeros_like(sc))
    return torch.where(compass_zero(x, threshold), torch.zeros_like(sc), sc)


def mirror_u8(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """(B, H, W) uint8 -> int16 score, every step on int16 lanes: raw
    taps in [0, 255], lo - c and c - hi in [-255, 255]; the pre-test on
    the integer threshold floor(threshold)."""
    x16 = x.to(torch.int16)
    lo, hi = runs_of_three(raw_taps(x16))
    sc = torch.maximum(lo - x16, x16 - hi)
    thr = int(np.floor(threshold))
    sc = torch.where(sc > thr, sc, torch.zeros_like(sc))
    return torch.where(compass_zero(x16, thr), torch.zeros_like(sc), sc)


def jax_score(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """JAX's ``fast_score_from_taps`` on the same taps minus the centre
    (int32 differences for uint8 pixels, as the reference's kernel)."""
    xi = x if x.is_floating_point() else x.to(torch.int32)
    taps = [jnp.asarray((t - xi).numpy()) for t in raw_taps(xi)]
    return torch.from_numpy(np.array(fast_score_from_taps(taps, threshold)))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def adversarial_float(seed: int) -> dict:
    """Float frames that stress the exactness argument."""
    rng = np.random.RandomState(seed)
    out = {}
    plateau = np.round(rng.uniform(0, 255, (2, H, W)) / 64) * 64
    plateau[:, 4:14, 6:20] = 77.0
    out["plateaus and ties"] = plateau
    zeros = rng.choice([0.0, -0.0, 25.0, -25.0], size=(2, H, W))
    zeros[0, 8:15, 8:15] = -0.0
    zeros[1, 8:15, 8:15] = 0.0
    out["signed zeros"] = zeros
    out["non-integer"] = rng.uniform(-40.0, 300.0, (2, H, W))
    base = np.float32(100.3)
    ulp = []
    for k in (-20.0, 0.0, 20.0):
        v = np.float32(base + np.float32(k))
        ulp += [v, np.nextafter(v, np.float32(np.inf)),
                np.nextafter(v, np.float32(-np.inf))]
    out["one ulp about centre +- threshold"] = rng.choice(
        np.array(ulp, np.float32), size=(2, H, W))
    out["large magnitudes"] = rng.choice(
        np.array([3e38, -3e38, 1e37, -1e37, 1.5e-38, 0.0], np.float32),
        size=(2, H, W))
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in out.items()}


def adversarial_u8(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    edges = rng.choice([0, 255, 1, 254, 128], size=(2, H, W))
    edges[0, 5:16, 5:16] = 255
    edges[1, 5:16, 5:16] = 0
    ties = np.round(rng.uniform(0, 255, (2, H, W)) / 85) * 85
    near = 100 + rng.choice([-21, -20, -19, 0, 19, 20, 21], size=(2, H, W))
    return {k: torch.from_numpy(v.astype(np.uint8)) for k, v in
            (("0 and 255 edges", edges), ("plateaus and ties", ties),
             ("near centre +- threshold", near))}


FLOAT_CASES = adversarial_float(0)
U8_CASES = adversarial_u8(1)


@pytest.mark.parametrize("name", sorted(FLOAT_CASES))
def test_float_schedule_is_bit_equal(name):
    x = FLOAT_CASES[name]
    for threshold in (0.0, 20.0, 7.25):
        got = mirror_float(x, threshold)
        assert torch.equal(bits(got), bits(fast_score_plain(x, threshold)))
        assert torch.equal(bits(got), bits(jax_score(x, threshold)))
        # the pre-test is exact: it only ever zeroes a score that is 0,
        # and its second-extrema form is the count of compass taps
        want = fast_score_plain(x, threshold)
        zero = compass_zero(x, threshold)
        assert not bool((want[zero] != 0).any())
        assert torch.equal(zero, compass_count_zero(x, threshold))
    # below 0 a zero score may carry either sign: equal in value
    got = mirror_float(x, -5.0)
    assert torch.equal(got, fast_score_plain(x, -5.0))


@pytest.mark.parametrize("name", sorted(U8_CASES))
def test_u8_schedule_is_bit_equal(name):
    x = U8_CASES[name]
    for threshold in (0.0, 20.0, 19.5, -3.0):
        got = mirror_u8(x, threshold)
        assert got.dtype == torch.int16
        assert torch.equal(got, fast_score_map_int(x, threshold))
        assert torch.equal(got, jax_score(x, threshold).to(torch.int16))
        # and equal to the float schedule on the same values
        ref = fast_score_plain(x.float(), float(threshold))
        assert torch.equal(got.float(), ref)


def test_u8_packed_horizontal_pass_has_no_carry():
    """The uint8 horizontal blur pass sums two pixels in one 32-bit word
    (16-bit lanes): at most 255 * 36 = 9180 a lane, so the packed sum
    unpacks to the two per-pixel sums for any pixels."""
    rng = np.random.RandomState(2)
    row = np.concatenate([np.full(16, 255), rng.randint(0, 256, 48)])
    words = row[:-1] | (row[1:] << 16)             # pixel j and j + 1
    wts = (1, 4, 8, 10, 8, 4, 1)
    n = len(words) - 6
    packed = sum(int(wts[k]) * words[k:k + n] for k in range(7))
    assert int(packed.max()) < 2 ** 32
    lo = sum(int(wts[k]) * row[k:k + n] for k in range(7))
    hi = sum(int(wts[k]) * row[k + 1:k + 1 + n] for k in range(7))
    assert np.array_equal(packed & 0xffff, lo)
    assert np.array_equal(packed >> 16, hi)
    assert int(lo.max()) == 255 * 36
