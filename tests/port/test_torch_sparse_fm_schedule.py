"""The search, SAD and moment schedules of the fused matcher (K3, with
K4, K5, K9, K10; ``csrc/matcher_common.cuh``) and of the sparse FE (K2,
with K7, K8; ``csrc/describe_common.cuh``), mirrored in plain torch and
held to the JAX package's pure-jnp functions and to the port's plain
versions on adversarial inputs.

* The search: lanes stride over the right features in index order, 32 at
  a step, in staging chunks (a multiple of 32); each lane keeps a strict-<
  running minimum over its candidates, the chunks' minima merge in order
  and the lanes' by an xor butterfly on (distance, index), lexicographic.
  Bit-equal to JAX ``masked_hamming`` + first-occurrence argmin and to
  ``match_fused_plain``, whatever the chunk size.
* The SAD sweep: lane r sums every shift's |L[r][c] - R[r][c + s]| of its
  row; a transposing butterfly over 16 lanes leaves shift s in lane s; the
  argmin is the lexicographic (SAD, shift) minimum.  With the search and
  the gate, bit-equal to ``match_rectify_fused_plain`` in all four
  outputs.
* The moments: lane c sums its column inside the circular mask, rows in
  order (sum p, sum dy * p), then m10 = sum of dx * (sum p) and m01 =
  sum of (sum dy * p) over the lanes by an xor butterfly.  Exactly equal
  to JAX ``patch_theta`` / ``patch_theta_int`` on integer-valued and uint8
  patches; within 2 * gamma_961 * sum|x * p| on float patches.
* The packed steering table (``ref.steer_lut_packed``) unpacks to
  ``STEER_LUT`` for all 12 bins, and every tap lies inside the disc
  (``TAP_REACH2``) that the uint8 sparse FE reads.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hamming_match as jhm
from repro.kernels import pattern as jpattern
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.hamming_match import BIG, masked_hamming
from repro_torch.kernels.match_fused import match_fused_plain
from repro_torch.kernels.matcher_fused import match_rectify_fused_plain

from parity import GAMMA_961, adversarial_matcher_cases, matcher_case

CSRC = Path(ref.__file__).resolve().parent / "csrc"
KW = dict(row_band=2.0, max_disparity=24.0)
LANES = 32


def butterfly_min(best, idx):
    """(..., 32) lane values -> the xor butterfly's lexicographic
    (distance, index) minimum, which every lane ends with."""
    lane = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        ob, oi = best[..., lane ^ o], idx[..., lane ^ o]
        take = (ob < best) | ((ob == best) & (oi < idx))
        best, idx = torch.where(take, ob, best), torch.where(take, oi, idx)
    return best[..., 0], idx[..., 0]


def kernel_search(dl, ml, dr, mr, chunk: int, **kw):
    """The kernels' search order on (P, K, 8) x (P, M, 8): per chunk of
    ``chunk`` right features, each lane's strict-< running minimum over
    its indices j = base + lane + 32 t; the chunks merged in order
    (strict <), then the lanes by the butterfly."""
    dist = masked_hamming(dl, ml, dr, mr, **kw)           # (P, K, M)
    m = dist.shape[-1]
    best = torch.full(dist.shape[:-1] + (LANES,), BIG, dtype=torch.int32)
    idx = torch.full_like(best, -1)
    for base in range(0, m, chunk):
        n = min(chunk, m - base)
        cb, ci = torch.full_like(best, BIG), torch.full_like(idx, -1)
        for t in range(0, n, LANES):
            j = base + t + torch.arange(LANES)
            d = torch.where(j < base + n, dist[..., j.clamp(max=m - 1)],
                            torch.full_like(cb, BIG))
            better = d < cb
            cb = torch.where(better, d, cb)
            ci = torch.where(better, j.to(torch.int32).expand_as(ci), ci)
        better = cb < best
        best, idx = torch.where(better, cb, best), torch.where(better, ci, idx)
    return butterfly_min(best, idx)


def transposing_sum(acc):
    """(..., 16 lanes, 16 values) -> (..., 16): the kernels' transposing
    butterfly; lane l ends with value l summed over the lanes."""
    lane = torch.arange(16)
    v = acc.clone()
    for o in (8, 4, 2, 1):
        hi = ((lane & o) != 0)[:, None]
        lo_v, hi_v = v[..., :o], v[..., o:2 * o]
        keep = torch.where(hi, hi_v, lo_v)
        send = torch.where(hi, lo_v, hi_v)
        v = keep + send[..., lane ^ o, :]
    return v[..., 0]


def kernel_sweep(img_l, img_r, xy_l, xy_r, window: int = 11, rng: int = 5):
    """(P, K) first-occurrence SAD argmins of the kernels' sweep: lane r
    (row r) sums every shift, the transposing butterfly over the rows,
    then the lexicographic (SAD, shift) butterfly."""
    sweep = 2 * rng + 1
    out = []
    for p in range(xy_l.shape[0]):
        lp = ref.gather_patches(img_l[p], xy_l[p], window,
                                window).to(torch.int32)
        rs = ref.gather_patches(img_r[p], xy_r[p], window,
                                window + 2 * rng).to(torch.int32)
        acc = torch.zeros(lp.shape[0], 16, 16, dtype=torch.int32)
        for s in range(sweep):
            acc[:, :window, s] = (lp - rs[:, :, s:s + window]).abs().sum(
                -1, dtype=torch.int32)
        sads = transposing_sum(acc)                          # (K, 16)
        lane = torch.arange(LANES)
        best = torch.full((lp.shape[0], LANES), 2**31 - 1, dtype=torch.int32)
        best[:, :sweep] = sads[:, :sweep]
        shift = torch.where(lane < sweep, lane, 2**31 - 1).to(
            torch.int32).expand_as(best).clone()
        out.append(butterfly_min(best, shift)[1])
    return torch.stack(out)


def jax_search(dl, ml, dr, mr):
    """JAX ``masked_hamming`` and its first-occurrence argmin, (BIG, -1)
    where no candidate survives."""
    best, idx = [], []
    for p in range(dl.shape[0]):
        if dr.shape[1] == 0:
            best.append(np.full(dl.shape[1], BIG, np.int32))
            idx.append(np.full(dl.shape[1], -1, np.int32))
            continue
        d = np.asarray(jhm.masked_hamming(
            jnp.asarray(dl[p]), jnp.asarray(ml[p]), jnp.asarray(dr[p]),
            jnp.asarray(mr[p]), **KW))
        b = d.min(axis=1) if d.shape[0] else np.zeros(0, np.int32)
        a = d.argmin(axis=1) if d.shape[0] else np.zeros(0, np.int64)
        best.append(b.astype(np.int32))
        idx.append(np.where(b >= BIG, -1, a).astype(np.int32))
    return np.stack(best), np.stack(idx)


def cases():
    return ([(f"seed{s}", matcher_case(s, ties=s == 1)) for s in (0, 1)]
            + adversarial_matcher_cases())


@pytest.mark.parametrize("name,case", cases(), ids=[c[0] for c in cases()])
def test_search_order_equals_jax_and_plain(name, case):
    dl, ml, dr, mr, _, _ = case
    t = [torch.from_numpy(a) for a in (dl.view(np.int32), ml,
                                       dr.view(np.int32), mr)]
    want_best, want_idx = jax_search(dl, ml, dr, mr)
    plain = match_fused_plain(*t, **KW)
    for chunk in (1024, 64, 32):
        best, idx = kernel_search(*t, chunk=chunk, **KW)
        np.testing.assert_array_equal(best.numpy(), want_best)
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        assert torch.equal(best, plain[0]) and torch.equal(idx, plain[1])
    if name == "crowded":
        # the planted zeros: the lowest index wins across chunks and lanes
        assert set(idx[0][best[0] == 0].tolist()) <= {1030}
        assert set(idx[1][best[1] == 0].tolist()) <= {37}
        assert (best == 0).any(-1).all()
    if name == "gate":
        assert set(best.unique().tolist()) == {64, 65}


@pytest.mark.parametrize("name,case", [c for c in cases() if c[1][2].shape[1]],
                         ids=[c[0] for c in cases() if c[1][2].shape[1]])
def test_fused_matcher_schedule_equals_plain(name, case):
    dl, ml, dr, mr, il, ir = case
    t = [torch.from_numpy(a) for a in (dl.view(np.int32), ml,
                                       dr.view(np.int32), mr, il, ir)]
    kw = dict(KW, max_hamming=64)
    want = match_rectify_fused_plain(*t, **kw)
    best, idx = kernel_search(*t[:4], chunk=64, **KW)
    ok = (idx >= 0) & (best <= 64) & (t[1][..., 3] > 0.5)
    eff = torch.where(ok, idx, torch.zeros_like(idx)).long()
    rxy = torch.gather(t[3][..., :2], 1, eff[..., None].expand(-1, -1, 2))
    sad = kernel_sweep(t[4], t[5], t[1][..., :2], rxy)
    for got, exp in zip((best, idx, rxy, sad), want):
        assert torch.equal(got, exp), name


def test_sweep_transposes_every_shift():
    """Each lane ends with its own shift's sum, for random rows."""
    acc = torch.from_numpy(np.random.RandomState(3).randint(
        0, 1000, (5, 16, 16)).astype(np.int32))
    assert torch.equal(transposing_sum(acc), acc.sum(1, dtype=torch.int32))


def column_moments(patches: torch.Tensor):
    """(N, 31, 31) float32 or uint8 patches -> (N, 2) moments in the
    kernels' order: lane c's masked column sums in row order, dx * sum p,
    then the xor butterfly over 32 lanes (lane 31 empty)."""
    integer = patches.dtype == torch.uint8
    x = patches.to(torch.int32 if integer else torch.float32)
    n = x.shape[0]
    zero = torch.zeros(n, dtype=x.dtype)
    a, b = [], []
    for c in range(LANES):
        dx = c - 15
        s, t = zero.clone(), zero.clone()
        for i in range(31):
            dy = i - 15
            if c < 31 and dx * dx + dy * dy <= 225:
                v = x[:, i, c]
                s = s + v
                t = t + (v * dy if integer
                         else torch.tensor(float(dy), dtype=torch.float32) * v)
        a.append(s * dx if integer
                 else torch.tensor(float(dx), dtype=torch.float32) * s)
        b.append(t)
    a, b = torch.stack(a, -1), torch.stack(b, -1)
    lane = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        a, b = a + a[:, lane ^ o], b + b[:, lane ^ o]
    return torch.stack([a[:, 0], b[:, 0]], -1).to(torch.float32)


def moment_patches(seed: int):
    """Adversarial 31 x 31 patches: a ramp, a hot center, saturated and
    blank ones, a checkerboard and noise, as float in [0, 255]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:31, 0:31].astype(np.float32)
    fixed = [xx * 8.2, yy * 8.2, np.full((31, 31), 255.0),
             np.zeros((31, 31)), 255.0 * ((xx + yy) % 2),
             np.where((xx - 15) ** 2 + (yy - 15) ** 2 <= 4, 255.0, 0.0)]
    noise = rng.uniform(0.0, 255.0, (26, 31, 31))
    return np.concatenate([np.stack(fixed), noise]).astype(np.float32)


def test_column_moments_exact_on_integer_and_uint8_patches():
    p = np.round(moment_patches(0))
    _, want = jref.patch_theta(jnp.asarray(p))
    _, want_int = jref.patch_theta_int(jnp.asarray(p.astype(np.uint8)))
    got = column_moments(torch.from_numpy(p))
    got_u8 = column_moments(torch.from_numpy(p.astype(np.uint8)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_u8.numpy(),
                                  np.asarray(want_int).astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), got_u8.numpy())


def test_column_moments_within_bound_on_float_patches():
    p = moment_patches(1)
    p[6:] += np.random.RandomState(2).uniform(-0.5, 0.5, p[6:].shape)
    p = p.astype(np.float32)
    _, want = jref.patch_theta(jnp.asarray(p))
    xg, yg = (np.asarray(g) for g in jref.moment_grids())
    s_abs = np.stack([np.abs(p * xg).sum((1, 2)), np.abs(p * yg).sum((1, 2))],
                     -1)
    got = column_moments(torch.from_numpy(p)).numpy()
    diff = np.abs(got.astype(np.float64) - np.asarray(want))
    assert np.all(diff <= 2 * GAMMA_961 * s_abs)
    _, plain = ref.patch_theta(torch.from_numpy(p))
    assert np.all(np.abs(got.astype(np.float64) - plain.numpy())
                  <= 2 * GAMMA_961 * s_abs)


def test_packed_steering_table_unpacks_to_the_lut():
    packed = ref.steer_lut_packed("cpu")
    assert packed.shape == (12, 256) and packed.dtype == torch.int32
    lut = ref.steer_lut("cpu")
    assert torch.equal(packed & 0xFFFF, lut[..., 0])
    assert torch.equal(packed >> 16, lut[..., 1])
    np.testing.assert_array_equal(lut.numpy(), jpattern.STEER_LUT)


def test_every_tap_lies_in_the_read_disc():
    reach2 = int(re.search(r"constexpr int TAP_REACH2 = (\d+);",
                           (CSRC / "describe_common.cuh").read_text())[1])
    taps = jpattern.STEER_LUT.reshape(-1)
    dy, dx = taps // 31 - 15, taps % 31 - 15
    assert int((dx * dx + dy * dy).max()) == reach2


def test_packed_table_descriptor_equals_lut_descriptor():
    """Tau bits through the packed table (the kernels' word per pair)
    equal ``lut_descriptor`` on every bin."""
    rng = np.random.RandomState(4)
    sm = torch.from_numpy(rng.uniform(0, 255, (24, 31, 31)).astype(np.float32))
    bins = torch.arange(24) % 12
    pairs = ref.steer_lut_packed("cpu")[bins]
    flat = sm.flatten(1)
    tau = (torch.gather(flat, 1, (pairs & 0xFFFF).long())
           < torch.gather(flat, 1, (pairs >> 16).long()))
    assert torch.equal(ref.pack_bits(tau), ref.lut_descriptor(sm, bins))
