"""The port's plain oracles (``repro_torch.kernels.ref`` and
``hamming_match``) against the JAX package's, on identical numpy inputs
made from a seed.  All bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hamming_match as jhm
from repro.kernels import ref as jref
from repro_torch.kernels import hamming_match, ref

from parity import desc_u32


def test_moment_grids_equal():
    for a, b in zip(ref.moment_grids(), jref.moment_grids()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_theta_to_bin_equal():
    rng = np.random.RandomState(0)
    step = 2 * np.pi / 12
    theta = np.concatenate([
        rng.uniform(-np.pi, np.pi, 4000),
        (np.arange(-12, 13) + 0.5) * step,        # exact bin edges
        np.nextafter((np.arange(-12, 13) + 0.5) * step, 10.0),
        [np.pi, -np.pi, 0.0, -0.0]]).astype(np.float32)
    got = ref.theta_to_bin(torch.from_numpy(theta)).numpy()
    want = np.asarray(jref.theta_to_bin(jnp.asarray(theta)))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 12


def test_pack_bits_equal():
    bits = np.random.RandomState(1).rand(50, 256) < 0.5
    got = desc_u32(ref.pack_bits(torch.from_numpy(bits)))
    np.testing.assert_array_equal(got, np.asarray(jref.pack_bits(
        jnp.asarray(bits))))


def test_extract_and_gather_patches_equal():
    rng = np.random.RandomState(2)
    img = rng.uniform(0, 255, (40, 57)).astype(np.float32)
    xy_i = rng.randint(-20, 80, (64, 2)).astype(np.int32)
    got = ref.extract_patches(torch.from_numpy(img), torch.from_numpy(xy_i))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.extract_patches(jnp.asarray(img), jnp.asarray(xy_i))))
    # float centers, half-integers included (round half to even)
    xy_f = np.concatenate([rng.uniform(-10, 70, (40, 2)),
                           np.array([[2.5, 3.5], [0.5, -0.5], [55.5, 38.5],
                                     [56.5, 39.5]])]).astype(np.float32)
    for ph, pw in ((11, 11), (11, 21), (3, 5)):
        got = ref.gather_patches(torch.from_numpy(img),
                                 torch.from_numpy(xy_f), ph, pw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jref.gather_patches(jnp.asarray(img), jnp.asarray(xy_f), ph, pw)))


def test_sad_search_equal():
    rng = np.random.RandomState(3)
    lp = rng.uniform(0, 255, (30, 11, 11)).astype(np.float32)
    rs = rng.uniform(0, 255, (30, 11, 21)).astype(np.float32)
    got = ref.sad_search(torch.from_numpy(lp), torch.from_numpy(rs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.sad_search(jnp.asarray(lp), jnp.asarray(rs))))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_hamming_equal(seed):
    rng = np.random.RandomState(seed)
    k, m = 40, 56
    dl = rng.randint(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)
    dr = rng.randint(0, 2**32, (m, 8), dtype=np.uint64).astype(np.uint32)
    ml = np.stack([rng.uniform(0, 60, k), rng.uniform(0, 20, k),
                   rng.randint(0, 2, k), rng.rand(k) < 0.9], -1)
    mr = np.stack([rng.uniform(0, 60, m), rng.uniform(0, 20, m),
                   rng.randint(0, 2, m), rng.rand(m) < 0.9], -1)
    ml, mr = ml.astype(np.float32), mr.astype(np.float32)
    got = hamming_match.masked_hamming(
        torch.from_numpy(dl.view(np.int32)), torch.from_numpy(ml),
        torch.from_numpy(dr.view(np.int32)), torch.from_numpy(mr),
        row_band=2.0, max_disparity=30.0)
    want = jhm.masked_hamming(jnp.asarray(dl), jnp.asarray(ml),
                              jnp.asarray(dr), jnp.asarray(mr),
                              row_band=2.0, max_disparity=30.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < hamming_match.BIG).any()


@pytest.mark.parametrize("n", [0, 37, 100_003])
def test_atan2_does_not_depend_on_place(n):
    """An element's ``ref.atan2`` is the same wherever it lies in the
    tensor, also in a call larger than torch's one-thread grain (32,768
    elements, where each thread's share has a tail of its own): the
    whole call equals the same call shifted by one element and the
    calls on 1,024-element slices, and ``torch.atan2`` of each element
    alone to 1 ulp."""
    rng = np.random.RandomState(n)
    y = torch.from_numpy(rng.uniform(-1e4, 1e4, n + 1).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1e4, 1e4, n + 1).astype(np.float32))
    whole = ref.atan2(y, x)
    assert torch.equal(whole[1:], ref.atan2(y[1:], x[1:]))
    assert torch.equal(whole, torch.cat([
        ref.atan2(a, b) for a, b in zip(y.split(1024), x.split(1024))]))
    alone = torch.stack([torch.atan2(a, b) for a, b in zip(y[:50], x[:50])])
    diff = (whole[:50].view(torch.int32) - alone.view(torch.int32)).abs()
    assert int(diff.max()) <= 1
