"""BRIEF sampling pattern and angle-binned steering LUT (paper Sec.
II-B2, III-C).

The paper selects ``n`` point pairs from the circular patch "based on
Gaussian distribution" (ORB's original construction).  We generate a
deterministic pattern once at import time with a fixed seed so that the
descriptor is reproducible across the pure-jnp oracle, the Pallas kernel
and checkpoints.

The pattern radius is capped at ``PATTERN_RADIUS`` so that after an
arbitrary rotation (norm-preserving) and rounding, every sampled point
stays strictly inside the 31x31 patch (radius 15) used by the hardware.

Steering is angle-BINNED, as in the paper's FPGA (Sec. III-C): instead
of rotating all 256 pairs by each keypoint's exact theta (per-keypoint
cos/sin + round), theta is quantized to ``N_ANGLE_BINS`` bins of 30
degrees and the rotated pattern for every bin is precomputed once at
import time into ``STEER_LUT`` — the descriptor RAM's address ROM.
``STEER_LUT[b, i]`` holds the two *flattened* 31x31-patch indices
(row-major, ``(y + 15) * 31 + (x + 15)``) of pair ``i`` rotated by the
bin-``b`` center angle ``b * 2*pi / N_ANGLE_BINS``.  The LUT is the
single definition of steering shared by the Pallas kernel, the jnp
fallback and the ref oracle.

This is the port's own numpy copy of ``repro.kernels.pattern``: the
same seed and construction, so ``STEER_LUT`` is equal to the JAX
package's (pinned in ``tests/port``).
"""

from __future__ import annotations

import numpy as np

N_PAIRS = 256          # descriptor length in bits (32 x 8 bits, Sec. III-C)
PATCH_RADIUS = 15      # 31 x 31 patch, matching the FPGA register bank
PATTERN_RADIUS = 13    # max |offset| so rotate+round stays within radius 15
PATTERN_SIGMA = PATCH_RADIUS / 2.0
_SEED = 20210606       # AICAS'21 conference date; fixed for reproducibility

N_ANGLE_BINS = 12                          # 30-degree steering bins
ANGLE_BIN_STEP = 2.0 * np.pi / N_ANGLE_BINS


def _generate(seed: int = _SEED) -> np.ndarray:
    """Return int32 array (N_PAIRS, 4) of (ax, ay, bx, by) offsets."""
    rng = np.random.RandomState(seed)
    pts = []
    while len(pts) < N_PAIRS:
        cand = rng.normal(0.0, PATTERN_SIGMA, size=(4 * N_PAIRS, 4))
        cand = np.round(cand).astype(np.int32)
        ok = (
            (np.abs(cand[:, 0::2]).max(axis=1) ** 2
             + np.abs(cand[:, 1::2]).max(axis=1) ** 2)
            <= PATTERN_RADIUS ** 2
        )
        # Also require A != B so every binary test is informative.
        ok &= np.any(cand[:, :2] != cand[:, 2:], axis=1)
        pts.extend(cand[ok].tolist())
    return np.asarray(pts[:N_PAIRS], dtype=np.int32)


# (N_PAIRS, 4): columns are (ax, ay, bx, by), y down / x right image coords.
PATTERN: np.ndarray = _generate()

# Split views used by descriptor code: (N_PAIRS, 2) each.
PATTERN_A: np.ndarray = PATTERN[:, 0:2]
PATTERN_B: np.ndarray = PATTERN[:, 2:4]


def rotated_pattern(theta: float) -> np.ndarray:
    """Reference (numpy) EXACT steered pattern for a single angle.

    This is the pre-LUT steering (per-angle cos/sin + round-half-even);
    the binned ``STEER_LUT`` rows equal ``rotated_pattern(b *
    ANGLE_BIN_STEP)``.  Kept as the test reference that the angle-bin
    quantization is measured against.
    """
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    a = np.round(PATTERN_A @ rot.T).astype(np.int32)
    b = np.round(PATTERN_B @ rot.T).astype(np.int32)
    return np.concatenate([a, b], axis=1)


def _flatten_offsets(pts: np.ndarray) -> np.ndarray:
    """(N, 2) int32 (x, y) offsets -> (N,) row-major 31x31 patch indices."""
    assert np.abs(pts).max() <= PATCH_RADIUS
    return ((pts[:, 1] + PATCH_RADIUS) * (2 * PATCH_RADIUS + 1)
            + (pts[:, 0] + PATCH_RADIUS)).astype(np.int32)


def _steer_lut() -> np.ndarray:
    """(N_ANGLE_BINS, N_PAIRS, 2) int32 flattened-patch-index LUT."""
    rows = []
    for b in range(N_ANGLE_BINS):
        rot = rotated_pattern(b * ANGLE_BIN_STEP)
        rows.append(np.stack([_flatten_offsets(rot[:, 0:2]),
                              _flatten_offsets(rot[:, 2:4])], axis=-1))
    return np.stack(rows).astype(np.int32)


# The descriptor steering ROM: STEER_LUT[bin, pair] = (a_lin, b_lin).
STEER_LUT: np.ndarray = _steer_lut()
