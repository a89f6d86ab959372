"""Re-export of the BRIEF sampling pattern (port of
``repro.core.pattern``).

The pattern and its angle-binned steering LUT live in
``repro_torch.kernels.pattern`` (numpy only), so that the kernel layer,
which does not import ``repro_torch.core``, owns the one definition
that the descriptor kernels, their plain versions and the oracles share.
"""

from __future__ import annotations

from repro_torch.kernels.pattern import (ANGLE_BIN_STEP,  # noqa: F401
                                         N_ANGLE_BINS, N_PAIRS,
                                         PATCH_RADIUS, PATTERN, PATTERN_A,
                                         PATTERN_B, PATTERN_RADIUS,
                                         PATTERN_SIGMA, STEER_LUT,
                                         rotated_pattern)
