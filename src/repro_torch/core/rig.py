"""Rig description for the `VisualSystem` session API (port of
``repro.core.rig``, numpy only).

A ``RigConfig`` captures everything the paper configures ONCE about the
camera hardware (Sec. III, Fig. 4): how many cameras there are, how they
group into stereo pairs, each camera's intrinsics, and the trigger/sync
spec (Sec. III-A).  The session (``repro_torch.core.pipeline.VisualSystem``)
is built from one ``RigConfig`` plus one ``PipelineConfig`` and then
streams frames through a fixed schedule — no per-call cfg/intr/impl
threading.

The pair layout is explicit instead of the old hard-coded "4 cameras =
2 pairs in [L, R, L, R] order": ``pairs`` is a tuple of (left, right)
camera indices, so asymmetric rigs (one stereo pair plus a mono camera,
6-camera rings, ...) describe themselves and the fleet batcher can fold
any rig shape into the kernels' flat camera/pair batch axes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sync import TriggerConfig
from repro_torch.core.types import CameraIntrinsics

_SYNC_POLICIES = ("hardware", "software")
_DESYNC_POLICIES = ("raise", "drop_frame", "degrade")


class DesyncError(RuntimeError):
    """A frame's camera time tags spread beyond the rig's tolerance.

    Raised by ``VisualSystem.process_frame`` for hardware-trigger rigs,
    whose trigger generator stamps every camera from one clock (paper
    Sec. III-A) — any nonzero spread means the sync hardware is broken
    or the tags do not come from it.  Software-sync rigs log the jitter
    instead of raising.
    """


@dataclasses.dataclass(frozen=True)
class RigConfig:
    """Static description of one camera rig.

    ``intrinsics`` may be a single ``CameraIntrinsics`` (shared by all
    cameras — the paper's quad rig) or one per camera; it is normalized
    to a per-camera tuple.  ``sync`` defaults to a ``TriggerConfig``
    with a matching camera count.  ``sync_policy`` selects the desync
    discipline ``VisualSystem.process_frame`` applies to per-frame time
    tags: ``"hardware"`` asserts the trigger-generator guarantee (spread
    <= ``max_desync``, 0.0 by default — the paper's 0-cycle desync),
    ``"software"`` only records the observed jitter.

    ``desync_policy`` selects what a spread beyond ``max_desync`` DOES:

      - ``None`` (default) — the legacy split: hardware rigs raise
        ``DesyncError``, software rigs only log the jitter.
      - ``"raise"`` — raise ``DesyncError`` (both sync policies).
      - ``"drop_frame"`` — the frame is not processed:
        ``process_frame`` returns ``None``; a fleet entry masks the
        whole offending rig out of the batch instead (shapes are
        static — a dropped rig cannot leave the fleet array).
      - ``"degrade"`` — process the frame with the offending cameras
        masked out (``sync.desync_camera_mask``: keep the cameras whose
        tags agree with the frame's median tag), so the rig degrades to
        its surviving stereo pairs instead of failing.
    """

    n_cameras: int = 4
    pairs: tuple[tuple[int, int], ...] = ((0, 1), (2, 3))
    intrinsics: tuple[CameraIntrinsics, ...] | CameraIntrinsics = \
        CameraIntrinsics()
    sync: TriggerConfig | None = None
    sync_policy: str = "hardware"
    max_desync: float = 0.0      # tolerated per-frame tag spread (s)
    desync_policy: str | None = None   # None = legacy raise/log split
    # Per-pair camera->rig rotation (the pair's LEFT camera frame into
    # the shared rig frame), as nested float tuples so the config stays
    # hashable.  None = identity for every pair (a forward-looking rig);
    # ``quad()`` sets the back pair's 180-degree yaw so the localization
    # backend fuses both pairs' 3-D points into ONE rig-frame solve.
    pair_rotations: tuple | None = None

    def __post_init__(self):
        if self.n_cameras < 1:
            raise ValueError(f"n_cameras must be >= 1, got {self.n_cameras}")
        if isinstance(self.intrinsics, CameraIntrinsics):
            object.__setattr__(self, "intrinsics",
                               (self.intrinsics,) * self.n_cameras)
        else:
            object.__setattr__(self, "intrinsics", tuple(self.intrinsics))
        if len(self.intrinsics) != self.n_cameras:
            raise ValueError(
                f"got {len(self.intrinsics)} intrinsics for "
                f"{self.n_cameras} cameras")
        pairs = tuple((int(l), int(r)) for l, r in self.pairs)
        object.__setattr__(self, "pairs", pairs)
        if not pairs:
            raise ValueError("a rig needs at least one stereo pair")
        for l, r in pairs:
            if not (0 <= l < self.n_cameras and 0 <= r < self.n_cameras):
                raise ValueError(
                    f"pair ({l}, {r}) references a camera outside "
                    f"[0, {self.n_cameras})")
            if l == r:
                raise ValueError(f"pair ({l}, {r}) uses one camera twice")
        if self.sync is None:
            object.__setattr__(self, "sync",
                               TriggerConfig(n_cameras=self.n_cameras))
        if self.sync.n_cameras != self.n_cameras:
            raise ValueError(
                f"sync.n_cameras={self.sync.n_cameras} does not match "
                f"rig n_cameras={self.n_cameras}")
        if self.sync_policy not in _SYNC_POLICIES:
            raise ValueError(
                f"sync_policy must be one of {_SYNC_POLICIES}, "
                f"got {self.sync_policy!r}")
        if self.desync_policy not in (None,) + _DESYNC_POLICIES:
            raise ValueError(
                "desync_policy must be None or one of "
                f"{_DESYNC_POLICIES}, got {self.desync_policy!r}")
        if self.max_desync < 0.0:
            raise ValueError(f"max_desync must be >= 0, got {self.max_desync}")
        if self.pair_rotations is not None:
            rots = np.asarray(self.pair_rotations, dtype=np.float64)
            if rots.shape != (len(pairs), 3, 3):
                raise ValueError(
                    f"pair_rotations shape {rots.shape} does not match "
                    f"({len(pairs)}, 3, 3) — one camera->rig rotation "
                    "per stereo pair")
            for i, r in enumerate(rots):
                if not np.allclose(r @ r.T, np.eye(3), atol=1e-6):
                    raise ValueError(
                        f"pair_rotations[{i}] is not a rotation matrix "
                        "(R @ R.T != I)")
            object.__setattr__(
                self, "pair_rotations",
                tuple(tuple(tuple(float(v) for v in row) for row in r)
                      for r in rots))

    # -- layout views ------------------------------------------------------

    @property
    def n_pairs(self) -> int:
        return len(self.pairs)

    @property
    def left_cams(self) -> tuple[int, ...]:
        return tuple(l for l, _ in self.pairs)

    @property
    def right_cams(self) -> tuple[int, ...]:
        return tuple(r for _, r in self.pairs)

    @property
    def pair_intrinsics(self) -> tuple[CameraIntrinsics, ...]:
        """Per-pair intrinsics (the pair's LEFT camera drives the
        disparity -> depth conversion)."""
        return tuple(self.intrinsics[l] for l in self.left_cams)

    @property
    def homogeneous_intrinsics(self) -> bool:
        return all(ic == self.intrinsics[0] for ic in self.intrinsics[1:])

    def pair_rotation_array(self) -> np.ndarray:
        """(n_pairs, 3, 3) float32 camera->rig rotations (identity rows
        when ``pair_rotations`` is None) — the layout the localization
        backend folds every pair's 3-D points through."""
        if self.pair_rotations is None:
            return np.broadcast_to(np.eye(3, dtype=np.float32),
                                   (self.n_pairs, 3, 3)).copy()
        return np.asarray(self.pair_rotations, dtype=np.float32)

    def pair_mask(self, camera_mask):
        """Per-pair validity from a per-camera validity mask: a stereo
        pair survives iff BOTH of its cameras are alive.  ``camera_mask``
        is (..., n_cameras) bool; returns (..., n_pairs) bool — the
        degraded-rig rule ``process_frame(camera_mask=...)`` applies."""
        m = np.asarray(camera_mask, dtype=bool)
        if m.shape[-1] != self.n_cameras:
            raise ValueError(
                f"camera_mask last axis is {m.shape[-1]} but the rig "
                f"has {self.n_cameras} cameras")
        return (m[..., list(self.left_cams)]
                & m[..., list(self.right_cams)])

    # -- constructors ------------------------------------------------------

    @classmethod
    def quad(cls, intrinsics: CameraIntrinsics = CameraIntrinsics(),
             **kwargs) -> "RigConfig":
        """The paper's rig: 4 cameras, front pair (0, 1) + back pair
        (2, 3), one shared set of intrinsics.  The back pair looks along
        -z (180-degree yaw — ``data.scenes.camera_poses``), so its
        camera->rig rotation is the xz flip; callers may override
        ``pair_rotations`` for a different physical layout."""
        kwargs.setdefault(
            "pair_rotations",
            (((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
             ((-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, -1.0))))
        return cls(n_cameras=4, pairs=((0, 1), (2, 3)),
                   intrinsics=intrinsics, **kwargs)

    @classmethod
    def stereo(cls, intrinsics: CameraIntrinsics = CameraIntrinsics(),
               **kwargs) -> "RigConfig":
        """A single stereo pair (cameras 0 = left, 1 = right)."""
        return cls(n_cameras=2, pairs=((0, 1),), intrinsics=intrinsics,
                   **kwargs)
