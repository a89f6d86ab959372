"""Host-side frame queue: async rig arrivals -> bucketed fleet batches
(port of ``repro.serving.queue``).

``VisualSystem.process_fleet`` takes one ``(n_rigs, C, H, W)`` batch a
call.  Real rigs arrive one at a time with jitter, so the queue
coalesces: frames accumulate until a full largest bucket is pending or
the oldest frame hits its deadline, then the batch is padded up to the
smallest configured bucket size.  The JAX session compiles one graph a
fleet size, so the buckets bound its retraces; the port runs eagerly,
and the buckets keep the same closed set of batch shapes (and the same
batches, so a port episode replays the JAX one).  Padding rigs carry
zero images and an all-False camera mask, so the masked fleet path
gates all their validity off, and the batch is still 3 launches.

``next_batch`` allocates the padded batch on the session's device and
copies each pending frame into its row (padding rows are zeroed there),
so ``FleetBatch.images`` is a tensor the session reads in place and no
host-side batch is built.

The queue is intentionally dumb about WHY a camera mask is partial or a
frame late: fault detection, desync policy and health tracking live in
``service``/``supervisor``; this module only does shape-checked
buffering and bucketing.
"""

from __future__ import annotations

import collections
import dataclasses
import typing
import warnings

import numpy as np
import torch

from repro_torch.core.rig import RigConfig


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    """``bucket_sizes`` is the closed set of fleet sizes ever dispatched
    (sorted ascending at validation); ``deadline_s`` is how long a frame
    may wait before the queue declares the batch ready anyway (and flags
    the frame ``late``); ``max_pending_per_rig`` bounds per-rig buffering
    — a streaming consumer wants the freshest frames, so the OLDEST
    frame of an over-buffered rig is dropped (counted, never silent)."""

    bucket_sizes: tuple[int, ...] = (1, 2, 4, 8)
    deadline_s: float = 0.05
    max_pending_per_rig: int = 2

    def __post_init__(self):
        sizes = tuple(sorted(int(b) for b in self.bucket_sizes))
        if not sizes or sizes[0] < 1:
            raise ValueError(
                f"bucket_sizes must be >= 1, got {self.bucket_sizes}")
        if len(set(sizes)) != len(sizes):
            raise ValueError(
                f"bucket_sizes has duplicates: {self.bucket_sizes}")
        object.__setattr__(self, "bucket_sizes", sizes)
        if self.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {self.deadline_s}")
        if self.max_pending_per_rig < 1:
            raise ValueError(
                f"max_pending_per_rig must be >= 1, "
                f"got {self.max_pending_per_rig}")


class _Pending(typing.NamedTuple):
    rig_id: typing.Any
    images: np.ndarray          # (C, H, W) in the queue's dtype
    t_arrival: float
    camera_mask: np.ndarray     # (C,) bool


class FleetBatch(typing.NamedTuple):
    """One bucketed fleet frame ready for ``process_fleet``.

    ``images`` is a ``(B, C, H, W)`` tensor on the queue's device with
    ``B`` in ``bucket_sizes``; ``rig_mask[b]`` says whether row ``b`` is
    a real rig (padding rows are all-False in ``camera_mask`` too);
    ``rig_ids``/``late`` cover only the real rows (length
    ``rig_mask.sum()``)."""

    images: torch.Tensor
    camera_mask: np.ndarray     # (B, C) bool
    rig_ids: tuple
    rig_mask: np.ndarray        # (B,) bool
    late: np.ndarray            # (n_real,) bool
    t_arrivals: tuple           # (n_real,) per-frame arrival times
    t_oldest: float

    @property
    def n_real(self) -> int:
        return int(self.rig_mask.sum())


class FrameQueue:
    """FIFO of shape-validated rig frames with bucketed draining.

    ``dtype`` is the frames' storage type (np.uint8 for a session on the
    integer datapath, else float32); ``device`` is where ``next_batch``
    puts the batch (the card unless the caller asks for the CPU)."""

    def __init__(self, rig: RigConfig, frame_hw: tuple[int, int],
                 cfg: QueueConfig | None = None,
                 dtype=np.float32,
                 device: str | torch.device = "cuda") -> None:
        self.rig = rig
        self.frame_hw = (int(frame_hw[0]), int(frame_hw[1]))
        self.cfg = cfg if cfg is not None else QueueConfig()
        self.dtype = np.dtype(dtype)
        self._torch_dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        self.device = torch.device(device)
        self._pending: collections.deque[_Pending] = collections.deque()
        self.dropped_overflow = 0     # oldest-frame drops from over-buffering

    # -- intake ------------------------------------------------------------

    def put(self, rig_id, images, t_arrival: float,
            camera_mask=None) -> None:
        """Validate one rig frame eagerly and buffer it (without a copy
        when it already has the queue's dtype).

        ``images``: (n_cameras, H, W); shape mismatches fail HERE with
        the expected shape spelled out, not after the batch is padded.
        ``camera_mask`` defaults to all-True."""
        im = np.asarray(images, dtype=self.dtype)
        want = (self.rig.n_cameras,) + self.frame_hw
        if im.shape != want:
            raise ValueError(
                f"FrameQueue.put(rig_id={rig_id!r}): frame shape "
                f"{im.shape} does not match the queue's rig layout "
                f"{want} (n_cameras, H, W)")
        if camera_mask is None:
            mask = np.ones(self.rig.n_cameras, dtype=bool)
        else:
            mask = np.asarray(camera_mask, dtype=bool)
            if mask.shape != (self.rig.n_cameras,):
                raise ValueError(
                    f"FrameQueue.put(rig_id={rig_id!r}): camera_mask "
                    f"shape {mask.shape} does not match "
                    f"({self.rig.n_cameras},)")
        mine = [p for p in self._pending if p.rig_id == rig_id]
        if len(mine) >= self.cfg.max_pending_per_rig:
            self._pending.remove(mine[0])     # oldest of THIS rig
            self.dropped_overflow += 1
        self._pending.append(_Pending(rig_id, im, float(t_arrival), mask))

    # -- snapshot ----------------------------------------------------------

    def export_pending(self) -> list[_Pending]:
        """The buffered-but-unserved frames, oldest first: what a
        service snapshot must keep, or a restored run drops frames that
        ``submit`` accepted."""
        return list(self._pending)

    def restore_pending(self, items, dropped_overflow: int = 0) -> None:
        """Replace the pending buffer.  Each frame re-enters through
        ``put``, so a corrupt snapshot cannot smuggle a bad shape past
        the eager validation."""
        self._pending.clear()
        for p in items:
            self.put(p.rig_id, p.images, p.t_arrival,
                     camera_mask=p.camera_mask)
        self.dropped_overflow = int(dropped_overflow)

    # -- draining ----------------------------------------------------------

    def pending(self) -> int:
        return len(self._pending)

    def oldest_wait(self, now: float) -> float:
        if not self._pending:
            return 0.0
        return float(now) - min(p.t_arrival for p in self._pending)

    def ready(self, now: float) -> bool:
        """A batch is worth dispatching when a full largest-bucket is
        pending (throughput) or the oldest frame hit its deadline
        (latency)."""
        if not self._pending:
            return False
        return (len(self._pending) >= self.cfg.bucket_sizes[-1]
                or self.oldest_wait(now) >= self.cfg.deadline_s)

    def next_batch(self, now: float, force: bool = False
                   ) -> FleetBatch | None:
        """Drain up to one largest-bucket of frames (oldest first) into
        a padded ``FleetBatch`` on the queue's device; None when not
        ``ready`` (pass ``force=True`` to flush regardless, e.g. at
        episode end)."""
        if not (force or self.ready(now)):
            return None
        if not self._pending:
            return None
        take = min(len(self._pending), self.cfg.bucket_sizes[-1])
        frames = [self._pending.popleft() for _ in range(take)]
        bucket = next(b for b in self.cfg.bucket_sizes if b >= take)

        c, (h, w) = self.rig.n_cameras, self.frame_hw
        images = torch.empty((bucket, c, h, w), dtype=self._torch_dtype,
                             device=self.device)
        images[take:].zero_()
        camera_mask = np.zeros((bucket, c), dtype=bool)
        rig_mask = np.zeros(bucket, dtype=bool)
        deadline = self.cfg.deadline_s
        late = np.asarray([float(now) - p.t_arrival > deadline
                           for p in frames], dtype=bool)
        with warnings.catch_warnings():
            # ``copy_`` only reads the frame, so a read-only one is fine
            warnings.filterwarnings("ignore", "The given NumPy array is "
                                    "not writable", UserWarning)
            for b, p in enumerate(frames):
                images[b].copy_(torch.from_numpy(p.images))
                camera_mask[b] = p.camera_mask
                rig_mask[b] = True
        return FleetBatch(
            images=images,
            camera_mask=camera_mask,
            rig_ids=tuple(p.rig_id for p in frames), rig_mask=rig_mask,
            late=late, t_arrivals=tuple(p.t_arrival for p in frames),
            t_oldest=min(p.t_arrival for p in frames))
