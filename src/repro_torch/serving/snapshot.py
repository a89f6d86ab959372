"""Crash-consistent service snapshots: ``FleetService`` recovery state
(port of ``repro.serving.snapshot``; the same files, byte for byte).

A host crash must not cost more than the pose-chain gap the restart
semantics already define: every OTHER piece of serving state — the
supervisor's restart ledger and flap budgets, quarantine flags,
buffered-but-unserved frames, per-rig localization memory, intake/serve
counters, the host placement map — survives byte-for-byte, so a fresh
``FleetService`` restored from the newest snapshot serves healthy rigs
BIT-EXACTLY as the uninterrupted service would have.  Poses are the one
deliberate exception: a crash is a stream gap, and a gap never chains
(the restored state keeps its descriptors/points but drops ``valid``,
so the first post-restore frame honestly reports identity +
``valid=False`` — exactly the restart rule).

Torn snapshots are a first-class input, not an error path: every leaf
is CRC-checksummed into the JSON manifest (itself a leaf), and
``load``/``restore`` walk steps newest -> oldest, skipping anything
truncated, unparseable, version-skewed or checksum-mismatched.  The
worst case of a crash DURING save is "recover from the previous step",
never "crash again on restore".

Storage rides ``repro_torch.checkpoint.store`` (atomic tmp-dir +
rename, fsync-before-rename): the snapshot tree is ``{"meta": <json as
uint8>, "leaves": [arr, ...]}`` with the manifest naming every leaf's
owner, dtype, shape and CRC.  The port's ``LocalizationState`` lives on
the session's device with its descriptors as int32 bit-views: a save
copies each field to the host and writes ``desc`` as uint32, so the
leaves, their CRCs and the manifest equal the JAX service's; a restore
views it back to int32 on the session's device.
"""

from __future__ import annotations

import collections
import json
import os
import zlib

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core.types import LocalizationState
from repro_torch.serving.queue import _Pending

SNAPSHOT_VERSION = 1

# LocalizationState field order — the per-rig leaf layout on the wire.
_STATE_FIELDS = LocalizationState._fields          # (desc, meta, points, valid)


# ---------------------------------------------------------------------------
# Rig/host ids: JSON round-trip without type laundering

def _encode_id(x) -> list:
    """Tag an id for JSON so ``1`` and ``"1"`` stay distinct rigs (the
    service accepts any hashable id; the snapshot supports the two that
    survive JSON honestly)."""
    if isinstance(x, bool) or not isinstance(x, (int, str)):
        raise TypeError(
            f"snapshot rig/host ids must be int or str, got {type(x).__name__}"
            f" ({x!r})")
    return ["int", int(x)] if isinstance(x, int) else ["str", x]


def _decode_id(pair):
    kind, v = pair
    return int(v) if kind == "int" else str(v)


# ---------------------------------------------------------------------------
# Leaf checksums

def _crc(arr: np.ndarray) -> int:
    """CRC over dtype + shape + bytes: a leaf whose contents survive but
    whose shape was reinterpreted still fails verification."""
    a = np.ascontiguousarray(arr)
    header = f"{a.dtype.str}|{a.shape}".encode()
    return zlib.crc32(a.tobytes(), zlib.crc32(header)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Capture

def _layout(service) -> dict:
    vs = service.vs
    return {"n_cameras": int(vs.rig.n_cameras),
            "n_pairs": int(vs.rig.n_pairs),
            "h": int(vs.pipe.orb.height), "w": int(vs.pipe.orb.width),
            "max_features": int(vs.pipe.orb.max_features),
            "dtype": np.dtype(service._frame_dtype).name,
            "localize": bool(vs.pipe.localize),
            "bucket_sizes": list(service.queue.cfg.bucket_sizes)}


def _host_fields(state: LocalizationState) -> list[np.ndarray]:
    """A rig's state as host arrays in ``_STATE_FIELDS`` order, ``desc``
    as the uint32 words the JAX state holds."""
    host = [getattr(state, f).detach().cpu().numpy() for f in _STATE_FIELDS]
    host[_STATE_FIELDS.index("desc")] = \
        host[_STATE_FIELDS.index("desc")].view(np.uint32)
    return host


def _device_state(fields: dict, device) -> LocalizationState:
    """A rig's host leaves back as its state on ``device``, ``desc`` as
    the int32 bit-views of the uint32 words."""
    fields = dict(fields)
    fields["desc"] = np.asarray(fields["desc"], np.uint32).view(np.int32)
    return LocalizationState(*(torch.from_numpy(np.array(fields[f])).to(device)
                               for f in _STATE_FIELDS))


def _capture(service) -> tuple[dict, list]:
    """The (manifest, leaves) pair for one service instant.  Leaf order:
    per localization rig (sorted by repr) the ``LocalizationState``
    fields, then per pending frame (queue order) images + camera_mask."""
    leaves: list[np.ndarray] = []

    sup_records = []
    for rec in service.supervisor.export_state():
        rec = dict(rec)
        rec["rig_id"] = _encode_id(rec["rig_id"])
        sup_records.append(rec)

    loc_rigs = sorted(service._loc_state, key=repr)
    for rid in loc_rigs:
        leaves.extend(_host_fields(service._loc_state[rid]))

    pending = service.queue.export_pending()
    pending_records = []
    for p in pending:
        pending_records.append({"rig_id": _encode_id(p.rig_id),
                                "t_arrival": float(p.t_arrival)})
        leaves.append(np.asarray(p.images))
        leaves.append(np.asarray(p.camera_mask))

    host_map = getattr(service, "host_map", None)
    hm = None
    if host_map is not None:
        raw = host_map.export_state()
        hm = {"hosts": [_encode_id(h) for h in raw["hosts"]],
              "down": [_encode_id(h) for h in raw["down"]],
              "assignment": [[_encode_id(r), _encode_id(h)]
                             for r, h in raw["assignment"]]}

    meta = {
        "version": SNAPSHOT_VERSION,
        "layout": _layout(service),
        "supervisor": sup_records,
        "counters": dict(service.counters),
        "queue": {"dropped_overflow": int(service.queue.dropped_overflow)},
        "loc_rigs": [_encode_id(r) for r in loc_rigs],
        "pending": pending_records,
        "host_map": hm,
        "n_leaves": len(leaves),
        "leaf_crcs": [_crc(a) for a in leaves],
    }
    return meta, leaves


def save(service, ckpt_dir: str, step: int, keep: int = 3) -> str:
    """Snapshot ``service`` as checkpoint ``step`` (atomic, fsync'd,
    keeping the newest ``keep`` steps as fallback candidates)."""
    meta, leaves = _capture(service)
    meta_arr = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    return store.save(ckpt_dir, step, {"meta": meta_arr, "leaves": leaves},
                      keep=keep)


# ---------------------------------------------------------------------------
# Load (with torn-snapshot fallback)

def _load_step(ckpt_dir: str, step: int) -> tuple[dict, list]:
    """Load + verify one step; raises on ANY inconsistency (missing or
    truncated files, bad JSON, version skew, CRC mismatch) — ``load``
    turns that into fallback."""
    flat = store.load_flat(ckpt_dir, step)
    meta = json.loads(bytes(flat["meta"]).decode())
    if meta.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {meta.get('version')} != "
                         f"{SNAPSHOT_VERSION}")
    n = int(meta["n_leaves"])
    leaves = [flat[f"leaves{store._SEP}{i}"] for i in range(n)]
    for i, (arr, want) in enumerate(zip(leaves, meta["leaf_crcs"])):
        got = _crc(arr)
        if got != int(want):
            raise ValueError(f"snapshot leaf {i} checksum mismatch "
                             f"({got:#x} != {int(want):#x})")
    return meta, leaves


def load(ckpt_dir: str) -> tuple[int, dict, list] | None:
    """The newest VERIFIABLE snapshot, walking steps newest -> oldest
    past torn/corrupt ones.  None when no step survives scrutiny."""
    for step in reversed(store.list_steps(ckpt_dir)):
        try:
            meta, leaves = _load_step(ckpt_dir, step)
        except Exception:       # noqa: BLE001 — any tear means "older step"
            continue
        return step, meta, leaves
    return None


# ---------------------------------------------------------------------------
# Restore

def restore(service, ckpt_dir: str) -> int | None:
    """Load the newest verifiable snapshot into a (fresh) ``service``.

    Returns the restored step, or None when no snapshot survived
    verification (the service then simply starts cold — never raises
    for corruption).  A LAYOUT mismatch does raise: restoring rig-A
    state into a rig-B service is a caller bug, not a torn write.

    Localization states come back on the session's device with
    ``valid`` dropped — the pose-chain gap rule: a crash is a stream
    gap, and the first frame a restored rig serves must report identity
    + ``valid=False`` exactly like a post-restart frame, not silently
    chain across the outage."""
    loaded = load(ckpt_dir)
    if loaded is None:
        return None
    step, meta, leaves = loaded

    want = _layout(service)
    if meta["layout"] != want:
        raise ValueError(
            f"snapshot layout {meta['layout']} does not match the "
            f"service layout {want} — refusing to restore across rig "
            "geometries")

    sup_records = []
    for rec in meta["supervisor"]:
        rec = dict(rec)
        rec["rig_id"] = _decode_id(rec["rig_id"])
        sup_records.append(rec)
    service.supervisor.restore_state(sup_records)

    service.counters = collections.Counter(
        {k: int(v) for k, v in meta["counters"].items()})

    i = 0
    service._loc_state = {}
    device = service.vs.device
    for enc in meta["loc_rigs"]:
        fields = dict(zip(_STATE_FIELDS, leaves[i:i + len(_STATE_FIELDS)]))
        i += len(_STATE_FIELDS)
        fields["valid"] = np.zeros_like(fields["valid"])
        service._loc_state[_decode_id(enc)] = _device_state(fields, device)

    items = []
    for rec in meta["pending"]:
        images, camera_mask = leaves[i], leaves[i + 1]
        i += 2
        items.append(_Pending(_decode_id(rec["rig_id"]), images,
                              float(rec["t_arrival"]), camera_mask))
    service.queue.restore_pending(
        items, dropped_overflow=meta["queue"]["dropped_overflow"])

    hm = meta.get("host_map")
    if hm is not None and getattr(service, "host_map", None) is not None:
        service.host_map.restore_state(
            {"hosts": [_decode_id(h) for h in hm["hosts"]],
             "down": [_decode_id(h) for h in hm["down"]],
             "assignment": [[_decode_id(r), _decode_id(h)]
                            for r, h in hm["assignment"]]})
    return step


# ---------------------------------------------------------------------------
# Deterministic corruption (fault injection / torn-write tests)

def corrupt_newest(ckpt_dir: str, leaf_index: int,
                   keep_fraction: float) -> str | None:
    """Truncate one data file of the NEWEST snapshot step — the
    reproducible stand-in for a torn write (power loss mid-flush).
    ``leaf_index`` picks among the step's ``.npy`` files (mod count, in
    sorted name order); ``keep_fraction`` of the bytes survive.
    Returns the truncated path (None when there is nothing to tear)."""
    steps = store.list_steps(ckpt_dir)
    if not steps:
        return None
    d = os.path.join(ckpt_dir, f"step_{steps[-1]:08d}")
    files = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    if not files:
        return None
    path = os.path.join(d, files[leaf_index % len(files)])
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(int(size * float(keep_fraction)))
    return path
