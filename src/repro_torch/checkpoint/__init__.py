"""Atomic checkpoint store (port of ``repro.checkpoint``): the part the
service snapshots use.  ``save_async``, ``restore_array_tree`` and
``restore`` come with the LM stack (ROADMAP A14)."""

from repro_torch.checkpoint.store import (latest_step, list_steps, load_flat,
                                          save)

__all__ = ["latest_step", "list_steps", "load_flat", "save"]
