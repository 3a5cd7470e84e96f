"""Checkpoint / resume for learning runs and codec state.

The reference has no checkpointing (SURVEY.md §5); its only persistence is
writing D/A/E as PBM images (bsvd_test.cpp:123-125).  Here: versioned,
atomic, self-contained npz checkpoints of packed arrays + training
metadata — enough to resume a BSVD/MDL sweep mid-run.

A copy of ``binary_image_compression_tpu/utils/checkpoint.py``, with the
same files (``<path>.npz`` and the ``<path>.meta.json`` sidecar), so a
checkpoint written by either package restores in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save(path: str, arrays: dict, meta: dict | None = None) -> None:
    """Atomic checkpoint write (npz + json sidecar)."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, path + ".npz")
    with open(path + ".meta.json.tmp", "w") as f:
        json.dump(meta or {}, f)
    os.replace(path + ".meta.json.tmp", path + ".meta.json")


def restore(path: str) -> tuple[dict, dict]:
    """Returns (arrays, meta); raises FileNotFoundError if absent."""
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return arrays, meta


def latest_step(directory: str, prefix: str = "ckpt_") -> int | None:
    """Highest step number among `{prefix}{step}.npz` files, or None."""
    best = None
    if not os.path.isdir(directory):
        return None
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                step = int(name[len(prefix):-4])
            except ValueError:
                continue
            best = step if best is None else max(best, step)
    return best


def save_bsvd(path: str, E, D, A, step: int, config: dict) -> None:
    save(path, {"E": E, "D": D, "A": A},
         {"step": step, "config": config, "kind": "bsvd"})


def restore_bsvd(path: str):
    arrays, meta = restore(path)
    return arrays["E"], arrays["D"], arrays["A"], meta
