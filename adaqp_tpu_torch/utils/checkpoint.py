"""Checkpoint and resume: named arrays in ``ckpt_{epoch}.npz`` beside
``ckpt_{epoch}.json``.

The JAX package's checkpoints (``utils/checkpoint.py`` there) hold a
pytree's leaves in order; these hold one key per array
(``params.0.w``, ``opt.0.w.exp_avg``, ...), so a checkpoint says what it
holds and a mismatch names the array. Nothing is pickled: the archive
loads with ``allow_pickle=False`` and the json holds the step, each
array's shape and the caller's metadata.

Both files are replaced atomically (a temporary file in the same
directory, flushed to disk, then ``os.replace``), the archive first and
the json last: a json names a complete archive, and a crash leaves at
worst a temporary file that :func:`latest_checkpoint` does not read.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

PREFIX = "ckpt_"


def _replace(path: str, write) -> None:
    """Write a file through ``write(f)`` into a temporary file beside
    ``path``, flush it to disk and rename it over ``path``."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=f".{os.path.basename(path)}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_checkpoint(path: str, step: int, state: Mapping[str, np.ndarray],
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state`` (array name -> array) as ``path.npz`` and
    ``path.json`` (``step``, each array's shape, ``meta``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {name: np.asarray(a) for name, a in state.items()}
    info = {"step": int(step), "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "meta": meta or {}}
    _replace(path + ".npz", lambda f: np.savez(f, **arrays))
    _replace(path + ".json", lambda f: f.write(json.dumps(info).encode()))


def load_checkpoint(path: str, shapes: Optional[Mapping[str, Optional[Tuple[int, ...]]]] = None
                    ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]:
    """``(step, state, meta)`` of the checkpoint at ``path``. With
    ``shapes`` (array name -> shape, or None for any shape) the
    checkpoint must hold exactly those names at those shapes, else
    ``ValueError`` names the difference."""
    with open(path + ".json") as f:
        info = json.load(f)
    with np.load(path + ".npz", allow_pickle=False) as z:
        state = {name: z[name] for name in z.files}
    if shapes is not None:
        missing = sorted(set(shapes) - set(state))
        extra = sorted(set(state) - set(shapes))
        if missing or extra:
            raise ValueError(
                f"checkpoint {path} does not fit this run (model or config changed since "
                f"the save?): missing {missing}, unexpected {extra}")
        wrong = [f"{k} {state[k].shape} != {tuple(s)}" for k, s in shapes.items()
                 if s is not None and state[k].shape != tuple(s)]
        if wrong:
            raise ValueError(f"checkpoint {path} has other shapes: {'; '.join(wrong)}")
    return int(info["step"]), state, info.get("meta", {})


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The path (without suffix) of the highest-epoch ``ckpt_{epoch}.json``
    under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith(PREFIX) and name.endswith(".json"):
            try:
                steps.append(int(name[len(PREFIX):-len(".json")]))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"{PREFIX}{max(steps)}")
