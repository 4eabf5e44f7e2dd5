"""Block-wise execution with checkpoint/resume.

Counterpart of ``memento_tpu/utils/blocks.py``: the tests' items (genes or
gene pairs) run in blocks, each block's results are saved as ``.npz`` as
soon as it completes, and a later call skips the finished blocks, so a crash
resumes where it left off.  Every block file carries the run's fingerprint
(``__meta__``); a block written by another run raises instead of being
concatenated into this one.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np


def _block_path(checkpoint_dir: str, name: str, idx: int) -> str:
    return os.path.join(checkpoint_dir, f"{name}_block{idx:05d}.npz")


def _check_meta(path: str, saved: str, expected: dict) -> None:
    got = json.loads(saved)
    if got != expected:
        diffs = sorted(
            k for k in set(got) | set(expected) if got.get(k) != expected.get(k)
        )
        raise ValueError(
            f"checkpoint {path} was written by a different run "
            f"(mismatched: {diffs}). Resuming would silently misassign "
            "results; delete the checkpoint dir (or call clear_checkpoints) "
            "to recompute."
        )


def run_blocks(
    n_items: int,
    block_size: int,
    run_block: Callable[[int, int], Dict[str, np.ndarray]],
    checkpoint_dir: Optional[str] = None,
    name: str = "ht",
    verbose: bool = False,
    meta: Optional[dict] = None,
    resume_filter: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """Run ``run_block(start, stop)`` over blocks with resume support.

    Args:
      n_items: total genes / pairs.
      block_size: items per block.
      run_block: computes a dict of per-item arrays (first axis = items in
        the block).
      checkpoint_dir: if given, each block is saved there and finished
        blocks are loaded instead of recomputed.
      meta: JSON-serializable run fingerprint (seed, num_boot, item-list
        hash, ...), saved inside every block; a resumed block whose saved
        fingerprint differs raises (blocks are keyed by index only).
      resume_filter: receives the bool vector of block files found on disk
        and returns the blocks to resume; the others are recomputed and
        written again (a multi-process run passes the intersection over its
        processes).

    Returns:
      dict of concatenated arrays over all items.
    """
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)

    full_meta = dict(meta or {})
    full_meta["n_items"] = int(n_items)
    full_meta["block_size"] = int(block_size)

    starts = list(range(0, n_items, block_size))
    if checkpoint_dir is not None:
        resumable = np.array([
            os.path.exists(_block_path(checkpoint_dir, name, bi))
            for bi in range(len(starts))
        ])
        if resume_filter is not None:
            resumable = np.asarray(resume_filter(resumable), bool)
    else:
        resumable = np.zeros(len(starts), bool)

    pieces = []
    for bi, start in enumerate(starts):
        stop = min(start + block_size, n_items)
        block_meta = dict(full_meta, start=start, stop=stop)
        path = _block_path(checkpoint_dir, name, bi) if checkpoint_dir else None
        if path is not None and resumable[bi]:
            with np.load(path) as z:
                block = {k: z[k] for k in z.files}
            saved = block.pop("__meta__", None)
            if saved is None:
                raise ValueError(
                    f"checkpoint {path} has no run metadata; delete the "
                    "checkpoint dir to recompute."
                )
            _check_meta(path, str(saved), block_meta)
            if verbose:
                print(f"[blocks] resumed block {bi} ({start}:{stop})")
        else:
            block = run_block(start, stop)
            if path is not None:
                # write aside, then rename: a crash never leaves half a block
                tmp = path + ".tmp"
                np.savez(tmp, __meta__=json.dumps(block_meta), **block)
                os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                           path)
            if verbose:
                print(f"[blocks] computed block {bi} ({start}:{stop})")
        pieces.append(block)

    keys = pieces[0].keys() if pieces else []
    return {k: np.concatenate([p[k] for p in pieces], axis=0) for k in keys}


def clear_checkpoints(checkpoint_dir: str, name: str = "ht") -> int:
    """Remove saved blocks; returns the number deleted."""
    n = 0
    if not os.path.isdir(checkpoint_dir):
        return 0
    for f in os.listdir(checkpoint_dir):
        if f.startswith(f"{name}_block") and f.endswith(".npz"):
            os.remove(os.path.join(checkpoint_dir, f))
            n += 1
    return n


__all__ = ["run_blocks", "clear_checkpoints"]
