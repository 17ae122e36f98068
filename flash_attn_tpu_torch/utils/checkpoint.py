"""Checkpoint and resume of a training state on ``torch.save``.

Port of flash_attn_tpu/utils/checkpoint.py (``save``, ``load``,
``TrainCheckpointManager``), with one file a checkpoint in place of
orbax's directories.  A tree is dicts, lists and tuples of tensors and
Python numbers: the params tree and ``utils/train.adamw_init``'s state
(its moments and count).  Keys that start with "_" hold derived caches
(the serving path's ``_lm_head_f32``) and are not saved.  A round trip
is bitwise: each tensor is written as it is and read back in its dtype.

Policy as in JAX: params and optimizer state are checkpointed; a KV
cache is rebuilt from the requests and is not.
"""

from __future__ import annotations

import os
import re

import torch


def _strip(tree):
    """``tree`` without the "_" keys of its dicts."""
    if isinstance(tree, dict):
        return {k: _strip(v) for k, v in tree.items() if not str(k).startswith("_")}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_strip(v) for v in tree)
    return tree


def _like(tree, like):
    """Each tensor of ``tree`` on the device and in the dtype of its
    counterpart in ``like`` (requiring grad where that does), walked in
    step; other leaves as loaded."""
    if isinstance(tree, dict):
        return {k: _like(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(like):
            raise ValueError(f"checkpoint has {len(tree)} items where like has {len(like)}")
        return type(tree)(_like(v, w) for v, w in zip(tree, like))
    if isinstance(tree, torch.Tensor):
        if tuple(tree.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {tuple(tree.shape)} against like "
                             f"{tuple(like.shape)}")
        # a copy, so that no restored leaf is a view of the file's mapping
        out = tree.to(device=like.device, dtype=like.dtype, copy=True)
        if like.requires_grad:
            out.requires_grad_(True)
        return out
    return tree


def save(path: str, tree, *, force: bool = True):
    """Write ``tree`` to the file ``path`` (through a temporary file and a
    rename, so a reader never sees half of it).  ``force=False`` refuses
    an existing ``path``."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with torch.no_grad():
        torch.save(_strip(tree), tmp)
    os.replace(tmp, path)


def load(path: str, like=None):
    """Read a tree that ``save`` wrote.  Without ``like`` every tensor is on
    the CPU; with ``like`` (a tree of the same structure) each goes to the
    device and dtype of its counterpart there."""
    path = os.path.abspath(path)
    tree = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return tree if like is None else _like(tree, _strip(like))


class TrainCheckpointManager:
    """Step-numbered checkpoints in ``directory``, one file a step, the
    newest ``max_to_keep`` kept."""

    _NAME = re.compile(r"^step_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list:
        """The steps on disk, oldest first."""
        found = (self._NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state):
        save(self._path(step), state)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore_latest(self, like=None):
        """(step, state) of the newest checkpoint, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, load(self._path(step), like)

    def close(self):
        """Saves are written before ``save`` returns: nothing is pending."""
