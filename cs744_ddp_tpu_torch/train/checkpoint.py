"""Checkpoint/resume of the training state: the reference package's
``train/checkpoint.py``, in the port's own on-disk format.

A checkpoint is ``torch.save`` of one flat ``{name: CPU tensor}`` dict,
the names of ``train/step.py::named_state_tensors`` (parameters and BN
buffers, momentum, and a stateful strategy's comm state, stacked over the
ranks as ``(world, ...)`` like the reference's), written to a temporary
file, fsynced and renamed into place, so a file under its final name is
complete.  It is read back with ``torch.load(weights_only=True)``.

    <dir>/trainer_config.json        the run's identity (the config guard)
    <dir>/epoch_<k>.pt               the state after epoch k completed
    <dir>/epoch_meta.json            the latest epoch save's sidecar
    <dir>/mid_epoch/<key>.pt         at most one emergency save, key =
                                     epoch * 10**6 + step
    <dir>/mid_epoch_meta.json        its sidecar

The listing of complete files is the source of truth (a sidecar can lag
a save by a crash between the two).  Resume is exact: the sampler is a
fixed permutation of (seed, epoch) and the augmentation is keyed by
(seed, rank, epoch, absolute batch index), so no generator state is
saved.

``STATE_FORMAT_VERSION`` is the port's own; a directory the reference
package wrote (orbax step directories, its version stamp and digest)
fails the guard and is never read.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..data.sharding import rank_data_keys

# Bumped whenever the saved names, shapes or layout change: a checkpoint
# does not survive such a change.
STATE_FORMAT_VERSION = 1

# Mid-epoch checkpoints are keyed by one integer encoding (epoch, step);
# an epoch never holds this many batches, so the encoding is
# collision-free and order-preserving.
_MID_KEY_BASE = 10 ** 6
_EPOCH_FILE = re.compile(r"epoch_(\d+)\.pt$")
_MID_FILE = re.compile(r"(\d+)\.pt$")

Tensors = Dict[str, torch.Tensor]


def _atomic_write_json(path: str, obj) -> None:
    """Complete-or-absent JSON write (tmp + rename); a preemption signal
    arriving mid-write must never leave a torn metadata file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _atomic_write_tensors(path: str, tensors: Tensors) -> None:
    """``torch.save`` of ``{name: CPU tensor}`` to a temporary file,
    fsynced, then renamed to ``path``."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            torch.save({k: v.detach().cpu() for k, v in tensors.items()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_tensors(path: str, map_location) -> Tensors:
    loaded = torch.load(path, weights_only=True, map_location=map_location)
    if not isinstance(loaded, dict) or not all(
            isinstance(k, str) and torch.is_tensor(v)
            for k, v in loaded.items()):
        raise ValueError(f"{path} does not hold a {{name: tensor}} dict")
    return loaded


def state_digest(named: Tensors) -> str:
    """Every saved tensor's name, dtype and shape, comm state excluded
    (it is per rank; the config's strategy and compress_rank pin it)."""
    return str([f"{k}:{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
                for k, v in named.items() if not k.startswith("comm/")])


def read_epoch_meta(directory: str) -> Optional[dict]:
    """The sidecar of the latest EPOCH save (world, global_batch, seed,
    reshuffle_each_epoch, rank_keys, epoch), or None."""
    path = os.path.join(os.path.abspath(directory), "epoch_meta.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def read_mid_epoch_meta(directory: str) -> Optional[dict]:
    """The mid-epoch (emergency) checkpoint's sidecar, or None."""
    path = os.path.join(os.path.abspath(directory), "mid_epoch_meta.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def validate_rank_keys(meta: Optional[dict], n: int) -> None:
    """Check a sidecar's per-rank data-order keys against a fresh
    derivation over ``n`` examples; no-op when it carries none.  Takes
    either sidecar (the mid-epoch one nests them under ``data_order``)."""
    if not meta:
        return
    flat = {k: v for k, v in meta.items() if k != "data_order"}
    flat.update(meta.get("data_order") or {})
    saved = flat.get("rank_keys")
    if not saved:
        return
    fresh = rank_data_keys(
        n, int(flat.get("world", 1)), seed=int(flat.get("seed", 0)),
        epoch=int(flat.get("epoch", 0)),
        shuffle=bool(flat.get("shuffle", True)),
        reshuffle_each_epoch=bool(flat.get("reshuffle_each_epoch", False)))
    if tuple(saved) != fresh:
        raise ValueError(
            "checkpoint data-order keys do not match this dataset/seed — "
            f"saved {tuple(saved)}, derived {fresh}; resuming would "
            "desynchronize the example stream")


def _differences(saved: dict, current: dict) -> str:
    """The keys whose values differ, as ``key: saved X, current Y`` (the
    state digest only named: it lists every tensor)."""
    out = []
    for k in sorted(set(saved) | set(current), key=str):
        a, b = saved.get(k, "<absent>"), current.get(k, "<absent>")
        if a != b:
            out.append(f"{k} differs" if k == "state_digest"
                       else f"{k}: saved {a!r}, current {b!r}")
    return "; ".join(out)


def _writer() -> bool:
    """Rank 0 (or no process group) publishes the config."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _listed(directory: str, pattern: re.Pattern) -> Dict[int, str]:
    if not os.path.isdir(directory):
        return {}
    out = {}
    for name in os.listdir(directory):
        m = pattern.fullmatch(name)
        if m:
            out[int(m.group(1))] = os.path.join(directory, name)
    return out


class CheckpointManager:
    """Checkpoints keyed on completed epochs, plus at most one mid-epoch
    (emergency) save.

    ``config`` (a small JSON-able dict: model/strategy/seed/...) is written
    beside the checkpoints and VALIDATED on construction when the directory
    already holds one: restoring another run's state would either fail on
    a shape deep in the restore or, worse, resume the wrong run; this turns
    both into an immediate, explicit error.  A rejected resume writes
    nothing.  The config is published by rank 0 only, atomically and
    exclusively (a hard link of a complete temporary file).

    Saves are written by the caller's rank 0 only; every rank may read."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 config: Optional[dict] = None):
        directory = os.path.abspath(directory)
        self._dir = directory
        self._max_to_keep = max_to_keep
        self._config_path = os.path.join(directory, "trainer_config.json")
        self._refuse_foreign_steps()
        if config is not None:
            config = {**config,
                      "state_format_version": STATE_FORMAT_VERSION}
        if config is not None and os.path.exists(self._config_path):
            with open(self._config_path) as f:
                try:
                    existing = json.load(f)
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"checkpoint dir {directory} holds a corrupt "
                        f"trainer_config.json ({e}); refusing to resume from "
                        f"an unidentifiable run — delete the directory to "
                        f"start fresh") from e
            saved_ver = existing.get("state_format_version")
            if saved_ver != STATE_FORMAT_VERSION:
                raise ValueError(
                    f"checkpoint dir {directory} holds state-format version "
                    f"{saved_ver}, but this build writes version "
                    f"{STATE_FORMAT_VERSION}; checkpoints do not survive "
                    f"changes of the saved state's structure — delete the "
                    f"directory to start fresh")
            if existing != config:
                raise ValueError(
                    f"checkpoint dir {directory} belongs to a different "
                    f"training config: {_differences(existing, config)}")
        os.makedirs(directory, exist_ok=True)
        if config is not None and not os.path.exists(self._config_path) \
                and _writer():
            self._publish_config(config)

    def _refuse_foreign_steps(self) -> None:
        """orbax keeps each step in a directory named by its number: a
        directory that holds such steps is another package's."""
        for d in (self._dir, self._mid_dir()):
            if os.path.isdir(d) and any(
                    n.isdigit() and os.path.isdir(os.path.join(d, n))
                    for n in os.listdir(d)):
                raise ValueError(
                    f"checkpoint dir {self._dir} holds step directories of "
                    f"another checkpoint format (the reference package's "
                    f"orbax layout); refusing to read or write it")

    def _publish_config(self, config: dict) -> None:
        # A complete unique temp file, hard-linked into place: the link
        # fails with FileExistsError if another run won the race, and the
        # loser then VALIDATES against the winner instead of overwriting it.
        tmp = f"{self._config_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(config, f)
        try:
            os.link(tmp, self._config_path)
        except FileExistsError:
            with open(self._config_path) as f:
                existing = json.load(f)
            if existing != config:
                raise ValueError(
                    f"checkpoint dir {self._dir} was concurrently claimed "
                    f"by a different training config: "
                    f"{_differences(existing, config)}") from None
        except OSError:
            # A filesystem without hard links: an atomic (but
            # last-writer-wins) rename.
            os.replace(tmp, self._config_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    # -- epoch saves ---------------------------------------------------------

    def latest_epoch(self) -> Optional[int]:
        """Last COMPLETED epoch saved, or None if no checkpoint exists."""
        epochs = _listed(self._dir, _EPOCH_FILE)
        return max(epochs) if epochs else None

    def save(self, epoch: int, tensors: Tensors,
             meta: Optional[dict] = None) -> None:
        """Persist the state after ``epoch`` completed; durable on return.
        ``meta``, the sidecar of the LATEST epoch save, is written after
        the checkpoint, so it never describes a save that does not exist.
        Keeps the newest ``max_to_keep`` epochs."""
        _atomic_write_tensors(
            os.path.join(self._dir, f"epoch_{epoch}.pt"), tensors)
        if meta is not None:
            _atomic_write_json(os.path.join(self._dir, "epoch_meta.json"),
                               {**meta, "epoch": epoch})
        epochs = _listed(self._dir, _EPOCH_FILE)
        for old in sorted(epochs)[:-self._max_to_keep]:
            os.unlink(epochs[old])

    def epoch_meta(self) -> Optional[dict]:
        return read_epoch_meta(self._dir)

    def mid_epoch_meta(self) -> Optional[dict]:
        return read_mid_epoch_meta(self._dir)

    def restore(self, epoch: Optional[int] = None, map_location="cpu"
                ) -> Tuple[Tensors, int]:
        """(tensors, next_epoch_to_run)."""
        epochs = _listed(self._dir, _EPOCH_FILE)
        if epoch is None:
            epoch = max(epochs) if epochs else None
        if epoch is None or epoch not in epochs:
            raise FileNotFoundError("no checkpoint to restore")
        return _load_tensors(epochs[epoch], map_location), epoch + 1

    # -- mid-epoch (emergency) saves: the preemption path (ft/) -------------

    def _mid_dir(self) -> str:
        return os.path.join(self._dir, "mid_epoch")

    def _mid_meta_path(self) -> str:
        return os.path.join(self._dir, "mid_epoch_meta.json")

    def save_mid_epoch(self, epoch: int, step: int, tensors: Tensors,
                       data_order: Optional[dict] = None) -> None:
        """Emergency checkpoint: the state after ``step`` batches of
        ``epoch``; durable on return (the caller is about to exit).  It
        replaces any earlier one."""
        if step >= _MID_KEY_BASE:
            raise ValueError(f"step {step} exceeds mid-epoch key space")
        os.makedirs(self._mid_dir(), exist_ok=True)
        key = epoch * _MID_KEY_BASE + step
        _atomic_write_tensors(os.path.join(self._mid_dir(), f"{key}.pt"),
                              tensors)
        for k, path in _listed(self._mid_dir(), _MID_FILE).items():
            if k != key:
                os.unlink(path)
        meta = {"epoch": epoch, "step": step}
        if data_order:
            meta["data_order"] = data_order
        _atomic_write_json(self._mid_meta_path(), meta)

    def latest_mid_epoch(self) -> Optional[Tuple[int, int]]:
        """(epoch, step) of the emergency checkpoint, or None."""
        keys = _listed(self._mid_dir(), _MID_FILE)
        return divmod(max(keys), _MID_KEY_BASE) if keys else None

    def restore_mid_epoch(self, map_location="cpu"
                          ) -> Tuple[Tensors, int, int]:
        """(tensors, epoch, step): resume ``epoch`` from batch ``step``."""
        keys = _listed(self._mid_dir(), _MID_FILE)
        if not keys:
            raise FileNotFoundError("no mid-epoch checkpoint to restore")
        key = max(keys)
        epoch, step = divmod(key, _MID_KEY_BASE)
        return _load_tensors(keys[key], map_location), epoch, step

    def clear_mid_epoch(self) -> None:
        """Drop the emergency checkpoint (stale once its epoch completes)."""
        if os.path.exists(self._mid_meta_path()):
            os.unlink(self._mid_meta_path())
        for path in _listed(self._mid_dir(), _MID_FILE).values():
            os.unlink(path)
