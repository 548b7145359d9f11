"""Atomic, integrity-hashed checkpoints — the port of
``repro.checkpoint.checkpoint``, in the JAX package's on-disk format, so
that a checkpoint written by either package is read by the other:

  * ``<dir>/step_%08d/`` is committed by one ``os.replace`` from a
    ``.tmp`` directory — a crash mid-write never leaves a readable but
    partial checkpoint;
  * each leaf is one ``leaf_%05d.npy``, host-resident with its full shape
    and dtype;
  * ``manifest.json`` holds ``step``, ``treedef``, ``extra`` and
    ``leaves`` (``key``, ``file``, ``shape``, ``dtype``, ``sha256``); a
    load verifies the hashes before it reads a leaf.

Leaves are flattened as ``jax.tree_util.tree_flatten_with_path`` does:
dict keys sorted, list and tuple entries by index, named-tuple and
dataclass fields as ``.name``, ``None`` holding no leaf; a key joins its
path with ``/``.  ``treedef`` holds the port's own description of the
structure (JAX's is a repr its loaders never read); restores go by key.

Tensors are copied to the host as they are; a bfloat16 tensor (which
numpy cannot hold) is written as JAX writes an ``ml_dtypes`` bfloat16
array: its 2-byte words as a ``|V2`` npy, the manifest's dtype
``bfloat16``, and a load onto a device turns it back into bfloat16.  The run state of a sampler
(words, samples, accept counts, log-probs) is saved in the JAX package's
dtypes through ``run_state``: uint32 words (the port carries them as
int64 masked to 32 bits), int32 counts, float32 log-probs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import telemetry


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    retention: int = 3
    async_save: bool = True


def _children(node):
    """(path parts, children) of an inner node of a tree, or None for a
    leaf — the JAX package's pytree rules."""
    if isinstance(node, dict):
        keys = sorted(node)
        return [str(k) for k in keys], [node[k] for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # a NamedTuple
        return [f".{f}" for f in node._fields], list(node)
    if isinstance(node, (list, tuple)):
        return [str(i) for i in range(len(node))], list(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        fields = dataclasses.fields(node)
        return [f".{f.name}" for f in fields], [getattr(node, f.name) for f in fields]
    return None


def _flatten_with_paths(tree, prefix=()):
    """[(key, leaf)] in the JAX package's order; ``None`` holds no leaf."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    items = []
    for part, child in zip(*kids):
        items.extend(_flatten_with_paths(child, (*prefix, part)))
    return items


def _describe(tree) -> str:
    """The structure of ``tree`` with its leaves as ``*`` — the manifest's
    ``treedef`` entry."""
    if tree is None:
        return "None"
    kids = _children(tree)
    if kids is None:
        return "*"
    parts, children = kids
    inner = ", ".join(_describe(c) for c in children)
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{p!r}: {_describe(c)}" for p, c in zip(parts, children)) + "}"
    if isinstance(tree, list):
        return f"[{inner}]"
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return f"({inner}{',' if len(children) == 1 else ''})"
    return f"{type(tree).__name__}({inner})"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    _, children = kids
    new = [_unflatten(c, leaves) for c in children]
    if isinstance(like, dict):
        return dict(zip(sorted(like), new))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*new)
    if isinstance(like, (list, tuple)):
        return type(like)(new)
    return dataclasses.replace(like, **{f.name: v for f, v in zip(dataclasses.fields(like), new)})


_BF16_WORDS = np.dtype("V2")  # how numpy reads back a bfloat16 npy


def _to_host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host numpy array.  A CUDA tensor is copied (which waits
    for the work that writes it); a CPU tensor or array is shared unless
    ``copy``; a bfloat16 tensor becomes its ``V2`` words."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return _to_host(leaf.view(torch.int16), copy).view(_BF16_WORDS)
        if leaf.device.type != "cpu":
            return leaf.cpu().numpy()
        return leaf.clone().numpy() if copy else leaf.numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def run_state(*, words, logp, acc, samples=None) -> dict:
    """A sampler's run state as host arrays in the JAX package's dtypes:
    uint32 ``words`` and ``samples``, float32 ``logp``, int32 ``acc`` —
    the tree ``RunHandle.save`` and ``run_resumable`` write."""
    tree = {
        "acc": _to_host(acc).astype(np.int32, copy=False),
        "logp": _to_host(logp).astype(np.float32, copy=False),
        "words": _to_host(words).astype(np.uint32),
    }
    if samples is not None:
        tree["samples"] = _to_host(samples).astype(np.uint32)
    return tree


def words_from_host(arr, device) -> torch.Tensor:
    """uint32 words (or spins) read from a checkpoint as the port's int64
    word tensor on ``device``."""
    return torch.from_numpy(np.asarray(arr).astype(np.int64)).to(device)


def _save_npy(path: str, arr: np.ndarray) -> None:
    """``np.save``, with bfloat16 words under ml_dtypes' descr (``<V2``),
    so the file is byte for byte the JAX package's."""
    if arr.dtype != _BF16_WORDS:
        np.save(path, arr, allow_pickle=False)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(arr).tobytes())


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def checkpoint_nbytes(path: str) -> int:
    """Total on-disk bytes of a committed checkpoint (leaf files +
    manifest) — what the save/restore telemetry reports."""
    total = 0
    for name in os.listdir(path):
        try:
            total += os.path.getsize(os.path.join(path, name))
        except OSError:
            pass
    return total


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomic, integrity-hashed save of a tree of arrays and tensors.

    Idempotent per step: a committed checkpoint for ``step`` is left
    untouched (re-saving the same boundary is a no-op, not a torn
    rewrite).  Returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(os.path.join(final, "manifest.json")):
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    with telemetry.span("checkpoint.save", step=step) as sp:
        items = _flatten_with_paths(tree)
        manifest = {
            "step": step,
            "treedef": _describe(tree),
            "extra": extra or {},
            "leaves": [],
        }
        nbytes = 0
        for i, (key, leaf) in enumerate(items):
            arr = _to_host(leaf)
            fname = f"leaf_{i:05d}.npy"
            fpath = os.path.join(tmp, fname)
            _save_npy(fpath, arr)
            nbytes += os.path.getsize(fpath)
            manifest["leaves"].append(
                {
                    "key": key,
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": "bfloat16" if arr.dtype == _BF16_WORDS else str(arr.dtype),
                    "sha256": _sha256(fpath),
                }
            )
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
        nbytes += os.path.getsize(mpath)
        os.replace(tmp, final)  # atomic commit
        sp.set(leaves=len(items), bytes=nbytes)
    telemetry.counter("checkpoint_bytes_written_total", "committed checkpoint bytes").inc(nbytes)
    telemetry.counter("checkpoint_saves_total", "committed checkpoint saves").inc()
    telemetry.log("checkpoint.saved", step=step, leaves=len(items), bytes=nbytes, path=final)
    return final


def latest_step(directory: str) -> int | None:
    """The newest committed step in ``directory`` (None if there is none)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _read_leaf(path: str, entry: dict, verify: bool) -> np.ndarray:
    fpath = os.path.join(path, entry["file"])
    if verify and _sha256(fpath) != entry["sha256"]:
        raise IOError(f"integrity check failed for {fpath}")
    return np.load(fpath, allow_pickle=False)


def _on_device(arr: np.ndarray, device) -> torch.Tensor:
    """A restored leaf as a tensor on ``device``; uint32 words widen to
    the port's int64 carrier, bfloat16 words are bfloat16 again."""
    if arr.dtype == np.uint32:
        return words_from_host(arr, device)
    if arr.dtype == _BF16_WORDS:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def load_checkpoint(directory: str, step: int, like_tree, device=None, verify: bool = True):
    """Restore into the structure of ``like_tree``, by key; returns
    ``(tree, manifest)``.

    ``device`` (where the JAX package takes ``shardings``) puts every leaf
    on that device as a tensor, uint32 words widened to int64; ``None``
    leaves host numpy arrays, as the JAX package does without shardings."""
    path = os.path.join(directory, f"step_{step:08d}")
    with telemetry.span("checkpoint.restore", step=step, verify=verify) as sp:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        items = _flatten_with_paths(like_tree)
        by_key = {e["key"]: e for e in manifest["leaves"]}
        leaves = []
        for key, like in items:
            entry = by_key.get(key)
            if entry is None:
                raise KeyError(f"checkpoint {path} is missing leaf {key!r}")
            arr = _read_leaf(path, entry, verify)
            if list(arr.shape) != list(np.shape(like)):
                raise ValueError(
                    f"leaf {key}: checkpoint shape {arr.shape} != expected "
                    f"{tuple(np.shape(like))} — config/checkpoint mismatch"
                )
            leaves.append(arr if device is None else _on_device(arr, device))
        sp.set(leaves=len(items), bytes=checkpoint_nbytes(path))
    return _unflatten(like_tree, iter(leaves)), manifest


def load_checkpoint_tree(directory: str, step: int, verify: bool = True):
    """Restore a checkpoint as a flat ``{key: np.ndarray}`` dict, shapes
    taken from the manifest — the resume driver's restore, since its
    accumulated sample stream grows with every segment."""
    path = os.path.join(directory, f"step_{step:08d}")
    with telemetry.span("checkpoint.restore", step=step, verify=verify) as sp:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        tree = {e["key"]: _read_leaf(path, e, verify) for e in manifest["leaves"]}
        sp.set(leaves=len(tree), bytes=checkpoint_nbytes(path))
    return tree, manifest


class CheckpointManager:
    """Retention + asynchronous writes + auto-resume.

    ``save`` copies every leaf to the host on the caller's thread before a
    writer thread starts: a CUDA tensor read from that thread could see a
    buffer the caller's next work is already writing."""

    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(cfg.directory, exist_ok=True)

    def save(self, step: int, tree, extra: dict | None = None):
        items = _flatten_with_paths(tree)
        host_tree = _unflatten(tree, iter([_to_host(leaf, copy=True) for _, leaf in items]))
        if self.cfg.async_save:
            self.wait()  # one outstanding write at a time

            def work():
                try:
                    save_checkpoint(self.cfg.directory, step, host_tree, extra)
                    self._apply_retention()
                except BaseException as e:  # surfaced on the next wait()
                    self._error = e

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.cfg.directory, step, host_tree, extra)
            self._apply_retention()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _apply_retention(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.cfg.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.cfg.retention] if self.cfg.retention > 0 else []:
            shutil.rmtree(os.path.join(self.cfg.directory, f"step_{s:08d}"), ignore_errors=True)

    def restore_latest(self, like_tree, device=None):
        """(tree, step) from the newest valid checkpoint, or (None, None)."""
        self.wait()
        step = latest_step(self.cfg.directory)
        if step is None:
            return None, None
        tree, _ = load_checkpoint(self.cfg.directory, step, like_tree, device=device)
        return tree, step
