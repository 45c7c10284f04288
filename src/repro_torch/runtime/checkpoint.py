"""Checkpoints in the reference's on-disk format — the port of
`repro/runtime/checkpoint.py`.

Layout:
    <dir>/step_<N>/manifest.json      {step, leaves {name: shape, dtype},
                                       checksums, extra}
    <dir>/step_<N>/shard_<host>.npz   the leaves (single-host: shard_0)

Leaf names are the reference's `_flatten` names (`tree.tree_flatten_with_
names`): `.params/embed`, `.opt/.m/blocks/pos0/ffn/wd`, `.opt/.step`,
`.step`, `.loss_scale`, … — so a reference-saved f32 `TrainState` restores
into the port's, and the port's into the reference's.

bfloat16 leaves: the reference writes ml_dtypes' bfloat16, which `np.load`
returns as the 2-byte void type `|V2`. The port writes its bf16 tensors as
the same `|V2` bytes and reads any `|V2` leaf as uint16 bits viewed as
`torch.bfloat16`, so bf16 checkpoints round-trip port to port. (The
reference cannot restore them: its `astype(bfloat16)` has no cast from
`|V2` — a reference gap, ROADMAP.)

Fault-tolerance contract, as the reference's: atomic publish (write to
step_<N>.tmp, rename when complete); `latest_step` skips unpublished and
malformed directories; a CRC32 per shard in the manifest, verified by
`restore`, which raises `CheckpointCorrupt` for an explicit step and falls
back to the newest step that verifies otherwise; `CheckpointManager`
snapshots to host memory synchronously, writes on a thread, surfaces a
failed save on the next `wait()` and only garbage-collects after a good
save.

Sharded trees (DTensor leaves, `distributed.sharding`): `save` gathers each
leaf with `full_tensor()` on every rank (a collective), rank 0 writes the
one host shard in the same format, and every rank waits at a barrier until
it is published. `restore` places each leaf as its template leaf is placed
(a sharded template restores sharded), or with `shardings=` (a tree of
`sharding.P` specs) on the active mesh — the reference's elastic re-mesh: a
checkpoint saved on one mesh restores onto another.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.tree import tree_flatten_with_names, tree_unflatten_like

__all__ = [
    "save",
    "restore",
    "latest_step",
    "valid_steps",
    "verify_step",
    "CheckpointCorrupt",
    "CheckpointManager",
]

_BF16_BYTES = np.dtype("V2")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification (torn write, bit flip,
    missing shard). Raised by `restore`; `run_resilient` treats it like any
    other retryable failure and falls back to an older step."""


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf and the dtype name the manifest records."""
    if is_dtensor(leaf):
        leaf = leaf.detach().full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)  # a snapshot, never a view of live state
        if t.dtype == torch.bfloat16:  # the reference's bytes: |V2 on load
            return t.view(torch.int16).numpy().view(_BF16_BYTES), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {name: _to_numpy(leaf) for name, leaf in tree_flatten_with_names(tree)}


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A fresh tensor in torch's own allocation (the CPU's BLAS may take
    another code path — and round differently — on numpy's alignment),
    placed as `like` is when it is a DTensor."""
    arr = np.asarray(arr, order="C")
    if arr.dtype == _BF16_BYTES:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        t = t.to(device=like.device_mesh.device_type, dtype=like.dtype, copy=True)
        return distribute_tensor(t, like.device_mesh, like.placements)
    return t.to(device=like.device, dtype=like.dtype, copy=True)


def _sharded(tree) -> bool:
    """Does the tree hold DTensor leaves (a save every rank joins)?"""
    return tree is not None and any(is_dtensor(x) for _, x in tree_flatten_with_names(tree))


def _writes() -> bool:
    """Rank 0 writes a sharded checkpoint; the others only gather."""
    import torch.distributed as dist

    return dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


def _unflatten(tree_like, flat: Dict[str, np.ndarray]):
    named = tree_flatten_with_names(tree_like)
    out = []
    for name, leaf in named:
        if name not in flat:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = flat[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs expected {tuple(leaf.shape)}"
            )
        out.append(_from_numpy(arr, leaf))
    extra = sorted(set(flat) - {name for name, _ in named})
    if extra:
        raise ValueError(
            f"checkpoint has {len(extra)} leaves the target structure does not: "
            f"{extra[:5]}{'…' if len(extra) > 5 else ''}"
        )
    return tree_unflatten_like(tree_like, out)


def _crc32_file(path: str) -> str:
    crc = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(block, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def _write(ckpt_dir: str, step: int, flat, extra, host_index: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    checksums: Dict[str, str] = {}
    if flat is not None:
        shard = f"shard_{host_index}.npz"
        np.savez(os.path.join(tmp, shard), **{k: arr for k, (arr, _) in flat.items()})
        checksums[shard] = _crc32_file(os.path.join(tmp, shard))
    manifest = {
        "step": int(step),
        "leaves": {k: {"shape": list(arr.shape), "dtype": dt}
                   for k, (arr, dt) in (flat or {}).items()},
        "checksums": checksums,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[Dict[str, Any]] = None,
         host_index: int = 0) -> str:
    """Write a checkpoint. `tree=None` writes a metadata-only checkpoint
    (manifest + `extra`, no array shards). A sharded tree is gathered on
    every rank, written by rank 0, and published before any rank returns."""
    flat = _flatten(tree) if tree is not None else None
    if not _sharded(tree):
        return _write(ckpt_dir, step, flat, extra, host_index)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        if _writes():
            path = _write(ckpt_dir, step, flat, extra, host_index)
    finally:
        _barrier()
    return path


def _step_dirs(ckpt_dir: str) -> List[int]:
    """Published step numbers under `ckpt_dir`, ascending. Malformed
    `step_*` names (step_backup, step_old…) are skipped, not fatal."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        try:
            n = int(d[len("step_"):])
        except ValueError:
            continue
        if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(n)
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _step_dirs(ckpt_dir)
    return steps[-1] if steps else None


def verify_step(ckpt_dir: str, step: int) -> bool:
    """True iff step exists and every manifest-listed shard matches its
    recorded CRC32. Pre-checksum checkpoints (no `checksums` key) verify
    as long as the manifest parses."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    for shard, crc in manifest.get("checksums", {}).items():
        path = os.path.join(d, shard)
        if not os.path.exists(path) or _crc32_file(path) != crc:
            return False
    return True


def valid_steps(ckpt_dir: str) -> List[int]:
    """Published steps that pass integrity verification, ascending."""
    return [s for s in _step_dirs(ckpt_dir) if verify_step(ckpt_dir, s)]


def restore(ckpt_dir: str, tree_like, *, step: Optional[int] = None, shardings=None,
            verify: bool = True) -> Tuple[Any, Dict[str, Any]]:
    """Load into the structure, dtypes and devices of `tree_like` (a
    DTensor leaf: its mesh and placements). `shardings` (a tree of
    `sharding.P` specs shaped like `tree_like`) re-places every leaf on the
    active sharding context's mesh instead: the elastic re-mesh.
    `tree_like=None` loads only the manifest `extra`.

    With `verify=True` (default) shard checksums are validated first: an
    explicit `step` that fails raises `CheckpointCorrupt`; `step=None`
    falls back to the newest step that verifies."""
    if step is None:
        candidates = _step_dirs(ckpt_dir)
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        if verify:
            good = [s for s in candidates if verify_step(ckpt_dir, s)]
            if not good:
                raise CheckpointCorrupt(
                    f"no checkpoint under {ckpt_dir} passes verification "
                    f"(candidates: {candidates})"
                )
            step = good[-1]
        else:
            step = candidates[-1]
    elif verify and not verify_step(ckpt_dir, step):
        raise CheckpointCorrupt(f"checkpoint step {step} under {ckpt_dir} is corrupt")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if tree_like is None:
        return None, manifest["extra"]
    flat: Dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(d)):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(d, fn)) as z:
                flat.update({k: z[k] for k in z.files})
    tree = _unflatten(tree_like, flat)
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute_tree

        tree = distribute_tree(tree, shardings)
    return tree, manifest["extra"]


class CheckpointManager:
    """Async saver: snapshot to host memory synchronously, write on a daemon
    thread. A failed background save is re-raised on the next `wait()` (or
    the implicit one at the head of `save_async()`), and garbage collection
    only follows a successful save."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3, host_index: int = 0):
        self.dir = ckpt_dir
        self.keep = keep
        self.host_index = host_index
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, *, extra=None):
        """A sharded tree is gathered on every rank and written by rank 0
        alone (its `wait()` is where the save is known published)."""
        self.wait()  # one in-flight save at a time
        flat = _flatten(tree)  # the host copy: training may go on at once
        if _sharded(tree) and not _writes():
            return

        def work():
            try:
                _write(self.dir, step, flat, extra, self.host_index)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in _step_dirs(self.dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)
