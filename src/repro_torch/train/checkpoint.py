"""Checkpoints of the training state (counterpart of
``repro.train.checkpoint``).

 * tensors are copied from the device to numpy when ``save`` is called
   (the train step updates parameters in place, so the snapshot cannot
   wait), bf16 as f32 (exact), and come back on the device and in the
   dtype of the ``like`` state given to ``restore``;
 * the state is a tree of dicts, NamedTuples (``TrainState``, ``OptState``,
   ``IVFIndex``, ``LSHIndex``; their int fields come back as ints), lists,
   tensors, numbers and ``torch.Generator``s (saved as ``get_state()``,
   restored into a new generator on the ``like`` one's device), so an
   estimator's index and the training generator round-trip bit for bit;
 * writes are atomic (a tmp dir published by ``os.replace``), so a failure
   mid-write never corrupts the latest complete checkpoint; ``all_steps``
   skips a step directory without its manifest;
 * an optional writer thread overlaps the file write with training;
 * keep-last-K garbage collection;
 * the manifest holds the step, a fingerprint of the configuration
   (``config_fingerprint``) and the data iterator's state, so a resume
   neither replays nor skips a batch, and ``restore(config=...)`` refuses a
   checkpoint of another configuration;
 * a sharded state (``train_loop.init_train_state(mesh=)``) is saved whole:
   ``save(shardings=)`` gathers every sharded leaf on every rank, rank 0
   writes and the others wait at a barrier; ``restore(shardings=)`` reads
   on every rank and keeps the rank's slices, so a checkpoint saved at one
   mesh shape restores at another or on one device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..launch.mesh import gather_leaf, shard_leaf


def config_fingerprint(*configs) -> str:
    """SHA-256 of the configurations' fields (dataclasses, in order)."""
    text = json.dumps([dataclasses.asdict(c) for c in configs],
                      sort_keys=True, default=str)
    return hashlib.sha256(text.encode()).hexdigest()


def _flatten(tree, prefix=""):
    out = {}
    if tree is None:                          # absent optional state (the
        return out                            # index of a dense loss)
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):            # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Generator):
        return v.get_state().numpy().copy()
    if torch.is_tensor(v):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()                     # npz-safe; restore casts back
        return t.cpu().numpy().copy()
    return np.asarray(v)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: Any, extra: Dict[str, Any] = None, *,
             config: Optional[str] = None,
             data_state: Optional[Dict[str, Any]] = None,
             shardings: Any = None) -> None:
        """Snapshot ``state`` at ``step``: the tensors are copied to the
        host now, the files written now or, if async, by a writer thread.
        ``config`` is a ``config_fingerprint``; ``data_state`` the data
        iterator's ``DataState.to_dict()``. ``shardings`` (the state's
        placements, ``train_loop.state_shardings``; every rank of the mesh
        calls ``save``) gathers each sharded leaf whole, one at a time;
        rank 0 writes, at once, and every rank returns after the write."""
        places = _flatten(shardings)
        sharded = bool(places)
        writer = not sharded or _rank() == 0
        arrays = {}
        for k, v in _flatten(state).items():
            if k in places:
                v = gather_leaf(v, places[k])
            if writer:
                arrays[k.replace("/", "__")] = _to_numpy(v)
        manifest = {"step": int(step), "time": time.time(),
                    "keys": sorted(arrays), "config": config,
                    "data": data_state, "extra": extra or {}}
        self.wait()                           # one writer at a time
        if sharded:
            if writer:
                self._write(step, arrays, manifest)
            import torch.distributed as dist
            dist.barrier()
        elif self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, manifest),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, manifest)

    def _write(self, step: int, arrays, manifest) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                # a directory without manifest.json is a torn write
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like: Any, *,
                config: Optional[str] = None, device=None,
                shardings: Any = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like``: each tensor in its
        dtype, on its device (or on ``device``), each int field as an int,
        each generator as a new generator. ``step`` None takes the latest.
        Raises if ``config`` is given and differs from the saved one.
        ``shardings`` (placements in ``like``'s structure,
        ``train_loop.state_shardings``) keeps this rank's slice of each
        sharded leaf: the elastic restart's reshard onto the current
        mesh."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if config is not None and manifest.get("config") != config:
            raise ValueError(
                f"checkpoint {path} was saved under configuration "
                f"{manifest.get('config')}, not {config}")
        dev = None if device is None else resolve_device(device)
        places = _flatten(shardings)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            vals = {}
            for k, ref in _flatten(like).items():
                arr = data[k.replace("/", "__")]
                if k in places:
                    arr = shard_leaf(torch.from_numpy(arr), places[k]).numpy()
                vals[k] = _from_numpy(arr, ref, dev)
        return _unflatten_like(like, vals), manifest


def _from_numpy(arr: np.ndarray, ref, dev):
    if isinstance(ref, torch.Generator):
        g = torch.Generator(device=ref.device if dev is None else dev)
        g.set_state(torch.from_numpy(arr.copy()))
        return g
    if torch.is_tensor(ref):
        t = torch.from_numpy(arr.copy()).to(ref.dtype)
        return t.to(ref.device if dev is None else dev)
    if isinstance(ref, (bool, int, float)):
        return type(ref)(arr)
    return arr


def _unflatten_like(like, vals, prefix=""):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten_like(v, vals, f"{prefix}{k}/")
                for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*[
            _unflatten_like(getattr(like, k), vals, f"{prefix}{k}/")
            for k in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, vals, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return vals[prefix[:-1]]
