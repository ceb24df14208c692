"""Elastic meshes and the straggler watchdog (counterpart of
``repro.train.elastic``).

A restart after a node loss rebuilds the mesh for the ranks that exist
(under ``torchrun``, a restart with fewer ranks: the counterpart of JAX's
rebuild from the surviving devices), and every rank restores the last
checkpoint, which holds whole leaves (``train.checkpoint``), onto the new
mesh's slices. ``launch/train.py`` wires the mesh, the watchdog and the
restore together.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

# one shared (data, model) factorisation: elastic rebuilds and the serving
# mesh must agree on dim names and shapes
from ..launch.mesh import best_mesh_shape, make_mesh_2d

__all__ = ["best_mesh_shape", "make_elastic_mesh", "StragglerWatchdog"]


def make_elastic_mesh(model_parallel: int = 16,
                      device_type: Optional[str] = None):
    """The (data, model) mesh of ``best_mesh_shape`` over every rank of
    the initialised default process group."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_elastic_mesh needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    shape = best_mesh_shape(dist.get_world_size(), model_parallel)
    return make_mesh_2d(shape, device_type)


@dataclasses.dataclass
class StragglerWatchdog:
    """EMA step-time monitor: flags steps slower than ``threshold`` x EMA.

    A flagged straggler is recorded in ``events``; after
    ``max_consecutive`` flagged steps in a row it raises, so the launcher
    can checkpoint and rebuild the mesh."""
    threshold: float = 3.0
    decay: float = 0.9
    max_consecutive: int = 10
    ema: float = 0.0
    consecutive: int = 0
    events: list = dataclasses.field(default_factory=list)
    _t0: float = 0.0

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> bool:
        dt = time.perf_counter() - self._t0
        if self.ema == 0.0:
            self.ema = dt
            return False
        is_straggler = dt > self.threshold * self.ema
        if is_straggler:
            self.consecutive += 1
            self.events.append((step, dt, self.ema))
        else:
            self.consecutive = 0
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        if self.consecutive >= self.max_consecutive:
            raise RuntimeError(
                f"persistent straggler: {self.consecutive} consecutive slow "
                f"steps (last {dt:.3f}s vs EMA {self.ema:.3f}s) — "
                "checkpoint and rebuild the mesh")
        return is_straggler
