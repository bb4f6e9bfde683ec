"""Per-stage wall times for the pipeline's ``result.metrics``."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

__all__ = ["StageClock"]


class StageClock:
    """Records the wall seconds of each named stage. On the card each
    stage boundary synchronizes, so a stage's wall holds its own device
    work and not the queue it inherited."""

    def __init__(self, device: torch.device):
        self.device = device
        self.walls: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.walls[name] = self.walls.get(name, 0.0) + (
                time.perf_counter() - t0)
