"""Per-stage wall times for the pipeline's ``result.metrics``."""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict

import torch

__all__ = ["StageClock"]


class StageClock:
    """Records the wall seconds of each named stage. On the card each
    stage boundary synchronizes, so a stage's wall holds its own device
    work and not the queue it inherited.

    With a ``tracer`` (``obs.trace.Tracer``) each stage also runs inside a
    tracer span of the same name (``kind`` "stage" unless told otherwise;
    ``span=False`` keeps a wall the reference's span tree does not have),
    and the block receives that span, whose attributes land on the stage
    record. Without one the block receives None."""

    def __init__(self, device: torch.device, tracer=None):
        self.device = device
        self.tracer = tracer
        self.walls: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str, kind: str = "stage", span: bool = True,
              **attrs: Any):
        self._sync()
        t0 = time.perf_counter()
        try:
            if self.tracer is not None and span:
                with self.tracer.span(name, kind=kind, **attrs) as sp:
                    yield sp
            else:
                yield None
        finally:
            self._sync()
            self.walls[name] = self.walls.get(name, 0.0) + (
                time.perf_counter() - t0)

    def detail(self, name: str, **attrs: Any):
        """A ``detail``-kind stage: its wall lands in ``walls`` beside the
        stages', its span under the enclosing stage's."""
        return self.stage(name, kind="detail", **attrs)

