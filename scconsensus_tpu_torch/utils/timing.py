"""Per-stage wall times for the pipeline's ``result.metrics``."""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict

import torch

from scconsensus_tpu_torch.obs.trace import annotation

__all__ = ["StageClock"]


class StageClock:
    """Records the wall seconds of each named stage. On the card each
    stage boundary drains the card once, so a stage's wall holds its own
    device work and not the queue it inherited.

    With a ``tracer`` (``obs.trace.Tracer``) each stage also runs inside a
    tracer span of the same name (``kind`` "stage" unless told otherwise;
    ``span=False`` keeps a wall the reference's span tree does not have),
    and the block receives that span, whose attributes land on the stage
    record. Where the span drains the card at its boundaries, its synced
    wall is the stage's and the clock adds no drain of its own. A stage
    with no span is a profiler window of its name while a profiler
    records (``obs.trace.annotation``), and the block receives None."""

    def __init__(self, device: torch.device, tracer=None):
        self.device = device
        self.tracer = tracer
        self.walls: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _span_drains(self, kind: str) -> bool:
        """Whether the tracer's span of ``kind`` drains this clock's card
        (the tracer drains the current card)."""
        return (self.device.type == "cuda" and self.tracer.drains(kind)
                and self.device.index in (None, torch.cuda.current_device()))

    def _add(self, name: str, wall_s: float) -> None:
        self.walls[name] = self.walls.get(name, 0.0) + wall_s

    @contextlib.contextmanager
    def stage(self, name: str, kind: str = "stage", span: bool = True,
              **attrs: Any):
        tracer = self.tracer if span else None
        if tracer is not None and self._span_drains(kind):
            sp = None
            try:
                with tracer.span(name, kind=kind, **attrs) as sp:
                    yield sp
            finally:
                self._add(name, sp.wall_s if sp is not None else 0.0)
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            if tracer is not None:
                with tracer.span(name, kind=kind, **attrs) as sp:
                    yield sp
            else:
                with annotation(name):
                    yield None
        finally:
            self._sync()
            self._add(name, time.perf_counter() - t0)

    def detail(self, name: str, **attrs: Any):
        """A ``detail``-kind stage: its wall lands in ``walls`` beside the
        stages', its span under the enclosing stage's."""
        return self.stage(name, kind="detail", **attrs)
