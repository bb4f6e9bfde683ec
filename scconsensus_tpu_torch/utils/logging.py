"""Structured logging and the ``StageTimer`` facade over the tracer.

The port's copy of ``scconsensus_tpu/utils/logging.py``: ``StageTimer``
is a thin shim over :class:`~scconsensus_tpu_torch.obs.trace.Tracer`, so
callers built against the reference's API keep working: ``stage()`` opens
a stage-kind span, ``records`` is the list-of-dicts view of the stages,
and ``as_dict()`` carries the stages, the whole span tree and the schema
version for the run-record exporters. The device-sync policy lives on
the tracer (``SCC_TRACE_SYNC``): stage boundaries synchronize the card by
default.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from scconsensus_tpu_torch.obs.trace import Tracer

__all__ = ["get_logger", "StageTimer"]

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "scconsensus_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class StageTimer:
    """Facade over ``obs.trace.Tracer``.

    ``trace`` is the reference's argument and changes nothing: the
    tracer's spans are ``torch.profiler`` windows whenever a profiler
    records.
    """

    def __init__(self, logger: Optional[logging.Logger] = None,
                 trace: bool = False, tracer: Optional[Tracer] = None):
        self.logger = logger or get_logger()
        self.tracer = tracer or Tracer(logger=self.logger)
        if tracer is not None and tracer.logger is None:
            tracer.logger = self.logger

    @contextmanager
    def stage(self, name: str, **metrics: Any):
        with self.tracer.span(name, kind="stage", **metrics) as sp:
            yield sp

    @property
    def records(self) -> List[Dict[str, Any]]:
        return self.tracer.stage_records()

    def total_s(self) -> float:
        return self.tracer.total_s()

    def as_dict(self) -> Dict[str, Any]:
        return self.tracer.as_dict()
