"""Device resolution and the port's fp32 policy.

Every entry point takes ``device=None`` and runs on ``cuda`` unless the
caller asks for the CPU with ``device="cpu"`` (as the tests do). With no
card and no explicit CPU request it raises: the port never carries on on
the CPU by itself.

fp32 throughout. The rank-sum counts and contractions, the cluster
aggregates and the silhouette sums need full float32: the reference runs
them at ``Precision.HIGHEST`` (``scconsensus_tpu/ops/ranksum_allpairs.py``,
``ops/gates.py``) because rank sums and Σx² − n·mean² cancellations do not
survive a shorter mantissa. TF32 keeps about three decimal digits, so it
is switched off for matrix products and for cuDNN alike.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "as_points"]


def _pin_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless told otherwise; raises when CUDA is asked for (or
    defaulted to) and absent. Pins the fp32 policy on every call."""
    _pin_fp32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_points(x, device: Optional[Union[str, torch.device]] = None
              ) -> torch.Tensor:
    """``x`` as a contiguous float32 tensor. A tensor stays on its own
    device unless ``device`` names another; anything else (a numpy array)
    goes to ``resolve_device(device)``, the card by default."""
    if isinstance(x, torch.Tensor):
        if device is None:
            _pin_fp32()
            dev = x.device
        else:
            dev = resolve_device(device)
        return x.to(device=dev, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                           device=resolve_device(device))
