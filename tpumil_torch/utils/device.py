"""Device selection and precision switches (counterpart of
tpumil/utils/platform.py::select_platform).

There is no "auto": asking for ``cuda`` without a usable CUDA device raises
instead of landing on the CPU, so a measurement can never silently run on
the wrong device.
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def select_device(name: str = "cuda") -> torch.device:
    """``--device cuda|cpu`` -> a ``torch.device``; raises when CUDA is
    asked for and unavailable."""
    if name not in DEVICES:
        raise ValueError(f"unknown device {name!r}; expected one of {DEVICES}")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda requested but no CUDA device is "
                               "available (use --device cpu explicitly)")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def disable_tf32() -> None:
    """Turn both TF32 switches off. cuDNN runs f32 convolutions in TF32 by
    default (``cudnn.allow_tf32`` is True), which keeps only ~3 decimal
    digits; every f32 tier of this package is true f32, so the models call
    this at the top of each forward."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
