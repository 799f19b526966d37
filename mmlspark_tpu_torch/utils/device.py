"""Device resolution for the port (counterpart of ``utils/device.py``).

The JAX package funnels every TPU gate through ``is_tpu``; the port's one
gate is :func:`resolve_device`. Entry points take ``device=None``, which
means the CUDA card. With no card present they raise: a measurement or a
server that silently ran on the CPU would report CPU numbers under the
card's name. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple, Union

import torch

__all__ = ["resolve_device", "device_info", "OnDevice"]


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; any CUDA device must exist, else RuntimeError.
    ``"cpu"`` is honoured only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda | cpu)")
    return dev


def device_info(index: int = 0) -> Tuple[str, Optional[str]]:
    """(name, power limit) of CUDA card ``index``, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them; the power limit is None when ``nvidia-smi`` is missing
    or fails. Raises when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    name = torch.cuda.get_device_name(index)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return name, None
    parts = [p.strip() for p in out.strip().splitlines()[0].split(",")]
    if len(parts) >= 2:
        return parts[0], parts[1]
    return name, None


class OnDevice:
    """Mixin for pipeline stages that take ``device`` as a constructor
    (and ``load``) keyword rather than a persisted param: ``None`` is the
    CUDA card, resolved at construction (so it raises without a card); a
    stage loaded inside a pipeline resolves the card on first use."""

    def __init__(self, *args, device=None, **kw):
        self._device = resolve_device(device)
        super().__init__(*args, **kw)

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device(None)
        return self._device

    @classmethod
    def load(cls, path: str, device=None):
        stage = super().load(path)
        stage._device = resolve_device(device)
        return stage

    def _load_extra(self, path: str) -> None:
        super()._load_extra(path)
        self._device = None
