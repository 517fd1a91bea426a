"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; anything else raises."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def byte_rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """A 2-D int32 or uint8 tensor of byte values as contiguous uint8."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{name} must be a 2-D tensor")
    if x.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"{name} must be uint8 or int32 byte values, not {x.dtype}")
    return x.to(torch.uint8).contiguous()


def lengths_vector(x: torch.Tensor, batch: int, name: str) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.shape != (batch,):
        raise ValueError(f"{name} must be a tensor of shape ({batch},)")
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise ValueError(f"{name} must be integers, not {x.dtype}")
    return x.to(torch.int32).contiguous()
