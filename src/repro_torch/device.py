"""Device selection for the port.

Entry points run on the card unless the caller asks for the CPU: without a
card they raise instead of quietly falling back, so a CPU run can never be
mistaken for a GPU one.
"""

from __future__ import annotations

import functools

import torch


def default_device() -> torch.device:
    """`cuda`, or raise when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return torch.device("cuda")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """None -> `default_device()`; otherwise the named device, which must exist."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return dev


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> tuple[int, int]:
    return torch.cuda.get_device_capability(index)


def require_sm90(t: torch.Tensor) -> None:
    """The CUDA kernels are built for sm_90a (Hopper) and run nowhere else."""
    if not t.is_cuda:
        raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
    cap = _capability(t.device.index)
    if cap != (9, 0):
        raise RuntimeError(f"the LUT kernels are built for sm_90a (Hopper); "
                           f"{torch.cuda.get_device_name(t.device)} is sm_{cap[0]}{cap[1]}")
