"""Launch counts of the four CUDA kernels and call counts of their plain
versions, read and reset together, so that a run can show which kernels its
path launched and that it never reached a plain version on the card."""

from __future__ import annotations

from repro_torch.kernels import dist_argmin as enc_mod
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as lut_mod
from repro_torch.kernels import ref

KERNELS = ("fused_decode", "lut_amm_v2", "lut_amm_v1", "encode")


def launches() -> dict[str, int]:
    return {"fused_decode": fused_mod.launches, "lut_amm_v2": lut_mod.launches,
            "lut_amm_v1": lut_mod.launches_v1, "encode": enc_mod.launches}


def plain_calls() -> int:
    return sum(ref.calls.values())


def reset() -> None:
    fused_mod.launches = lut_mod.launches = lut_mod.launches_v1 = enc_mod.launches = 0
    for name in ref.calls:
        ref.calls[name] = 0


def launch_line() -> str:
    return " ".join(f"{k}={v}" for k, v in launches().items())


def stats() -> dict[str, int]:
    """The launch counts as `launches_<kernel>` and the plain-version calls,
    for a serving process's stats (a worker's counts reach its supervisor,
    the router and /metrics this way)."""
    out = {f"launches_{k}": v for k, v in launches().items()}
    out["plain_calls"] = plain_calls()
    return out
