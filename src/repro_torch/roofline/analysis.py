"""Three-term roofline analysis of a traced step, with the H100's numbers.

Counterpart of `repro.roofline.analysis`:

  compute    = the step's operations, each at the rate of the unit that
               would run it
  memory     = HBM bytes per device / HBM_BW
  collective = wire bytes per device on each mesh axis / that axis' link

The reference charges one TPU v5e rate for every flop; the port charges each
op at its unit (`op_cost.OpCostMode`): bf16/fp16 matmuls at the tensor
cores' PEAK_FLOPS, fp32 matmuls at FP32_FLOPS (the port turns TF32 off,
`repro_torch/__init__.py`), elementwise ops and reductions at FP32_FLOPS,
and a LUT site by its kernel's count (`lut_site_cost`).

Collective wire bytes follow the reference's ring model, the port's
collectives (`launch/mesh.py`) mapped onto it:

  all_reduce, all_max, all_mean   all-reduce: 2 x input bytes
  all_gather, gather_dim          all-gather: output bytes
  reduce_scatter, all_to_all      input bytes
  broadcast                       input bytes

Each axis is charged at the link its group crosses: a group of ranks inside
one node of GPUS_PER_NODE at NVLINK_BW, any other group at IB_BW (one NDR
port per GPU). On the production mesh (16, 16) "model" spans two nodes and
"data" sixteen: both cross InfiniBand.

The hardware constants live here and nowhere else (the autotuner's model
and chip_smoke's kernel bounds import them). NVIDIA's H100 SXM5 data sheet,
dense rates without sparsity, at the card's full 700 W.
"""

from __future__ import annotations

import dataclasses
from typing import Any

PEAK_FLOPS = 989.4e12        # bf16 dense, tensor cores
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
INT8_OPS = 1979e12           # int8, tensor cores
HBM_BW = 3.35e12             # device memory, bytes/s
NVLINK_BW = 450e9            # NVLink 4, per direction
IB_BW = 50e9                 # one 400 Gb/s NDR port per GPU
GPUS_PER_NODE = 8

# the rate of each compute unit an op is charged at
UNIT_RATES = {"bf16": PEAK_FLOPS, "fp32": FP32_FLOPS, "int8": INT8_OPS}

# the ring model's kind of each of the port's collectives, and its wire bytes
# as a multiple of the bytes the collective was given ("in") or returns ("out")
RING_KIND = {"all_reduce": ("all-reduce", "in", 2), "all_max": ("all-reduce", "in", 2),
             "all_mean": ("all-reduce", "in", 2), "all_gather": ("all-gather", "out", 1),
             "gather_dim": ("all-gather", "out", 1),
             "reduce_scatter": ("reduce-scatter", "in", 1),
             "all_to_all": ("all-to-all", "in", 1), "broadcast": ("broadcast", "in", 1)}


def wire_bytes(kind: str, in_bytes: int, out_bytes: int) -> tuple[str, int]:
    """(ring-model kind, wire bytes per device) of one of the port's collectives."""
    ring, of, mult = RING_KIND[kind]
    return ring, mult * (in_bytes if of == "in" else out_bytes)


def link_bw(ranks: list[int]) -> float:
    """The link a collective over these global ranks crosses: NVLink inside
    one node of GPUS_PER_NODE, InfiniBand otherwise."""
    return NVLINK_BW if len({r // GPUS_PER_NODE for r in ranks}) == 1 else IB_BW


@dataclasses.dataclass(frozen=True)
class SiteCost:
    """What one LUT-AMM or encode call must do: its bytes (each input read
    once, the output written once), the encode's fp32 FMAs (two flops
    each) and the lookup's operations (v1: an fp32 multiply and add per
    gathered entry; fused and v2: one int8 add per entry)."""

    bytes: int
    encode_flops: int
    lookup_ops: int
    lookup_unit: str

    @property
    def t_bytes(self) -> float:
        return self.bytes / HBM_BW

    @property
    def t_ops(self) -> float:
        return self.encode_flops / FP32_FLOPS + self.lookup_ops / UNIT_RATES[self.lookup_unit]

    @property
    def t_bound(self) -> float:
        """The least time the card could take for the call (seconds)."""
        return max(self.t_bytes, self.t_ops)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.t_bytes >= self.t_ops else "operations"


def lut_site_cost(n: int, c: int, k: int, v: int, m: int, x_bytes: int,
                  kernel: str = "lut_amm") -> SiteCost:
    """The byte and operation count of one call of `kernel` ("fused_decode",
    "lut_amm_v2", "lut_amm_v1" or "encode") on x (n, c*v) of `x_bytes` a
    value, fp32 centroids (c, k, v) and an int8 table (c, k, m) with m fp32
    scales. LUT-AMM: x, the centroids, the table and scales in, the (n, m)
    output out; encode: x and the centroids in, (n, c) int32 codes out."""
    encode = 2 * n * c * k * v
    if kernel == "encode":
        return SiteCost(n * c * v * x_bytes + c * k * v * 4 + n * c * 4, encode, 0, "int8")
    nbytes = n * c * v * x_bytes + c * k * v * 4 + c * k * m + m * 4 + n * m * x_bytes
    if kernel == "lut_amm_v1":
        return SiteCost(nbytes, encode, 2 * n * c * m, "fp32")
    return SiteCost(nbytes, encode, n * c * m, "int8")


@dataclasses.dataclass
class Roofline:
    """The reference's roofline fields with H100 defaults, and the port's
    per-unit operations and per-axis collective bytes and links. Without
    `flops_by_unit` the compute term is flops / peak_flops, without
    `coll_by_axis` the collective term coll_bytes / ici_bw, as the
    reference's."""

    flops: float                  # per-device operations, every unit
    hbm_bytes: float              # per-device bytes accessed
    coll_bytes: float             # per-device wire bytes
    coll_by_kind: dict[str, float]
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = IB_BW
    flops_by_unit: dict[str, float] = dataclasses.field(default_factory=dict)
    coll_by_axis: dict[str, float] = dataclasses.field(default_factory=dict)
    link_by_axis: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        if self.flops_by_unit:
            return sum(f / UNIT_RATES[u] for u, f in self.flops_by_unit.items())
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        if self.coll_by_axis:
            return sum(b / self.link_by_axis.get(a, self.ici_bw)
                       for a, b in self.coll_by_axis.items())
        return self.coll_bytes / self.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict[str, Any]:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_by_kind": self.coll_by_kind,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "flops_by_unit": self.flops_by_unit,
            "collective_by_axis": self.coll_by_axis,
            "link_bw_by_axis": self.link_by_axis,
        }


def analyze_trace(trace) -> Roofline:
    """The roofline of an `op_cost.Trace` (counterpart of `analyze_compiled`):
    its ops' operations by unit and bytes, its mesh's wire bytes per axis at
    each axis' link."""
    return Roofline(flops=sum(trace.flops.values()), hbm_bytes=trace.hbm_bytes,
                    coll_bytes=sum(trace.coll_by_axis.values()),
                    coll_by_kind=dict(trace.coll_by_kind),
                    flops_by_unit=dict(trace.flops), coll_by_axis=dict(trace.coll_by_axis),
                    link_by_axis=dict(trace.link_by_axis))


def model_flops_train(n_params: int, tokens: int) -> float:
    """Dense-equivalent useful FLOPs: 6 * N * D (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params * tokens


def model_flops_decode(n_params: int, tokens: int) -> float:
    return 2.0 * n_params * tokens


def memory_stats(trace) -> dict[str, float]:
    """The reference's memory keys of a traced step: argument bytes (the
    rank's params, optimizer state, caches and batch), output bytes, alias
    bytes (outputs written into an argument's storage, the donated caches,
    and outputs that take a donated argument's place: new params and
    moments) and temp bytes, the trace's peak of live bytes above the
    arguments less the outputs that are not aliases. total_hbm_bytes is
    then the arguments plus the trace's peak."""
    keys = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
            "alias_size_in_bytes", "generated_code_size_in_bytes")
    fresh_out = trace.out_bytes - trace.alias_bytes
    vals = (trace.arg_bytes, trace.out_bytes, max(0, trace.peak_bytes - fresh_out),
            trace.alias_bytes, 0)
    out = {k: float(v) for k, v in zip(keys, vals)}
    out["total_hbm_bytes"] = (out["argument_size_in_bytes"] + out["output_size_in_bytes"]
                              + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
    return out
