"""Where the fused kernel's time goes on the card, phase by phase.

    PYTHONPATH=src python -m repro_torch.kernels.phase_trace

Builds csrc/fused_decode.cu once more with -DLUTNN_PHASE_TRACE, which makes
thread 0 of every block read the SM's cycle counter after a block barrier
at the phase boundaries of `lut_cluster_body` (csrc/lut_common.cuh,
LUTNN_STAMP) and its start on %globaltimer, runs the default launch at
qwen3_1p7b's C=64 sites at decode and at a prefill chunk (m-shared scale,
float32, L2 flushed as chip_smoke times them), and prints, per phase, the
mean and latest time over the blocks since the first block started (cycles
at the SM clock measured here), next to the launch's CUDA-event time. Also
prints the event time of a trivial kernel timed the same way (the floor of
any kernel measured so), and the launch's event time with its code warm
(the flush evicts the kernel's instructions from L2 too: here a launch on
a second set of operands runs between the flush and the timed launch) and
with nothing flushed. The barriers of the trace slow the kernel a little:
its phase times are for reading proportions, chip_smoke's for the
kernel's time. Runs only on the card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import measure, ref
from repro_torch.kernels import lut_amm as lut_mod

# csrc/lut_common.cuh LUTNN_STAMP(i), in order
PHASES = ("start", "exchange set up", "centroid copies issued", "table copies issued",
          "copies landed", "first chunk staged", "share encoded", "codes exchanged",
          "looked up, stored", "end")
# (site, N, C, M): the default launches
CASES = [("q/o", 4, 64, 2048), ("k/v", 4, 64, 1024), ("gate/up", 4, 64, 6144),
         ("q/o", 128, 64, 2048), ("gate/up", 128, 64, 6144)]


def trace_lib() -> ctypes.CDLL:
    """csrc/fused_decode.cu built with the phase stamps, in build/kernels/."""
    lib = lut_mod.cluster_lib("fused_decode", defines=("LUTNN_PHASE_TRACE",))
    lib.lutnn_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lutnn_phase_read.restype = ctypes.c_int
    return lib


def code_warm_us(run, warm, flush: torch.Tensor, reps: int = 10) -> float:
    """Median event time of `run` after an L2 flush and a call of `warm`
    (the same kernel on other operands), timed as measure.device_time_ms."""
    events = []
    for _ in range(reps):
        torch.cuda._sleep(measure.SPIN_CYCLES)
        flush.zero_()
        warm()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)[reps // 2] * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_trace: needs the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib = trace_lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    flush = torch.empty(measure.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    z = torch.zeros(1, device=dev)
    floor = measure.device_time_ms(z.zero_, reps=20, warmup=3, flush=flush) * 1e3
    print(f"a 1-element zero_ timed as chip_smoke times kernels: {floor:.2f} us")
    spin = 20_000_000
    mhz = spin / (measure.device_time_ms(lambda: torch.cuda._sleep(spin), reps=3) * 1e3)
    print(f"SM clock while spinning: {mhz:.0f} MHz")
    gen = torch.Generator().manual_seed(0)
    for site, n, c, m in CASES:
        ops = []
        for _ in range(2):
            ops.append((torch.randn(n, c * 32, generator=gen).to(dev),
                        torch.randn(c, 16, 32, generator=gen).to(dev),
                        torch.randint(-127, 128, (c, 16, m), generator=gen,
                                      dtype=torch.int8).to(dev),
                        torch.full((1, 1, m), 0.02, device=dev), torch.empty(n, m, device=dev)))
        x, p, q, s, out = ops[0]
        dims = lut_mod.check_args(x, p, q, s, None, "none")

        def launch(x, p, q, s, out):
            lut_mod.launch_cluster_kernel(lib, "fused_decode", x, p, q, s, None, out, dims,
                                          "none", chunked=False, rows=None, quads=None)

        def run():
            launch(*ops[0])

        us = measure.device_time_ms(run, reps=10, warmup=3, flush=flush) * 1e3
        warm_us = code_warm_us(run, lambda: launch(*ops[1]), flush)
        hot_us = measure.device_time_ms(run, reps=10, warmup=3) * 1e3
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        run()
        torch.cuda.synchronize()
        if not torch.equal(out, ref.fused_decode_plain(x, p, q, s)):
            print(f"phase_trace: {site} N={n} disagrees with the plain version", file=sys.stderr)
            return 1
        geo, _ = lut_mod.cluster_plan(lib, "fused_decode", dims, 0, False, None, None,
                                      *lut_mod.table_layout(q))
        blocks = geo["grid_x"] * geo["n_tiles"]
        buf = (ctypes.c_longlong * (blocks * len(PHASES)))()
        lut_mod.raise_on_error(lib.lutnn_phase_read(buf, len(buf)), "phase read")
        t = torch.tensor(list(buf), dtype=torch.float64).reshape(blocks, len(PHASES))
        start = (t[:, :1] - t[:, 0].min()) / 1e3        # ns on %globaltimer
        rel = torch.cat([start, start + t[:, 1:] / mhz], dim=1)
        print(f"{site} N={n}: cluster {geo['cluster']}, rows {geo['rows']}, "
              f"{4 * geo['quads']} columns, staged {geo['staged']}, {blocks} blocks; "
              f"event time {us:.2f} us (code warm {warm_us:.2f} us, nothing flushed "
              f"{hot_us:.2f} us)")
        for i, name in enumerate(PHASES):
            print(f"  {name:20s} mean {rel[:, i].mean().item():7.2f} us   latest "
                  f"{rel[:, i].max().item():7.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
