#!/usr/bin/env python3
"""Per-rank device memory of the data-parallel training step, ZeRO-1 against
FSDP, and what is live at each step's peak.

    python3 fsdp_memory.py [--mesh DATA MODEL] [--layers 2 12] [--out FILE]

Runs qwen3_1p7b at full width (DENSE, fp32 compute, MarkovLM 4 x 128 as
chip_smoke's phase 14) at each depth of `--layers` on a (data, model) mesh
(default (2, 1), data-parallel over 2 ranks): one card per rank over NCCL
where the host has enough, else every rank on the one card over gloo
(whose all-gather is an all-reduce of a zero-padded buffer, and whose
reduce-scatter an all-reduce of the whole tensor then the rank's slice).
Each rank builds ZeRO-1 (`Zero1.build`; on a data mesh the whole params,
else the rank's model shard by `tensor_parallel.init_rank`) and then FSDP
(`ShardingRules(fsdp=True)`, the rank's parts drawn by `init_rank`), and
takes two steps of each.
The second step is the steady state (the moments exist); for it each rank
reports its param and moment bytes, what is allocated before the step, and
the step's peak (`torch.cuda.max_memory_allocated`). Rank 0 also records
the allocator's history over the second step
(`torch.cuda.memory._record_memory_history`) and replays it to the peak:
the bytes live there that the step allocated, by the innermost frame in
`repro_torch` that allocated them (`(no Python frame)` for the autograd
engine's own ops). Needs a CUDA card; writes one JSON object to `--out`
(default build/fsdp_memory_<data>x<model>.json) and prints a line
per (depth, mode, rank).
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
ARCH = "qwen3_1p7b"
BATCH, SEQ = 4, 128
SEED = 0


def _site(frames: list) -> str:
    """The innermost `repro_torch` frame of an allocation's stack."""
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name:
            return f"{name.split('repro_torch/', 1)[-1]}:{f.get('line')} {f.get('name')}"
    return "(no Python frame)"


def peak_sites(trace: list, top: int = 10) -> dict:
    """Replay one device's allocator trace: the peak of the bytes the traced
    span allocated and has not freed, and those bytes by allocating site.
    A free of memory allocated before the trace began lowers the level."""
    live: dict[int, tuple[int, str]] = {}
    level = peak = at = 0
    for i, ev in enumerate(trace):
        action, size = ev["action"], ev["size"]
        if action == "alloc":
            live[ev["addr"]] = (size, _site(ev.get("frames", [])))
            level += size
            if level > peak:
                peak, at = level, i
        elif action == "free_completed":
            live.pop(ev["addr"], None)
            level -= size
    live = {}
    for ev in trace[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], _site(ev.get("frames", [])))
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    by: dict[str, int] = {}
    for size, site in live.values():
        by[site] = by.get(site, 0) + size
    sites = sorted(by.items(), key=lambda kv: -kv[1])
    return {"peak_over_start": peak, "live_allocated_by_span": sum(by.values()),
            "sites": sites[:top]}


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _tensors(tree) -> list:
    from repro_torch.weights import reference_leaves

    return [t for ls in reference_leaves(tree).values() for t in ls
            if isinstance(t, torch.Tensor)]


def rank_main(rank: int, shape: tuple[int, int], devices: list[str], init: str,
              layers: list[int], q) -> None:
    import traceback

    sys.path.insert(0, str(ROOT / "src"))
    try:
        q.put(("ok", rank_work(rank, shape, devices, init, layers)))
    except BaseException:             # noqa: BLE001 — the parent reports it and fails
        q.put(("error", traceback.format_exc()))


def rank_work(rank: int, shape: tuple[int, int], devices: list[str], init: str,
              layers: list[int]) -> list:
    import dataclasses
    import gc

    import repro_torch  # noqa: F401  (sets the fp32 matmul policy)
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.data import MarkovLM
    from repro_torch.distributed.data_parallel import Zero1, make_data_parallel_step
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import init_rank
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW

    data_n, model_n = shape
    mesh = make_host_mesh(data=data_n, model=model_n, rank=rank, devices=devices,
                          init_method=init)
    dev = mesh.device
    data = MarkovLM(vocab=get_arch(ARCH).vocab, seq_len=SEQ, batch=BATCH)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in data.batch_at(i).items()}
               for i in range(2)]
    out = []
    try:
        for n_layers in layers:
            bundle = build_model(dataclasses.replace(get_arch(ARCH), n_layers=n_layers),
                                 Mode.DENSE)
            for mode in ("zero1", "fsdp"):
                gen = torch.Generator(device=dev).manual_seed(SEED)
                opt = AdamW(lr=1e-3)
                rules = ShardingRules(data=data_n, model=model_n, fsdp=mode == "fsdp")
                if mode == "fsdp" or model_n > 1:
                    local, params, lay = init_rank(bundle, rules, mesh, gen)
                    layout = Zero1.build(mesh, params, None, rules, tp=lay)
                else:
                    local, params = bundle, bundle.init(gen, device=dev)
                    layout = Zero1.build(mesh, params)
                state = layout.init_state(opt, params)
                step = make_data_parallel_step(local, opt, layout, compute_dtype=torch.float32)
                gc.collect()
                torch.cuda.empty_cache()
                params, state, _ = step(params, state, batches[0])
                gc.collect()
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                resident = torch.cuda.memory_allocated(dev)
                if rank == 0:
                    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                                             stacks="python")
                t0 = time.perf_counter()
                params, state, met = step(params, state, batches[1])
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
                row = {"layers": n_layers, "mode": mode,
                       "rank": (mesh.data_rank, mesh.model_rank),
                       "param_bytes": _bytes(_tensors(params)),
                       "moment_bytes": _bytes(_tensors([state.m, state.v])),
                       "resident_bytes": resident,
                       "peak_bytes": torch.cuda.max_memory_allocated(dev),
                       "loss": float(met["loss"]), "step_s": wall}
                if rank == 0:
                    snap = torch.cuda.memory._snapshot()
                    torch.cuda.memory._record_memory_history(enabled=None)
                    row["trace"] = peak_sites(snap["device_traces"][dev.index or 0])
                    del snap
                out.append(row)
                del params, state, step, layout, local
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        mesh.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=int, nargs=2, default=[2, 1], metavar=("DATA", "MODEL"))
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 12])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    shape = tuple(args.mesh)
    world = shape[0] * shape[1]
    out = Path(args.out or ROOT / "build" / f"fsdp_memory_{shape[0]}x{shape[1]}.json")
    if not torch.cuda.is_available():
        print("fsdp_memory: no CUDA device is available", file=sys.stderr)
        return 1
    import multiprocessing as mp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else "unknown"
    n = torch.cuda.device_count()
    devices = [f"cuda:{r}" for r in range(world)] if n >= world else ["cuda:0"] * world
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, shape, devices, init, args.layers, q),
                         daemon=True) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = []
    try:
        for _ in procs:
            got.append(q.get(timeout=1500))
            if got[-1][0] != "ok":
                break
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [v for s, v in got if s != "ok"]
    if errors or len(got) < world:
        print("fsdp_memory: a rank failed:\n" + "\n".join(errors), file=sys.stderr)
        return 1
    rows = sorted((r for _, v in got for r in v),
                  key=lambda r: (r["layers"], r["mode"], r["rank"]))
    backend = "nccl" if n >= world else "gloo (every rank on cuda:0)"
    print(f"[fsdp_memory] {card}; {ARCH} full width, DENSE fp32, (data, model) = {shape} "
          f"over {backend}, "
          f"MarkovLM {BATCH} x {SEQ}; {time.perf_counter() - t0:.1f}s")
    gib = 2.0 ** 30
    for r in rows:
        line = (f"[fsdp_memory] {r['layers']} layers {r['mode']} rank {tuple(r['rank'])}: params "
                f"{r['param_bytes'] / gib:.3f} GiB, moments {r['moment_bytes'] / gib:.3f}, "
                f"allocated before the step {r['resident_bytes'] / gib:.3f}, the step's peak "
                f"{r['peak_bytes'] / gib:.3f} (+{(r['peak_bytes'] - r['resident_bytes']) / gib:.3f}"
                f"), step {r['step_s']:.2f}s, loss {r['loss']:.7f}")
        print(line)
        if "trace" in r:
            tr = r["trace"]
            print(f"[fsdp_memory]   at the peak, allocated in the step and live: "
                  f"{tr['live_allocated_by_span'] / gib:.3f} GiB; by site: " + "; ".join(
                      f"{site} {b / gib:.3f}" for site, b in tr["sites"]))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "mesh": shape, "backend": backend, "rows": rows},
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
