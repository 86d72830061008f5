"""Serving launcher: batch mode (a timed burst of requests) or an HTTP front
end over the continuous-batching engine with a LUT_INFER (int8 table) model.

  # serve a deployment artifact (written by either package), on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --artifact <dir>

  # sampled requests (seed + i for request i):
  PYTHONPATH=src python -m repro_torch.launch.serve --artifact <dir> \\
      --temperature 0.8 --top-k 50 --top-p 0.9 --seed 7

  # random tables, LUT sites through the CUDA kernels (autotuned v1/v2/v3):
  PYTHONPATH=src python -m repro_torch.launch.serve --use-kernel --requests 8

  # on the CPU, plain PyTorch versions of the kernels:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4 --slots 2

  # the other families, reduced (ssm, hybrid, moe):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --use-kernel \
      --arch mamba2_370m --layers 2 --d-model 64 --vocab 128

  # paged KV cache (prefix sharing, copy-on-write, fp8 storage) and
  # speculative decoding (a multi-plan artifact's draft plan; random-init
  # mode drafts with the target itself):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged --page-size 16 \
      --kv-dtype float8_e4m3fn --spec-decode --spec-gamma 4
  PYTHONPATH=src python -m repro_torch.launch.serve --artifact <dir> --spec-decode \
      --draft-plan draft

  # HTTP front end (NDJSON streaming, /healthz /readyz /metrics /stats,
  # SIGTERM drains); --supervise: the engine in a crash-supervised worker
  # process restarted from the artifact; --replicas N: N supervised workers
  # behind a router (least_loaded or prefix_affinity):
  PYTHONPATH=src python -m repro_torch.launch.serve --artifact <dir> --port 8000
  PYTHONPATH=src python -m repro_torch.launch.serve --artifact <dir> --port 0 --replicas 2 \
      --routing prefix_affinity --paged

  # tensor-parallel over N ranks (one process each; rank 0 schedules, the
  # others follow): N cards over NCCL, or on the CPU N gloo ranks; every
  # family the engine serves (dense, moe expert-parallel, ssm, hybrid):
  PYTHONPATH=src python -m repro_torch.launch.serve --artifact <dir> --tp 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tp 2 \
      --layers 2 --d-model 64 --vocab 128 [--arch mamba2_370m|zamba2_1p2b|arctic_480b]

Counterpart of `repro.launch.serve`. With --artifact the arch, plan and
mode come from the manifest and the artifact's autotune snapshot is
restored; without it the arch is reduced exactly as there (`reduce_arch`;
--layers/--d-model/--vocab) and initialized from a seeded generator. The
engine warms the kernel autotuner for every LUT site at its token shapes
(timed on the card with REPRO_AUTOTUNE_MEASURE=1); a warm-up request runs off
the clock unless --no-warmup. The summary adds a pool line with --paged and a
spec line with --spec-decode, as the reference's does. In HTTP mode the
process prints `serving ... on http://host:port` once it listens (with
--port 0, the port the system gave), and exits 0 after a clean drain and
`server.EXIT_STRANDED` when the drain timed out with requests unresolved.
`--arch whisper_tiny` and `--arch qwen2_vl_7b` exit with the engine's reason
for refusing them (`engine.engine_refusal`: the engine feeds token ids only).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, EXTRA_IDS, build_model, get_arch, reduce_arch
from repro_torch.core.amm import Mode
from repro_torch.kernels import autotune, counters
from repro_torch.serving.engine import (
    KV_DTYPES,
    ServingEngine,
    engine_refusal,
    lut_kernel_signatures,
)
from repro_torch.serving.sampling import SamplingParams


def chosen_versions(bundle, token_counts: list[int], dtype: str,
                    device: torch.device) -> dict[tuple[int, int, int, int], list[int]]:
    """{(M, C, K, V): [version per token count]} as `ops.lut_amm` will
    dispatch each LUT kernel site signature."""
    backend = autotune.backend_for(device)
    return {sig: [autotune.kernel_choice(n, *sig, dtype=dtype, backend=backend)[0]
                  for n in token_counts]
            for sig in lut_kernel_signatures(bundle)}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The launcher's arguments, checked: a combination it refuses, an arch
    the engine or `--tp` cannot serve, or too few cards for `--tp` exits 2
    with the reason."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", default=None,
                    help="a LUTArtifact directory: serve its tables (arch, plan and mode from "
                         "the manifest) instead of random ones")
    ap.add_argument("--arch", choices=ARCH_IDS + EXTRA_IDS, default="qwen3_1p7b",
                    help="arch of random-init mode (ignored with --artifact)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: N rank processes, each holding its shards "
                         "(ShardingRules) of the model on its own card (NCCL), or with --device "
                         "cpu N gloo ranks on the CPU")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="engine compute dtype; also keys the autotune records")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: pooled pages and block tables with prefix sharing and "
                         "copy-on-write; tokens equal the dense engine's")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (must divide --max-seq)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="pool size in pages; default slots*max_seq/page_size + 1 (the dense "
                         "capacity); fewer overcommit memory (exhaustion sheds, never raises)")
    ap.add_argument("--kv-dtype", choices=sorted(KV_DTYPES), default=None,
                    help="KV-cache storage dtype (default: the compute dtype); fp8 halves the "
                         "cache's bytes, K/V are upcast at use")
    ap.add_argument("--spec-decode", action="store_true",
                    help="draft/verify speculative decoding: gamma draft forwards per round, one "
                         "batched target verify; tokens equal plain decode's")
    ap.add_argument("--draft-plan", default="draft",
                    help="plan of a multi-plan artifact the draft loads from ('target' = "
                         "self-draft); random-init mode always self-drafts")
    ap.add_argument("--spec-gamma", type=int, default=4,
                    help="draft tokens proposed per verify forward (verify shape (slots, "
                         "gamma+1))")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy")
    ap.add_argument("--top-k", type=int, default=0, help="top-k filter; 0 disables")
    ap.add_argument("--top-p", type=float, default=1.0, help="nucleus mass; 1 disables")
    ap.add_argument("--seed", type=int, default=0, help="base sampling seed")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the untimed warm-up request")
    ap.add_argument("--use-kernel", action="store_true",
                    help="random-init mode: run LUT sites through the LUT kernels (CUDA on the "
                         "card, their plain versions on the CPU); artifacts carry their own "
                         "setting")
    ap.add_argument("--layers", type=int, default=None, help="random-init: reduce to N layers")
    ap.add_argument("--d-model", type=int, default=None, help="random-init: reduced width")
    ap.add_argument("--vocab", type=int, default=None, help="random-init: reduced vocab")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    # HTTP front end
    ap.add_argument("--port", type=int, default=None,
                    help="start the HTTP front end on this port (0: any free one) instead of "
                         "the batch run (/generate streaming, /healthz, /readyz, /metrics; "
                         "SIGTERM drains)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission high-water mark: past it the lowest-priority queued "
                         "request is shed (HTTP mode)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="seconds SIGTERM waits for in-flight requests before aborting them "
                         "and exiting non-zero")
    ap.add_argument("--supervise", action="store_true",
                    help="run the engine in a crash-supervised worker process restarted from "
                         "the artifact (requires --artifact)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="consecutive worker crashes before the supervisor gives up (with "
                         "--supervise or --replicas)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="run N crash-supervised engine replicas off the one artifact behind a "
                         "router (requires --artifact and --port)")
    ap.add_argument("--routing", choices=("least_loaded", "prefix_affinity"),
                    default="least_loaded",
                    help="router placement: the least-loaded live replica, or rendezvous "
                         "hashing of the prompt's first KV page with load-based spill")
    ap.add_argument("--fault-json", default=None,
                    help="JSON FaultSpec (e.g. '{\"kill_at_step\": 4}') injected into ONE "
                         "replica's worker (with --replicas)")
    ap.add_argument("--fault-replica", type=int, default=0,
                    help="replica index --fault-json applies to")
    args = ap.parse_args(argv)

    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.replicas > 1:
        if not args.artifact:
            ap.error("--replicas > 1 requires --artifact (each replica's worker restarts from "
                     "the artifact directory)")
        if args.port is None:
            ap.error("--replicas > 1 requires --port")
        if args.tp > 1:
            ap.error("--replicas does not compose with --tp > 1")
    if args.fault_json is not None and args.replicas < 2:
        ap.error("--fault-json needs --replicas >= 2 (a survivor must exist to fail over to)")
    if args.supervise and not args.artifact:
        ap.error("--supervise requires --artifact (the worker restarts from the artifact "
                 "directory)")
    if args.supervise and args.port is None:
        ap.error("--supervise requires --port (supervised batch mode is not wired)")
    if args.supervise and args.tp > 1:
        ap.error("--supervise does not support --tp > 1 yet")
    if args.spec_decode and args.tp > 1:
        ap.error("--spec-decode does not compose with --tp > 1 (the draft caches are "
                 "host-managed)")
    served = _served_arch(args)
    if served is not None and (refusal := engine_refusal(served)) is not None:
        ap.error(refusal)
    if args.tp > 1:
        if served is not None:
            from repro_torch.distributed.tensor_parallel import tp_refusal

            if (refusal := tp_refusal(build_model(served, Mode.LUT_INFER))) is not None:
                ap.error(refusal)
        if args.device == "cuda" and torch.cuda.device_count() < args.tp:
            ap.error(f"--tp {args.tp} needs {args.tp} cards, the host has "
                     f"{torch.cuda.device_count()}")
    return args


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    if args.tp > 1:
        devices = ["cpu"] * args.tp if args.device == "cpu" else [f"cuda:{r}"
                                                                  for r in range(args.tp)]
        sys.exit(run_tp(args, devices))
    if args.port is not None:
        return _serve_http(args)

    if args.artifact:
        from repro_torch.serving.artifact import load_artifact

        art = load_artifact(args.artifact, device=args.device)
        bundle, params = art.bundle, art.params
        source = f"artifact {args.artifact} ({art.arch_name})"
    else:
        bundle, params, source = _random_init(args)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    eng = ServingEngine(bundle, params, n_slots=args.slots, max_seq=args.max_seq,
                        prefill_chunk=args.prefill_chunk, compute_dtype=dtype,
                        device=args.device, **_paged_kwargs(args),
                        **_resolve_draft(_spec_kwargs(args), args.artifact, args.device))
    _run_batch(args, eng, source)


def _run_batch(args, eng: ServingEngine, source: str) -> None:
    """Batch mode on a built engine: the warm-up, then a timed burst of
    seeded requests, and the summary lines."""
    bundle = eng.bundle
    if not args.no_warmup:
        eng.warmup()

    counters.reset()
    gen = torch.Generator().manual_seed(1)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(torch.randint(4, 24, (1,), generator=gen))
        eng.submit(list(range(i + 1, i + 1 + plen)), max_tokens=args.max_tokens,
                   sampling=SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                           top_p=args.top_p, seed=args.seed + i))
    done = eng.run_until_done()
    dt = max(time.time() - t0, 1e-9)
    total_tok = sum(len(r.out_tokens) for r in done)
    use_kernel = any(s.lut is not None and s.lut.use_kernel for s in bundle.lut_sites())
    mode = "LUT kernels (autotuned v1/v2/v3)" if use_kernel else "plain one-hot"
    st = eng.stats()
    print(f"{len(done)} requests, {total_tok} tokens in {dt:.1f}s "
          f"({total_tok/dt:.1f} tok/s, {args.slots} slots, LUT INT8 tables, "
          f"{mode}, {args.dtype}, {source}, on {eng.device}, "
          f"{eng.n_lut_shapes_tuned} LUT shapes autotuned)")
    print(f"  steps={st['steps']} prefill: {st['prefill_tokens']} tok / "
          f"{st['prefill_forwards']} fwd ({st['prefill_tok_s']:.1f} tok/s)  "
          f"decode: {st['decode_tokens']} tok / {st['decode_forwards']} fwd "
          f"({st['decode_tok_s']:.1f} tok/s)  "
          f"occupancy={st['decode_occupancy']:.2f}  "
          f"shape_cache_hits={st['shape_cache_hits']}")
    if args.paged:
        hits = st["prefix_hits"] / st["prefix_lookups"] if st["prefix_lookups"] else 0.0
        print(f"  pool: {st['kv_pages_resident']}/{st['kv_pages_total']} pages resident (peak "
              f"{st['kv_pages_peak']}, util {st['pool_utilization']:.2f}, "
              f"{st['kv_bytes_resident']} B vs dense {st['kv_bytes_dense_equiv']} B)  "
              f"prefix: {st['prefix_hits']} hits / {st['prefix_lookups']} lookups "
              f"({hits:.2f}/req), {st['prefill_tokens_skipped']} prefill tok skipped  "
              f"cow={st['cow_copies']}  shed={st['shed']}")
    if eng.spec is not None:
        print(f"  spec: γ={st['spec_gamma']} acceptance={st['spec_acceptance_rate']:.2f} "
              f"target_forwards_per_token={st['target_forwards_per_token']:.2f} "
              f"({st['spec_rounds']} rounds, {st['spec_draft_forwards']} draft fwd, "
              f"{st['spec_bonus_tokens']} bonus)")
    counts = [args.slots, args.slots * args.prefill_chunk]
    if eng.spec is not None:
        counts.append(args.slots * (args.spec_gamma + 1))
    versions = chosen_versions(bundle, counts, args.dtype, eng.device)
    print(f"  kernel version per site (M, C, K, V) at N={counts}: "
          + ", ".join(f"{sig}: {v}" for sig, v in versions.items()))
    print(f"  kernel launches: {counters.launch_line()}  "
          f"plain calls: {counters.plain_calls()}")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: {r.out_tokens[:8]}...")


def run_tp(args, devices: list[str]) -> int:
    """Serve tensor-parallel over `devices` (rank r on devices[r]): ranks
    1.. in spawned processes, rank 0 here (it prints the summary, or serves
    HTTP). A follower that fails ends rank 0's serving: its peers could only
    wait in their next collective. Returns the exit code: rank 0's, or 1
    when a follower failed."""
    import multiprocessing as mp
    import socket
    import threading
    from multiprocessing.connection import wait

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=serve_rank, args=(r, args, devices, init), daemon=True)
             for r in range(1, len(devices))]
    for p in procs:
        p.start()
    done = threading.Event()

    def watch() -> None:
        # a follower exits 0 only once rank 0 released it
        live = {p.sentinel: r for r, p in enumerate(procs, 1)}
        while live and not done.is_set():
            for sentinel in wait(list(live), timeout=1.0):
                r = live.pop(sentinel)
                procs[r - 1].join()
                code = procs[r - 1].exitcode
                if code and not done.is_set():
                    print(f"tp rank {r} exited with code {code}: ending the server",
                          file=sys.stderr, flush=True)
                    for p in procs:
                        if p.is_alive():
                            p.kill()
                    os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    try:
        code = serve_rank(0, args, devices, init)
    finally:
        done.set()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return code or (1 if any(p.exitcode for p in procs) else 0)


def serve_rank(rank: int, args, devices: list[str], init_method: str) -> int:
    """One rank of `--tp` over `devices` (rank r on devices[r]; the backend
    follows them): join the mesh at `init_method`, serve on it
    (`serve_on_mesh`), leave it. Returns rank 0's exit code, 0 elsewhere."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=1, model=len(devices), rank=rank, devices=devices,
                          init_method=init_method)
    try:
        code = serve_on_mesh(mesh, args)
        return code if rank == 0 else 0
    finally:
        mesh.close()


def serve_on_mesh(mesh, args, *, model=None, lead=None, on_mark=None, on_engine=None):
    """One rank's engine on `mesh`: load this rank's shards (an artifact's,
    or random init cut on the host), or take them from `model` = (bundle,
    whole params, on any device: a part that is one block of a leaf on the
    rank's device stays a view of it), build the engine as `args` say, and
    show it to `on_engine(eng)` on every rank. Rank 0 leads, with
    `lead(eng, source)` where given, else in batch or HTTP mode; then it
    releases the others, which follow it and pass each of its marks to
    `on_mark(code)`. Returns rank 0's exit code (or what `lead` returned), a
    follower's `follow()` counters."""
    if model is not None:
        bundle, params = model
        source = f"the caller's model ({bundle.arch.name})"
    elif args.artifact:
        from repro_torch.serving.artifact import load_artifact

        art = load_artifact(args.artifact, mesh=mesh)
        bundle, params = art.bundle, art.params
        source = f"artifact {args.artifact} ({art.arch_name})"
    else:
        bundle, params, source = _random_init(args, device="cpu")
    eng = ServingEngine(bundle, params, mesh=mesh, n_slots=args.slots, max_seq=args.max_seq,
                        prefill_chunk=args.prefill_chunk, compute_dtype=args.dtype,
                        max_queue=args.max_queue if args.port is not None else None,
                        **_paged_kwargs(args))
    if on_engine is not None:
        on_engine(eng)
    if mesh.rank:
        return eng.follow(on_mark=on_mark)
    source += f", tp={mesh.model} over {mesh.backend}"
    try:
        if lead is not None:
            return lead(eng, source)
        if args.port is not None:
            return _serve_local(args, eng, source)
        _run_batch(args, eng, source)
        return 0
    finally:
        eng.close()


def _served_arch(args):
    """The arch the launcher would serve: the artifact manifest's (read
    without the arrays; None for a missing or invalid artifact, which fails
    at its load), else the random-init arch."""
    if args.artifact:
        from repro_torch.configs import arch_from_dict
        from repro_torch.serving.artifact import check_artifact_dir

        try:
            return arch_from_dict(check_artifact_dir(args.artifact)["arch"])
        except (FileNotFoundError, ValueError, OSError, KeyError):
            return None
    return get_arch(args.arch)


def _random_init(args, device: str | None = None):
    """(bundle, params, source) of random-init mode: the arch reduced as the
    reference's `reduce_arch` does, params from a seeded generator (on the
    CPU; placed on `device`, the launcher's by default)."""
    overrides = {"lut_use_kernel": args.use_kernel}
    for name in ("layers", "d_model", "vocab"):
        val = getattr(args, name)
        if val is not None:
            overrides["n_layers" if name == "layers" else name] = val
    arch = reduce_arch(get_arch(args.arch), **overrides)
    bundle = build_model(arch, Mode.LUT_INFER)
    params = bundle.init(torch.Generator().manual_seed(0), device=device or args.device)
    return bundle, params, f"random init ({arch.name})"


def _serve_http(args) -> None:
    """HTTP front-end mode: build a backend (a local pump, a supervised
    worker or a router over supervised replicas), serve until SIGTERM drains
    it, exit with the drain's code."""
    # JSON-safe: the supervisor ships these to its worker processes. The
    # compute dtype travels by name, as kv_dtype does: the reference's HTTP
    # modes drop --dtype (its launch/serve.py:318-336), the port does not
    engine_kwargs = dict(n_slots=args.slots, max_seq=args.max_seq,
                         prefill_chunk=args.prefill_chunk, max_queue=args.max_queue,
                         device=args.device, compute_dtype=args.dtype,
                         **_paged_kwargs(args), **_spec_kwargs(args))
    if args.replicas > 1:
        import json

        from repro_torch.serving.faults import FaultSpec
        from repro_torch.serving.router import EngineRouter

        faults = None
        if args.fault_json is not None:
            faults = [None] * args.replicas
            faults[args.fault_replica] = FaultSpec.from_dict(json.loads(args.fault_json))
        backend = EngineRouter(args.artifact, replicas=args.replicas, routing=args.routing,
                               engine_kwargs=engine_kwargs, faults=faults,
                               supervisor_kwargs={"max_restarts": args.max_restarts})
        if not backend.wait_ready(timeout=600) or not backend.healthy:
            print("no router replica came up", file=sys.stderr)
            sys.exit(1)
        source = f"artifact {args.artifact} x{args.replicas} replicas ({args.routing})"
    elif args.supervise:
        from repro_torch.serving.supervisor import EngineSupervisor

        backend = EngineSupervisor(args.artifact, engine_kwargs=engine_kwargs,
                                   max_restarts=args.max_restarts)
        if not backend.wait_ready(timeout=600) or not backend.healthy:
            print("supervised worker failed to come up", file=sys.stderr)
            sys.exit(1)
        source = f"supervised artifact {args.artifact}"
    else:
        if args.artifact:
            from repro_torch.serving.artifact import load_artifact

            art = load_artifact(args.artifact, device=args.device)
            bundle, params = art.bundle, art.params
            source = f"artifact {args.artifact} ({art.arch_name})"
        else:
            bundle, params, source = _random_init(args)
        eng = ServingEngine(bundle, params,
                            **_resolve_draft(engine_kwargs, args.artifact, args.device))
        sys.exit(_serve_local(args, eng, source))
    sys.exit(_run_server(args, backend, source))


def _serve_local(args, eng: ServingEngine, source: str) -> int:
    """HTTP mode over an in-process engine (a local pump); returns the
    drain's exit code."""
    from repro_torch.serving.server import EnginePump

    if not args.no_warmup:
        eng.warmup()          # every token shape ran once before /readyz
    return _run_server(args, EnginePump(eng), source)


def _run_server(args, backend, source: str) -> int:
    import asyncio

    from repro_torch.serving.server import run_server

    def on_started(fe):
        print(f"serving {source} on http://{fe.host}:{fe.port} "
              f"({args.slots} slots, max_queue={args.max_queue}; "
              f"SIGTERM drains, timeout {args.drain_timeout:.0f}s)", flush=True)

    return asyncio.run(run_server(backend, args.host, args.port,
                                  drain_timeout_s=args.drain_timeout, on_started=on_started))


def _paged_kwargs(args) -> dict:
    """Engine kwargs of the paged pool and the KV dtype (by name)."""
    kw: dict = {}
    if args.paged:
        kw.update(paged=True, page_size=args.page_size, n_pages=args.n_pages)
    if args.kv_dtype is not None:
        kw["kv_dtype"] = args.kv_dtype
    return kw


def _spec_kwargs(args) -> dict:
    """Speculative-decoding kwargs, the draft still named by its plan."""
    kw: dict = {}
    if args.spec_decode:
        kw.update(spec_decode=True, spec_gamma=args.spec_gamma, draft_plan=args.draft_plan)
    return kw


def _resolve_draft(engine_kwargs: dict, artifact: str | None, device: str) -> dict:
    """Swap the draft's plan name for its loaded bundle and params. Without
    an artifact (random init) the engine drafts with the target itself."""
    plan = engine_kwargs.pop("draft_plan", None)
    if engine_kwargs.get("spec_decode") and plan is not None and artifact:
        from repro_torch.serving.artifact import load_artifact

        art = load_artifact(artifact, plan=plan, restore_autotune=False, device=device)
        engine_kwargs.update(draft_bundle=art.bundle, draft_params=art.params)
    return engine_kwargs


if __name__ == "__main__":
    main()
