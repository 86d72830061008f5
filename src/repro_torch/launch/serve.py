"""Serving launcher, batch mode: a timed burst of greedy requests through the
continuous-batching engine with a LUT_INFER (int8 table) model.

  # on the card, LUT sites through the CUDA kernels (fused v3 / v2):
  PYTHONPATH=src python -m repro_torch.launch.serve --use-kernel --requests 8

  # on the CPU, plain PyTorch versions of the kernels:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4 --slots 2

Counterpart of `repro.launch.serve` in random-init batch mode: the arch is
reduced exactly as there (`reduce_arch`; --layers/--d-model/--vocab override
depth, width and vocab) and initialized from a seeded generator. A warm-up
request runs off the clock first. Serving a LUTArtifact (--artifact) is the
next slice (ROADMAP Queue A item 5); the HTTP, supervised and multi-replica
modes follow with item 9.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, build_model, get_arch, reduce_arch
from repro_torch.core.amm import Mode
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as v2_mod
from repro_torch.kernels import ref
from repro_torch.serving.engine import ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3_1p7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="engine compute dtype")
    ap.add_argument("--use-kernel", action="store_true",
                    help="run LUT sites through the LUT kernels (CUDA on the card, their "
                         "plain versions on the CPU)")
    ap.add_argument("--layers", type=int, default=None, help="reduce the arch to N layers")
    ap.add_argument("--d-model", type=int, default=None, help="reduced arch width")
    ap.add_argument("--vocab", type=int, default=None, help="reduced arch vocab")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    overrides = {"lut_use_kernel": args.use_kernel}
    for name in ("layers", "d_model", "vocab"):
        val = getattr(args, name)
        if val is not None:
            overrides["n_layers" if name == "layers" else name] = val
    arch = reduce_arch(get_arch(args.arch), **overrides)
    bundle = build_model(arch, Mode.LUT_INFER)
    params = bundle.init(torch.Generator().manual_seed(0), device=args.device)
    source = f"random init ({arch.name})"
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    eng = ServingEngine(bundle, params, n_slots=args.slots, max_seq=args.max_seq,
                        prefill_chunk=args.prefill_chunk, compute_dtype=dtype,
                        device=args.device)
    eng.warmup()

    fused_mod.launches = v2_mod.launches = 0
    ref.calls.update(fused_decode_plain=0, lut_amm_v2_plain=0)
    gen = torch.Generator().manual_seed(1)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(torch.randint(4, 24, (1,), generator=gen))
        eng.submit(list(range(i + 1, i + 1 + plen)), max_tokens=args.max_tokens)
    done = eng.run_until_done()
    dt = max(time.time() - t0, 1e-9)
    total_tok = sum(len(r.out_tokens) for r in done)
    mode = "LUT kernels (fused v3 / v2)" if args.use_kernel else "plain one-hot"
    st = eng.stats()
    print(f"{len(done)} requests, {total_tok} tokens in {dt:.1f}s "
          f"({total_tok/dt:.1f} tok/s, {args.slots} slots, LUT INT8 tables, "
          f"{mode}, {args.dtype}, {source}, on {eng.device}, fixed kernel blocks)")
    print(f"  steps={st['steps']} prefill: {st['prefill_tokens']} tok / "
          f"{st['prefill_forwards']} fwd ({st['prefill_tok_s']:.1f} tok/s)  "
          f"decode: {st['decode_tokens']} tok / {st['decode_forwards']} fwd "
          f"({st['decode_tok_s']:.1f} tok/s)  "
          f"occupancy={st['decode_occupancy']:.2f}  "
          f"shape_cache_hits={st['shape_cache_hits']}")
    print(f"  kernel launches: fused_decode={fused_mod.launches} lut_amm_v2={v2_mod.launches}  "
          f"plain calls: {ref.calls['fused_decode_plain'] + ref.calls['lut_amm_v2_plain']}")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: {r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
