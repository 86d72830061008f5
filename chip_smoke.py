#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase is skipped):
  1. the card: name and power limit, and a build of every CUDA kernel from
     the sources in this checkout, all nvcc processes at once;
  2. each kernel against its plain PyTorch version on the card: at the main
     path's shapes (qwen3_1p7b's LUT sites at N = 4 decode, N = 20 the
     speculative verify of 4 slots at gamma 4, and N = 128 a prefill chunk),
     then every kernel under every launch the tuner can choose there (rows
     per N tile and M tile, v1's chunk of the sum, the encode's rows and
     codebooks per block; fused == v2 == plain and v1 == plain bytewise),
     then on ragged shapes x 4 scale layouts (x every activation x bias for
     the fused and v2 kernels, and x every N tile on shapes whose C take
     every cluster size, v1 with 3 chunks of the sum and the encode under its
     launches), in float32 and bfloat16; with CUDA-event times of the kernel
     and its plain version, the event floor (a 1-element kernel timed the
     same way), the host's enqueue time, the dense matmul the site replaces
     (context only) and the least time the card could take;
  3. the slice at full width and reduced depth (2 layers), card against CPU
     (plain versions) from the same params: a prefill chunk and greedy decode
     steps, once from random params under the fit rule, once from a 2-layer
     artifact the port wrote and loaded back with every LUT site pinned to
     v1 by autotune records; logits and tokens must agree except at and after
     a code the card picked otherwise or a near-tie;
  4. the main path: full-width 28-layer qwen3_1p7b in LUT_INFER mode exported
     as an artifact (its snapshot's encode records timed on the card first),
     loaded with load_artifact, warmed with the measured autotuner (v1, v2
     and the fused kernel timed on the card per site and token count), and a
     burst of 8 requests (2 sampled) served twice by ServingEngine, with every
     kernel's launch count read around the run; then the analytic tuner's
     choices timed against the measured records;
  5. the paged KV cache and speculative decoding on the phase-4 model, each
     run with the launch counts set to 0 before it and read after (some
     kernel launched, no plain version called; launches per N printed) and
     its tokens held against the plain dense engine's (a difference only at
     a near-tie of the plain run's sampler values, counted and printed):
     paged with prefix sharing (page 16, the default pool; 8 requests
     sharing a 48-token prefix, the last a resubmission of the first, so
     prefix hits and a copy-on-write), the same burst on a 9-page pool
     (shedding, nothing raises), fp8 paged against dense fp8 (bytes against
     fp32), and the paged decode step profiled beside phase 4's dense one;
     speculative decoding at gamma 4 on the phase-4 burst with a self-draft,
     then a divergent draft (the arch at full width and DRAFT_LAYERS
     layers, from another seed) dense and paged (rollback and page rewind); a two-plan artifact at 2 layers the
     port writes (target keeps mlp/down dense, the draft all-LUT shares the
     rest), served by `launch.serve --spec-decode --draft-plan draft` and by
     a spec engine against plain decode;
  6. the process layer: `python -m repro_torch.launch.serve --artifact <phase
     4's artifact> --port 0 --replicas 2 --routing prefix_affinity --paged
     --slots 4 --max-seq 256 --prefill-chunk 32` as a subprocess, two
     supervised worker processes on the one card, each with its own CUDA
     context, served from the artifact with its autotune records restored:
     /readyz 200, the kernels' launch counts 0 at ready and read after each
     burst over /stats (every kernel the records choose launched, no plain
     version called), each replica's start-up split (interpreter and torch
     import, CUDA context, artifact load, record restore, engine), device
     memory per worker (its own allocator's, as it reports it, and the
     card's used memory as a cross-check); the phase-4 burst from 8 client threads over
     /generate with "stream": true (tokens equal phase 4's plain run's
     except at a near-tie; time to first token and the inter-token gap
     beside the same burst in process), with a transient fault
     ({"error_steps": [3]}) on replica 0 retried in place; phase 5's
     shared-prefix burst, all on one replica, prefix_hits > 0 in /metrics;
     SIGTERM exits 0. A second launch with {"kill_at_step": 4} on replica 0:
     restarts >= 1, requeued >= 1, the same tokens, the restart's time to
     ready; SIGTERM exits 0.
  7. training: (a) one soft-PQ step (LUT_TRAIN forward, autograd, AdamW) at
     full width and 2 layers on the card against the same step on the CPU
     and the same step in float64 on the card as witness
     (`testing.lut_train_step_parity(witness=)`: codes off near-ties, fake-quant
     roundings off half-integers, loss, every gradient, the update); (b) `train.recipe.default_recipe(steps=4)` run
     by `Recipe.run` on qwen3_1p7b at full width and TRAIN_LAYERS layers
     (dense pretrain, tape + k-means init, soft-PQ, int8 deploy to an
     artifact, eval), with per-step, tape/k-means and deploy times,
     checkpoint and artifact bytes and peak memory; the launch counts read
     around the run (Eval is its only LUT_INFER forward: one kernel per LUT
     site, no plain call), Eval's loss held against the plain versions and
     each of Eval's LUT-site calls (N = 1024 rows) held against the plain
     version on its own inputs, rows near a tie dropped and counted;
     the trained artifact loaded with measured warm-up (a fresh autotune
     cache; the version each record picks printed) and the phase-4 burst
     served against the same engine over the plain versions; (c) `python -m
     repro_torch.launch.train --lut --steps LAUNCHER_STEPS` at its default
     size SIGKILLed after soft-PQ's first commit and re-run (finished stages
     restored, soft-PQ resumed at the committed step), its artifact served
     by `launch.serve`; and a `--spec-draft attn/*` run at --steps
     SPEC_STEPS served with `--spec-decode --draft-plan draft` (acceptance,
     target forwards per token), run beside (a) so that (b) and the rest of
     (c) are timed with nothing else on the card;
  8. the MoE, SSM and hybrid families at full published width, each served
     by ServingEngine (4 slots, prefill chunk 32, measured warm-up) on a
     burst of 8 requests whose prompts are one chunk, two chunks, ragged
     over two and ragged inside one (2 sampled): mamba2_370m and
     zamba2_1p2b (SERVE_FAMILY_LAYERS: 6 of 48 and 6 of 38 layers)
     exported as artifacts and loaded, then
     arctic_480b with ARCTIC_LAYERS layers (layer 0 dense, layer 1 LUT, 128
     experts top-2 and the dense residual; ~35 GB of bf16 params built on the
     card, after the earlier phases' models are freed). For each: the
     version the tuner picked per site, the burst through the plain
     versions, then through the kernels with the counts set to 0 before and
     read after (tokens equal except after a near-tie of the plain run or,
     on the recurrent two, a code the kernels picked at a tie: every LUT-site
     call of their burst held against the plain versions; no
     plain version called), each LUT site's first launch at N = 4 and 128
     held against the plain lookup of the encode kernel's codes, decode
     tokens/s, a profiled decode step's device-busy share, peak memory, each
     site signature timed (kernel, plain version, bound); on the two
     recurrent families, speculative decoding and prefix sharing must turn
     off with their warnings.
  9. the enc-dec and vision-LM families at full published width,
     each exported as an artifact and loaded, driven by
     `ModelBundle.forward_step` (ServingEngine refuses both, naming why:
     checked) after the measured warm-up at the phase's token counts:
     whisper_tiny (4 + 4 layers, 1500 frames) on ROWS9 rows of seeded stub
     frames, a WHISPER_PROMPT-token prefill with them (encoder and cross
     K/V at N = 6000), then GREEDY_STEPS greedy decode steps, on dense
     caches and on paged ones; qwen2_vl_7b (VLM_SERVE_LAYERS of its 28
     layers) on ROWS9 rows of a
     VLM_GRID of seeded patch embeddings and VLM_TEXT text tokens'
     embedding rows, then greedy steps each fed back as its embedding row,
     and a no-cache forward with the grid's distinct (t, h, w) M-RoPE
     streams. Each through the plain versions, then through the kernels
     with the counts set to 0 before and read after (tokens equal except
     after a near-tie of the plain run's logits; no plain version called);
     each LUT site's first launch at every N held against the plain lookup
     of the encode kernel's codes; prefill and decode forward times, a
     profiled decode forward's device-busy share, peak memory, each site
     signature timed (kernel, plain version, bound).
 10. training the MoE, SSM, hybrid, enc-dec and vision-LM families, each
     trained artifact served through the kernels: (a) one soft-PQ step at
     full published width, card against CPU against float64 on the card
     (`testing.lut_train_step_parity`, as 7 (a)), on `testing.family_batch`
     batches: mamba2_370m at 2 layers, zamba2_1p2b at 6 (its shared block
     invoked once), whisper_tiny at full depth over 1500 stub frames
     (qwen2_vl_7b's step only at reduced size, in `tests/test_torch_cuda.py`:
     at full width its host side took ~90 s of the time limit);
     (a') arctic_480b on the card alone (ARCTIC_LAYERS layers, every layer
     LUT, bf16 params): loss finite, aux > 0, the expert sites' shared
     codebooks a nonzero finite gradient, peak memory (out of memory: the
     peak printed and the step run at `reduce_arch`); (b)
     `default_recipe(steps=TRAIN_STEPS)` by `Recipe.run` on mamba2_370m and
     zamba2_1p2b at full width and RECIPE_LAYERS layers, with 7 (b)'s checks
     (Eval one kernel per LUT-site call, no plain call, held against the
     plain versions), then each trained artifact served as phase 8 serves,
     every LUT-site call of its burst held against the plain versions (a
     request may leave the plain run only after a near-tie of its logits
     or a code the kernels picked at a tie);
     (c) whisper_tiny (full) and qwen2_vl_7b (TRAIN_VLM_LAYERS layers)
     trained through the functions (dense steps, tape + k-means on frame or
     embedding sample batches, soft-PQ steps, deploy_to_artifact) and run
     as phase 9 runs; (d) `launch.train --arch mamba2_370m --lut --steps
     FAMILY_LAUNCHER_STEPS` at its default size, served by `launch.serve`, and
     `--arch whisper_tiny`'s refusal, run beside (a) (after (a'), whose
     full-width try fills the card) so that (b) and (c) are timed and tuned
     with nothing else on the card. The launches of (b) and (c)'s kernel
     runs join the kernels line ("phase_launches").
 11. tensor-parallel serving at tp 2 (runs after phase 6): qwen3_1p7b at
     full width and TP_LAYERS layers (phase 4's arch and seed, cut from 28
     layers) written as an artifact, its plain run of phase 4's burst the
     reference; two rank processes, over NCCL when the host has two
     cards, else both on the one card over gloo (each its own CUDA
     context), each serving through the launcher's rank function
     (`launch.serve.serve_on_mesh`, the `--tp` path) with phase 11's
     instruments on its hooks: each loads only its shards
     (`load_artifact(mesh=)`), rank 0 tunes the rank's site shapes
     (measured) and broadcasts the records, and a dense and a paged
     `ServingEngine(mesh=)` serve phase 4's burst (rank 0 schedules, rank 1
     follows): tokens held against the plain run (`compare_tokens`),
     per rank the launch counts read between rank 0's marks (every kernel
     the records choose at the rank's shapes, exactly as many launches as
     its LUT-site calls, no plain version); every LUT-site call of the
     burst's first prefill and first decode forward on each rank held
     against the plain versions at the rank's shapes (`hold_sites`; the row
     sites' unit-scale calls too), and each row-parallel site's reduced
     output held bytewise against the unsharded site on the same input (the
     ranks' input columns, centroids and tables gathered: the plain lookup
     of the encode kernel's codes); the decode forward's wall time, a
     profiled window's device-busy share, the all-reduces per forward and
     their host time, and device memory. Its launches join the kernels line
     ("phase_launches").
 12. tensor-parallel serving at tp 2 of phase 8's models (phases 8 and 12
     run last, after phase 10): mamba2_370m and zamba2_1p2b from phase 8's
     artifacts (each
     rank reading its shards), arctic_480b from phase 8's params on the card
     (each rank receives them as CUDA IPC views: its experts are views of
     the parent's tensors, nothing copied), both ranks on the one card over
     gloo unless the host has two; each through the launcher's rank
     function with phase 11's instruments, dense and, for the two with
     attention, paged, on phase 8's burst: tokens held against phase 8's
     plain run (`compare_tokens`), per rank the launch counts (exactly the
     records' kernels at the rank's shapes, in_proj at its head-aligned
     selection, no plain version), every LUT-site call of the burst held
     against the plain versions (`hold_sites`), the row sites of the first
     prefill and decode forward against the unsharded site (`hold_rows`),
     arctic's expert calls bytewise against the unsharded sites and its
     expert combine against the unsharded layer on the same inputs
     (`hold_moe`: the elements that differ counted); the decode forward's
     wall time, a profiled window's device-busy share, the all-reduces per
     forward and their host time, peak memory per rank and the card's used
     memory. Its launches join the kernels line ("phase_launches").
 13. data-parallel training at dp 2 (after phase 10, before 8 and 12):
     qwen3_1p7b DENSE at full width and DP_LAYERS layers, MarkovLM batches
     over the full vocab; two rank processes, over NCCL when the host has
     two cards, else both on the one card over gloo. (a) DP_STEPS steps of
     `data_parallel.make_data_parallel_step` (ZeRO-1 moments) against the
     single-rank step here on the same global batches: the loss within
     1e-5 relative at every step, the params after one step within
     `testing.AdamLeafRule`, after DP_STEPS the params and the gathered
     moments no further (L2, per leaf) from the same steps in float64 than
     the single-rank run (`testing.witness_ratio`), both ranks' params bytewise
     equal, each rank's moment shards by `opt_spec`; (b) the int8
     compressed gradient step (`grad_compression.make_compressed_grad_fn`):
     its mean loss against the exact one, its mean gradient within 0.05 of
     the exact mean's max, each rank's bytewise the plain compressed mean
     of the ranks' own local vectors (or one final-scale step off at a
     counted tie), the residual exactly what int8 dropped; (c) the dp-2
     state committed (rank 0 writes whole arrays) and restored by a dp-1
     context (`elastic.rescale`) bytewise, then DP_STEPS more steps, the
     losses falling; (d) `launch.train --grad-compression` at its default
     size, run and re-run over its ckpt dir (the second restores the
     committed stage), while the ranks start, so that (a)-(c) run with
     nothing else on the card. Per step its wall time and each
     collective's count, bytes and host time; per rank its peak memory;
     the card's used memory. No LUT kernel launches (read around the
     phase, here and on each rank), so the phase adds nothing to the
     kernels line.
 14. tensor-parallel training on a (data, model) = (2, 2) mesh (after 13,
     before 8 and 12): qwen3_1p7b at full width and TPT_LAYERS layers
     (layer 0 dense, layer 1 LUT under all_but_first), MarkovLM 4 x 128;
     four rank processes on the one card over gloo (a card each over NCCL
     where the host has four), each holding its `ShardingRules(2, 2)` cut
     (`tensor_parallel.place(train=True)`, ZeRO-1 inside its model
     shard). (a) a DENSE step and (b) a soft-PQ step (SOFT_PQ_RULES,
     `lut_frozen_mask`) against the single-rank step here on the same
     global batch, run before the ranks' steps: the loss within 1e-5
     relative; after the step every param leaf, gathered to whole leaves,
     within `testing.AdamLeafRule` (a log_t by AdamW of its rank's own
     gradient, held against the single rank's by its terms); replicated
     leaves bytewise equal across each model group and params across each
     data group; each rank's param and moment shapes its spec cut; the
     soft-PQ step takes the single-rank step's codes and table integers
     where its own differ at a tie, each difference checked. Then, in the
     same ranks from the same start, FSDP (`ShardingRules(fsdp=True)`: each
     rank its data part of every leaf the spec splits over "data" too,
     gathered per block, the gradient reduce-scattered): (c) a DENSE step
     and (d) a soft-PQ step, held the same way (the leaf rule on
     the model shards gathered on the ranks), each rank's parts its
     `param_spec(fsdp=True)` cut, its param and moment bytes beside
     ZeRO-1's, the data gathers and reduce-scatters on lines of their own.
     Per rank each step's wall time, peak memory (beside what the rank
     held before the step: the earlier runs' results stay alive for the
     parent's holds) and collectives per axis;
     the card's used memory. No LUT kernel launches ("phase_launches"
     reads 0, "14_fsdp" for the FSDP runs alone, counted from 0). One step
     of each: the leaf rule after it holds the update, and multi-step
     holds are the CPU tests' work.
 15. tensor-parallel training of the MoE, SSM and hybrid families on the
     same (2, 2) mesh (after 14, before 8 and 12: arctic's IPC-shared
     params stay allocated after phase 12), four rank processes on the one
     card over gloo (NCCL where the host has four): mamba2_370m at 2 layers
     and zamba2_1p2b at 6 (one invocation of the shared block), each a
     DENSE step and a soft-PQ step, and arctic_480b at 1 layer, every
     layer LUT, one soft-PQ step (its experts over both axes, tokens by the
     data all-to-all), all at full width on MarkovLM 4 x 128. Each job's
     single-rank steps run here first on the same global batches, its
     frozen leaves are freed, and each rank draws its part of the same
     init from the same seed (`tensor_parallel.init_rank`: an expert stack
     keeps the rank's experts as it is drawn). Held: the losses within 1e-5
     relative; after one step every trainable leaf, gathered whole, within
     `testing.AdamLeafRule` (a log_t by AdamW of its own gradient, that
     gradient by its terms); replicas bytewise equal (the experts differ by
     data rank); each rank's shapes its cut (`testing.expected_rank_shapes`
     with the layout's kept differences); the soft-PQ steps pinned to the
     single-rank step's codes and integers at ties, each checked (expert
     tables built one expert at a time and held by digest); arctic's
     routing decisions on each rank bytewise the single rank's. Per rank
     each step's wall time, peak memory and collectives per axis (the data
     all-to-all's count, bytes and host time among them); the card's used
     memory. Then one FSDP DENSE step of mamba2_370m, held against the same
     single-rank steps. No LUT kernel launches ("phase_launches" reads 0,
     "15_fsdp" for the FSDP run alone).
 16. the enc-dec and the vision-LM on a (data, model) mesh. (a) right
     after phase 9 (its two rank processes started before phase 9, beside
     it), tensor-parallel serving at tp 2 of phase 9's whisper_tiny (4 + 4
     layers, 1500 frames) and qwen2_vl_7b (VLM_SERVE_LAYERS layers), each
     rank reading only its shards of phase 9's artifacts (deleted after):
     rank 0 tunes the rank's site shapes (measured) and broadcasts the
     records; phase 9's prefill (frames, or embeddings) and GREEDY_STEPS
     greedy steps through `make_serve_step(local, mesh=)` on dense and
     paged caches. Held: the tokens against phase 9's plain run (a
     difference only after a near-tie or a code picked at a tie), per rank
     the launch counts (each LUT-site call's kernel as the records choose
     at its N and the rank's shapes, exactly one launch per call, no plain
     call), every LUT-site call of the first prefill and decode forward
     against the plain versions, their row sites bytewise against the
     unsharded site. Per rank the decode forward's wall time, the
     all-reduces per forward and their host time, peak memory. (b) in
     phase 15's ranks (its last jobs): whisper_tiny at full size and
     qwen2_vl_7b at full width and 2 layers on `testing.family_batch`
     batches (4 x 128; stub frames, or embeddings with their M-RoPE grid
     positions), a DENSE and a soft-PQ step under ZeRO-1 and a DENSE step
     under FSDP, held as phase 15 holds its jobs (qwen2_vl_7b's ZeRO-1
     single-rank steps run again after the ranks', `TPF_SINGLE_AFTER`).
 17. the dry run and the H100 roofline (right after phase 4, on its
     engine): (a) its decode step (4 slots, max_seq 256, float32, the
     artifact's bundle) traced on the meta device on a (1, 1) DryMesh
     (`roofline.op_cost.trace_step`). Held: the trace's argument bytes
     equal the engine's params, caches and batch exactly; its roofline's
     t_bound is at most phase 4's measured device-busy time per decode
     step; every LUT site is charged once, at `roofline.analysis.
     lut_site_cost` for the version its record chose. Printed: each term,
     t_bound against the busy time, the costliest model paths
     (`op_cost.hotspots`), and the predicted peak against
     `torch.cuda.max_memory_allocated` around one real decode forward of
     the engine. (b) qwen3_1p7b x decode_32k traced on both production
     meshes (`launch.dryrun.trace_cell`), each record's `[ok]` line.
Prints a JSON line of per-kernel results, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# This process and every one it starts share one bytecode cache under
# build/: where the interpreter keeps none of its own (read-only site
# packages, or PYTHONDONTWRITEBYTECODE), each fresh process would compile
# torch's modules again, and torch._dynamo's, which activation
# recomputation imports at a training step's first call.
PYCACHE = Path(__file__).resolve().parent / "build" / "pycache"
sys.pycache_prefix = str(PYCACHE)
sys.dont_write_bytecode = False
os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
SEED = 0
TIE_EPS = 1e-6          # relative fp32 distance gap: rounding order may flip a code
KERNEL_ATOL = 1e-4      # fp32 per-codebook / per-column sums in another order
LOGIT_ATOL = 1e-3       # full-model logits, card vs CPU, at positions without a tie
# qwen3_1p7b LUT sites at lut_v = 32: (name, C, M)
SITES = [("q/o", 64, 2048), ("k/v", 64, 1024), ("gate/up", 64, 6144), ("down", 192, 2048)]
# the path's token counts at 4 slots: decode, verify (gamma 4) and a prefill chunk of 32
GAMMA = 4
DRAFT_LAYERS = 2                 # depth of phase 5's divergent draft (full width)
PATH_N = (4, 4 * (GAMMA + 1), 4 * 32)


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: the card and the build
# ---------------------------------------------------------------------------

def phase_card() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} capability {torch.cuda.get_device_capability(0)}")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    times = build.build()
    wall = time.perf_counter() - t0
    log(f"[build] {len(times)} kernels in {wall:.2f}s wall: "
        + ", ".join(f"{n} {s:.2f}s" for n, s in times.items()))
    for name in build.SOURCES:
        report = (build.build_dir() / f"{name}.log").read_text()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")
    return {"card": card, "build_s": wall}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Median CUDA-event time of one call on the device, with L2 flushed
    before each call (the model reads each site's table cold: 27 layers of
    tables exceed L2). A spin on the device before each call lets the host
    enqueue the call ahead, so host overhead is not counted here (see
    host_us). The autotuner times its candidates the same way."""
    from repro_torch.kernels.measure import device_time_ms

    return device_time_ms(fn, reps=reps, warmup=3, flush=flush)


def host_us(fn, reps: int = 50) -> float:
    """Host time to enqueue one call (wrapper checks, launch), device idle."""
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)             # keep the device busy meanwhile
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return dt


def bound_ms(n: int, c: int, k: int, v: int, m: int, x_bytes: int, *,
             kernel: str = "lut_amm") -> tuple[float, str]:
    """Least time for one call: each input read once and the output written
    once over HBM, against the operations at the card's peaks
    (`roofline.analysis.lut_site_cost`, the H100's constants there)."""
    from repro_torch.roofline.analysis import lut_site_cost

    cost = lut_site_cost(n, c, k, v, m, x_bytes, kernel)
    return cost.t_bound * 1e3, cost.bound_by


def compare(name: str, got, want, x, centroids, *, exact: bool, rtol: float) -> float:
    """Fail unless every row agrees (bytewise when `exact`) or sits on a
    near-tie of the plain version's fp32 distances. Returns the max abs
    error over the rows without a tie."""
    from repro_torch.testing import rows_near_tie

    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype")
    g, w = got.float(), want.float()
    if exact:
        bad = (g != w).any(dim=1)
    else:
        bad = ((g - w).abs() > rtol * max(1.0, w.abs().max().item())).any(dim=1)
    tie = rows_near_tie(x, centroids, TIE_EPS)
    unexplained = bad & ~tie
    check(not unexplained.any().item(),
          f"{name}: {int(unexplained.sum())} rows disagree off a near-tie "
          f"(max err {(g - w).abs().max().item():.3g})")
    clean = ~tie
    err = (g[clean] - w[clean]).abs().max().item() if clean.any() else 0.0
    if bad.any():
        log(f"  {name}: {int(bad.sum())} rows differ, all on near-ties")
    return err


def compare_codes(name: str, got, want, x, centroids) -> float:
    """Fail unless the int32 codes agree wherever the two choices' fp32
    distances do not tie (relative gap above TIE_EPS). Returns the largest
    |d(got) - d(want)| over all codes, d the fp32 distance of the chosen
    centroid: how much farther the kernel's choice is (0 where all agree)."""
    from repro_torch.core import pq
    from repro_torch.testing import tie_gaps

    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.int32, f"{name}: shape/dtype")
    gaps = tie_gaps(x, centroids, got, want)
    check(bool((gaps <= TIE_EPS).all()), f"{name}: {int((gaps > TIE_EPS).sum())} codes differ "
                                         f"off a near-tie")
    if gaps.numel():
        log(f"  {name}: {gaps.numel()} codes differ, all on near-ties")
    if not got.numel():
        return 0.0
    dists = pq.pairwise_sq_dists(pq.split_subvectors(x.float(), centroids.shape[-1]),
                                 centroids.float())
    d_got, d_want = (dists.gather(-1, c.long().to(dists.device)[..., None]) for c in (got, want))
    return (d_got - d_want).abs().max().item()


def make_site(n, c, m, gen, dev, dtype=torch.float32, k=16, v=32):
    from repro_torch.core import quant

    x = torch.randn(n, c * v, generator=gen).to(dev, dtype)
    p = torch.randn(c, k, v, generator=gen).to(dev)
    qt = quant.quantize_table(torch.randn(c, k, m, generator=gen), m_shared=True)
    return x, p, qt.q.to(dev), qt.scale.to(dev)


# each kernel's row in the JSON line: its times at its site at decode (N = 4);
# its max_abs_err over the path shapes and the ragged sweep's float32 calls
MAIN_SITE = {"fused_decode": "q/o", "lut_amm_v2": "down", "lut_amm_v1": "q/o", "encode": "q/o"}


def phase_kernels(dev) -> dict:
    from repro_torch.kernels import dist_argmin as enc_mod
    from repro_torch.kernels import fused_decode as fused_mod
    from repro_torch.kernels import lut_amm as lut_mod
    from repro_torch.kernels import ref
    from repro_torch.testing import LAYOUTS, RAGGED, make_amm_inputs, quantize_np

    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)      # > 50 MB of L2
    results = {name: {"err": 0.0} for name in MAIN_SITE}

    def note_err(name: str, err: float) -> None:
        results[name]["err"] = max(results[name]["err"], err)

    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: one.zero_(), flush)
    log(f"[kernels] event floor: a 1-element zero_ timed the same way takes {floor_ms:.5f} ms")
    log("[kernels] path shapes, m-shared scale, float32: median ms (L2 flushed); net = ms less "
        "the event floor")
    log("  site     N    kernel        ms       net_ms    plain_ms  bound_ms  "
        "dense_matmul_ms (context)  host_us")
    for n in PATH_N:
        for site, c, m in SITES:
            x, p, q, s = make_site(n, c, m, gen, dev)
            want = ref.fused_decode_plain(x, p, q, s)
            out2 = lut_mod.lut_amm_v2(x, p, q, s)
            torch.cuda.synchronize()
            note_err("lut_amm_v2", compare(f"lut_amm_v2 {site} N={n}", out2, want, x, p,
                                           exact=True, rtol=0))
            kernels = [("lut_amm_v2", lut_mod.lut_amm_v2, ref.fused_decode_plain)]
            if fused_mod.fits(c, 16, 32):
                out3 = fused_mod.fused_decode(x, p, q, s)
                torch.cuda.synchronize()
                note_err("fused_decode", compare(f"fused_decode {site} N={n}", out3, want, x, p,
                                                 exact=True, rtol=0))
                # both kernels run the same device encode: equal without exception
                check(torch.equal(out3, out2), f"fused != v2 bytewise at {site} N={n}")
                kernels.insert(0, ("fused_decode", fused_mod.fused_decode,
                                   ref.fused_decode_plain))
            # v1: the plain version sums in the kernel's order -> bytewise
            out1 = lut_mod.lut_amm_v1(x, p, q, s)
            note_err("lut_amm_v1", compare(f"lut_amm_v1 {site} N={n}", out1,
                                           ref.lut_amm_v1_plain(x, p, q, s), x, p, exact=True,
                                           rtol=0))
            kernels.append(("lut_amm_v1", lut_mod.lut_amm_v1, ref.lut_amm_v1_plain))
            note_err("encode", compare_codes(f"encode {site} N={n}", enc_mod.encode(x, p),
                                             ref.encode_plain(x, p), x, p))
            kernels.append(("encode", lambda x, p, q, s: enc_mod.encode(x, p),
                            lambda x, p, q, s: ref.encode_plain(x, p)))
            w_dense = torch.randn(c * 32, m, generator=gen).to(dev)
            mm_ms = time_ms(lambda: x @ w_dense, flush)
            for name, fn, plain in kernels:
                kms = time_ms(lambda: fn(x, p, q, s), flush)
                plain_ms = time_ms(lambda: plain(x, p, q, s), flush, reps=10)
                hus = host_us(lambda: fn(x, p, q, s))
                bms, by = bound_ms(n, c, 16, 32, m, 4, kernel=name)
                log(f"  {site:8s} {n:<4d} {name:12s} {kms:.5f}  {kms - floor_ms:.5f}  "
                    f"{plain_ms:.5f}  {bms:.5f}  {mm_ms:.5f}                    {hus:.1f}")
                if n == 4 and site == MAIN_SITE[name]:
                    results[name].update(ms=kms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    sweep_launches(gen, dev, flush, note_err)
    ragged = 0
    for shape in RAGGED:
        for li, layout in enumerate(LAYOUTS):
            nn, d, m, k, v = shape
            xn, pn, tn, bn = make_amm_inputs(nn, d, m, k, v, seed=SEED + li)
            qn, sn = quantize_np(tn, layout)
            p, q, s, b = (torch.from_numpy(a).to(dev) for a in (pn, qn, sn, bn))
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(xn).to(dev, dtype)
                for act in ("none", "relu", "silu", "gelu", "relu2"):
                    for bias in (None, b):
                        want = ref.fused_decode_plain(x, p, q, s, bias=bias, act=act)
                        for name, fn in (("fused_decode", fused_mod.fused_decode),
                                         ("lut_amm_v2", lut_mod.lut_amm_v2)):
                            got = fn(x, p, q, s, bias=bias, act=act)
                            torch.cuda.synchronize()
                            # m-shared/scalar with exact epilogue math: bytewise;
                            # else fp32 sums reordered (and exp/tanh, bf16 ulps)
                            exact = s.shape[0] == 1 and act in ("none", "relu", "relu2")
                            rtol = 8e-3 if dtype == torch.bfloat16 else KERNEL_ATOL
                            err = compare(f"{name} {shape} {layout} {act} {dtype}", got, want,
                                          x, p, exact=exact, rtol=rtol)
                            if dtype == torch.float32:
                                note_err(name, err)
                            ragged += 1
                for bc in (None, 1):
                    got = lut_mod.lut_amm_v1(x, p, q, s, block_c=bc)
                    err = compare(f"lut_amm_v1 {shape} {layout} bc={bc} {dtype}", got,
                                  ref.lut_amm_v1_plain(x, p, q, s, block_c=bc), x, p, exact=True,
                                  rtol=0)
                    if dtype == torch.float32:
                        note_err("lut_amm_v1", err)
                    ragged += 1
                if li == 0:
                    err = compare_codes(f"encode {shape} {dtype}", enc_mod.encode(x, p),
                                        ref.encode_plain(x, p), x, p)
                    if dtype == torch.float32:
                        note_err("encode", err)
                    ragged += 1
    ragged += sweep_ragged_launches(dev, note_err)
    wide_sites(dev, flush, note_err)
    log(f"[kernels] ragged sweep: {ragged} kernel calls agree with the plain versions; "
        f"max abs err (float32, off ties): "
        + ", ".join(f"{k} {r['err']:.3g}" for k, r in results.items()))
    del flush
    return results


def sweep_launches(gen, dev, flush, note_err) -> None:
    """Every launch the tuner can choose at the path shapes, for every
    kernel: fused and v2 (rows per N tile, M tile), v1 (the same and its
    chunk of the sum) and the encode (rows and codebooks per block). Each
    must equal its plain version bytewise (m-shared scale; fused == v2 too)
    and the encode's codes the plain version's off near-ties; a launch that
    does not fit a block is refused (ValueError), as the tuner skips it.
    Logs the best and the default launch's time per kernel and shape."""
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import dist_argmin as enc_mod
    from repro_torch.kernels import fused_decode as fused_mod
    from repro_torch.kernels import lut_amm as lut_mod

    log("[sweep] every kernel over the tuner's launches at the path shapes (m-shared, float32); "
        "median us, L2 flushed")
    points = refused = 0
    for n in PATH_N:
        for site, c, m in SITES:
            x, p, q, s = make_site(n, c, m, gen, dev)
            want = ref.fused_decode_plain(x, p, q, s)
            v1_want = {}
            kernels = [("lut_amm_v2", lut_mod.lut_amm_v2)]
            if fused_mod.fits(c, 16, 32):
                kernels.insert(0, ("fused_decode", fused_mod.fused_decode))
            times = {name: [] for name, _ in kernels + [("lut_amm_v1", None), ("encode", None)]}

            def timed(name, fn, launch):
                nonlocal points
                times[name].append((time_ms(fn, flush, reps=10) * 1e3, launch))
                points += 1

            for cfg in autotune.candidates("lut_amm", n, m, c, 16, 32, 2):
                launch = autotune.cluster_launch(cfg)
                outs = []
                for name, fn in kernels:
                    try:
                        out = fn(x, p, q, s, **launch)
                    except ValueError:
                        refused += 1
                        continue
                    note_err(name, compare(f"{name} {site} N={n} {launch}", out, want, x, p,
                                           exact=True, rtol=0))
                    outs.append(out)
                    timed(name, lambda: fn(x, p, q, s, **launch), launch)
                if len(outs) == 2:
                    check(torch.equal(*outs), f"fused != v2 bytewise at {site} N={n} {launch}")
            for cfg in autotune.candidates("lut_amm", n, m, c, 16, 32, 1):
                launch = autotune.v1_launch(cfg)
                try:
                    out = lut_mod.lut_amm_v1(x, p, q, s, **launch)
                except ValueError:
                    refused += 1
                    continue
                bc = launch["block_c"]
                if bc not in v1_want:
                    v1_want[bc] = ref.lut_amm_v1_plain(x, p, q, s, block_c=bc)
                note_err("lut_amm_v1", compare(f"lut_amm_v1 {site} N={n} {launch}", out,
                                               v1_want[bc], x, p, exact=True, rtol=0))
                timed("lut_amm_v1", lambda: lut_mod.lut_amm_v1(x, p, q, s, **launch), launch)
            codes = ref.encode_plain(x, p)
            for cfg in autotune.candidates("encode", n, 0, c, 16, 32):
                launch = {"block_n": cfg.block_n, "block_c": cfg.block_c}
                try:
                    out = enc_mod.encode(x, p, **launch)
                except ValueError:
                    refused += 1
                    continue
                note_err("encode", compare_codes(f"encode {site} N={n} {launch}", out, codes,
                                                 x, p))
                timed("encode", lambda: enc_mod.encode(x, p, **launch), launch)
            defaults = dict(kernels, lut_amm_v1=lut_mod.lut_amm_v1,
                            encode=lambda x, p, q, s: enc_mod.encode(x, p))
            for name, fn in defaults.items():
                default_us = time_ms(lambda: fn(x, p, q, s), flush, reps=10) * 1e3
                t_us, launch = min(times[name], key=lambda t: t[0])
                log(f"  {site:8s} N={n:<4d} {name:12s} best {t_us:8.2f} us {launch}; "
                    f"default {default_us:8.2f} us")
    log(f"[sweep] {points} launches agree with their plain versions (and fused == v2); "
        f"{refused} refused as too large for a block")


def sweep_ragged_launches(dev, note_err) -> int:
    """The ragged shapes (C = 1..20, which take every cluster size from 1 to
    16, and C = 5, 6, 20 not divisible by theirs; N not a multiple of the N
    tile) under every N tile (the table staged where its rows are 16-byte
    aligned, M = 48, 144 and 384, else gathered), in float32 and bfloat16:
    fused == v2 == plain bytewise on m-shared scales, within KERNEL_ATOL
    per codebook; v1 with its chunk of the sum at the reference's, 1 and C,
    bytewise with its plain version on both layouts; the encode under every
    launch the tuner can choose there, codes equal off near-ties. Returns
    the number of kernel calls."""
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import dist_argmin as enc_mod
    from repro_torch.kernels import fused_decode as fused_mod
    from repro_torch.kernels import lut_amm as lut_mod
    from repro_torch.testing import CLUSTER_SHAPES, make_amm_inputs, quantize_np

    calls = 0
    for i, shape in enumerate(CLUSTER_SHAPES):
        nn, d, m, k, v = shape
        for layout in ("m_shared", "per_codebook"):
            xn, pn, tn, bn = make_amm_inputs(nn, d, m, k, v, seed=SEED + 10 + i)
            qn, sn = quantize_np(tn, layout)
            p, q, s, b = (torch.from_numpy(a).to(dev) for a in (pn, qn, sn, bn))
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(xn).to(dev, dtype)
                want = ref.fused_decode_plain(x, p, q, s, bias=b, act="relu")
                exact = layout == "m_shared"
                rtol = 8e-3 if dtype == torch.bfloat16 else KERNEL_ATOL
                v1_want = {bc: ref.lut_amm_v1_plain(x, p, q, s, block_c=bc)
                           for bc in (None, 1, d // v)}
                for rows in lut_mod.ROW_TILES:
                    outs = []
                    for name, fn in (("fused_decode", fused_mod.fused_decode),
                                     ("lut_amm_v2", lut_mod.lut_amm_v2)):
                        got = fn(x, p, q, s, bias=b, act="relu", rows=rows)
                        err = compare(f"{name} {shape} {layout} {dtype} rows={rows}", got, want,
                                      x, p, exact=exact, rtol=rtol)
                        if dtype == torch.float32:
                            note_err(name, err)
                        outs.append(got)
                        calls += 1
                    if exact:
                        check(torch.equal(*outs), f"fused != v2 at {shape} {dtype} rows={rows}")
                    for bc, v1 in v1_want.items():
                        got = lut_mod.lut_amm_v1(x, p, q, s, block_c=bc, rows=rows)
                        err = compare(f"lut_amm_v1 {shape} {layout} {dtype} rows={rows} bc={bc}",
                                      got, v1, x, p, exact=True, rtol=0)
                        if dtype == torch.float32:
                            note_err("lut_amm_v1", err)
                        calls += 1
                if exact:
                    codes = ref.encode_plain(x, p)
                    for cfg in autotune.candidates("encode", nn, 0, d // v, k, v):
                        err = compare_codes(f"encode {shape} {dtype} {cfg}",
                                            enc_mod.encode(x, p, block_n=cfg.block_n,
                                                           block_c=cfg.block_c), codes, x, p)
                        if dtype == torch.float32:
                            note_err("encode", err)
                        calls += 1
    return calls


def wide_sites(dev, flush, note_err) -> None:
    """Sites past the kernels' first envelope (V = 64; K = 512, 384 and 300,
    codes held in two bytes and the table ring in two equal TMA boxes per
    codebook, or gathered from global memory where such boxes would not
    start aligned; C = 128 at V = 8) at the path's token counts: fused (where it fits) == v2 ==
    plain and v1 == plain bytewise on m-shared scales, in float32 and
    bfloat16, the encode's codes equal off near-ties; the fit rule picks v2
    where the fused kernel's codebooks do not fit. Logs each kernel's time
    at N = 4."""
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import dist_argmin as enc_mod
    from repro_torch.kernels import fused_decode as fused_mod
    from repro_torch.kernels import lut_amm as lut_mod
    from repro_torch.testing import WIDE_SITES, make_amm_inputs, quantize_np

    calls = 0
    for i, (c, k, v, m) in enumerate(WIDE_SITES):
        fits = fused_mod.fits(c, k, v)
        check(autotune.fit_version(c, k, v) == (3 if fits else 2),
              f"fit rule at (C, K, V) = {(c, k, v)}")
        for n in PATH_N:
            xn, pn, tn, _ = make_amm_inputs(n, c * v, m, k, v, seed=SEED + 30 + i)
            qn, sn = quantize_np(tn, "m_shared")
            p, q, s = (torch.from_numpy(a).to(dev) for a in (pn, qn, sn))
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(xn).to(dev, dtype)
                want = ref.fused_decode_plain(x, p, q, s)
                kernels = [("lut_amm_v2", lut_mod.lut_amm_v2)]
                if fits:
                    kernels.append(("fused_decode", fused_mod.fused_decode))
                outs = []
                for name, fn in kernels:
                    out = fn(x, p, q, s)
                    err = compare(f"{name} wide {(c, k, v, m)} N={n} {dtype}", out, want, x.float(),
                                  p, exact=True, rtol=0)
                    outs.append(out)
                    if dtype == torch.float32:
                        note_err(name, err)
                check(all(torch.equal(o, outs[0]) for o in outs),
                      f"fused != v2 at wide {(c, k, v, m)} N={n}")
                out1 = lut_mod.lut_amm_v1(x, p, q, s)
                err = compare(f"lut_amm_v1 wide {(c, k, v, m)} N={n} {dtype}", out1,
                              ref.lut_amm_v1_plain(x, p, q, s), x.float(), p, exact=True, rtol=0)
                codes = enc_mod.encode(x, p)
                err_e = compare_codes(f"encode wide {(c, k, v, m)} N={n} {dtype}", codes,
                                      ref.encode_plain(x, p), x, p)
                if dtype == torch.float32:
                    note_err("lut_amm_v1", err)
                    note_err("encode", err_e)
                calls += len(kernels) + 2
            if n == PATH_N[0]:
                x = torch.from_numpy(xn).to(dev)
                times = {name: time_ms(lambda: fn(x, p, q, s), flush, reps=10) * 1e3
                         for name, fn in kernels + [("lut_amm_v1", lut_mod.lut_amm_v1),
                                                    ("encode", lambda x, p, q, s:
                                                     enc_mod.encode(x, p))]}
                log(f"  wide site (C, K, V, M) = {(c, k, v, m)} N={n}: "
                    + ", ".join(f"{name} {t:.2f} us" for name, t in times.items()))
    log(f"[kernels] wide sites: {calls} kernel calls agree with the plain versions "
        f"(V = 64, K = 512, 384 and 300, C = 128; float32 and bfloat16)")


# ---------------------------------------------------------------------------
# phase 3: the slice, card against CPU, at full width and 2 layers
# ---------------------------------------------------------------------------

def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


class TieRecorder:
    """Wraps the linear of the attention and MLP modules to find where the
    card may have picked other codes than the CPU: at each LUT site, the CPU
    run records its codes and its fp32 near-ties; the card run, which follows
    with the same sequence of sites, encodes its own inputs (which carry the
    card's rounding of everything upstream) and marks each (row, position)
    whose codes differ from the CPU's or sit on a near-tie. With one LUT
    layer, the model's last, a flip at a k or v site reaches every later
    position of its row through the cache; any other site's, only its own."""

    def __init__(self):
        from repro_torch.models import attention, mlp

        self.mods = (attention, mlp)
        self.real = attention.linear
        self.causal: dict[int, int] = {}
        self.point: set[tuple[int, int]] = set()
        self.side = None                 # "cpu", "card" or None (not recording)
        self.cache_len: list[int] = []
        self.sites: list = []

    def __enter__(self):
        from repro_torch.core.amm import Mode
        from repro_torch.kernels.ref import encode_ref
        from repro_torch.testing import rows_near_tie

        def linear(site, p, x):
            if self.side is not None and site.mode == Mode.LUT_INFER:
                b, s = x.shape[0], x.shape[1]
                xf = x.reshape(b * s, -1)
                if self.side == "cpu":
                    self.sites.append((encode_ref(xf, p["centroids"]),
                                       rows_near_tie(xf, p["centroids"], TIE_EPS)))
                else:
                    codes_cpu, near = self.sites.pop(0)
                    codes = encode_ref(xf, p["centroids"]).cpu()
                    flipped = (codes != codes_cpu).any(dim=1) | near
                    for bi, si in flipped.reshape(b, s).nonzero().tolist():
                        pos = self.cache_len[bi] + si
                        if site.name in ("attn/k", "attn/v"):
                            self.causal[bi] = min(self.causal.get(bi, pos), pos)
                        else:
                            self.point.add((bi, pos))
            return self.real(site, p, x)

        for mod in self.mods:
            mod.linear = linear
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.linear = self.real
        return False

    def tainted(self, b: int, pos: int) -> bool:
        return pos >= self.causal.get(b, math.inf) or (b, pos) in self.point


def run_parity(label: str, bundle, params_cpu, params_gpu, dev, gen) -> dict:
    """A prefill chunk and greedy decode steps on the card and on the CPU
    from the same params; logits must agree off code flips and near-ties."""
    arch = bundle.arch
    b, chunk, n_decode = 4, 32, 6
    tokens = torch.randint(0, arch.vocab, (b, chunk), generator=gen, dtype=torch.int32)
    caches = {d: bundle.init_caches(b, 64, dtype=torch.float32, device=d)
              for d in ("cpu", dev)}
    cache_len = torch.zeros(b, dtype=torch.long)
    checked = excused = tok_equal = tok_tie = 0
    max_err = 0.0
    with TieRecorder() as rec, torch.inference_mode():
        for step in range(1 + n_decode):
            rec.cache_len = cache_len.tolist()
            rec.side = "cpu"
            lc, _ = bundle.forward_step(params_cpu, {"tokens": tokens, "cache_len": cache_len},
                                        caches["cpu"])
            rec.side = "card"
            lg, _ = bundle.forward_step(params_gpu, {"tokens": tokens.to(dev),
                                                     "cache_len": cache_len},
                                        caches[dev])
            rec.side = None
            lg = lg.float().cpu()
            check(bool(torch.isfinite(lg).all()), f"non-finite logits on the card, step {step}")
            for bi in range(b):
                for si in range(tokens.shape[1]):
                    pos = int(cache_len[bi]) + si
                    if rec.tainted(bi, pos):
                        excused += 1
                        continue
                    err = (lg[bi, si] - lc[bi, si]).abs().max().item()
                    check(err <= LOGIT_ATOL, f"{label}: logits differ by {err:.3g} at row {bi} "
                                             f"position {pos} without a near-tie")
                    max_err = max(max_err, err)
                    checked += 1
                    top2 = torch.topk(lc[bi, si], 2).values
                    if int(lg[bi, si].argmax()) == int(lc[bi, si].argmax()):
                        tok_equal += 1
                    else:
                        check((top2[0] - top2[1]).item() <= 2 * LOGIT_ATOL,
                              f"{label}: greedy token differs at row {bi} position {pos}")
                        tok_tie += 1
            cache_len += tokens.shape[1]
            tokens = lc[:, -1].argmax(-1).to(torch.int32)[:, None]   # teacher-forced greedy
    total = checked + excused
    log(f"[slice] {label}: 2-layer full-width qwen3_1p7b, card vs CPU over {1 + n_decode} "
        f"forwards: {checked}/{total} positions compared (max logit err {max_err:.3g}, tol "
        f"{LOGIT_ATOL}), {excused} at or after a code flip or near-tie; greedy tokens equal "
        f"{tok_equal}, logit near-ties {tok_tie}")
    check(checked >= total // 2, f"{label}: too few positions free of near-ties to show parity")
    return {"positions_checked": checked, "max_logit_err": max_err, "forwards": 1 + n_decode}


def pin_version(bundle, version: int, counts: list[int]) -> list[str]:
    """Autotune records pinning `version` at every LUT kernel site for both
    the card and the CPU; returns their keys."""
    from repro_torch.kernels import autotune
    from repro_torch.serving.engine import lut_kernel_signatures

    cache = autotune.get_cache()
    keys = []
    for m, c, k, v in lut_kernel_signatures(bundle):
        for n in counts:
            for backend in (autotune.BACKEND_CUDA, "torch-cpu"):
                key = autotune.shape_key("lut_amm", n, m, c, k, v, "float32", backend)
                cache.put(key, {"block_n": 0, "block_m": 0, "block_c": 0, "version": version,
                                "measured": False, "source": "pinned"})
                keys.append(key)
    return keys


def phase_slice_parity(dev, scratch: Path) -> dict:
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.kernels import autotune, counters
    from repro_torch.serving.artifact import load_artifact, save_artifact

    arch = dataclasses.replace(get_arch("qwen3_1p7b"), n_layers=2, lut_use_kernel=True)
    bundle = build_model(arch, Mode.LUT_INFER)
    gen = torch.Generator().manual_seed(SEED)
    params_cpu = bundle.init(gen, device="cpu")
    for layer in params_cpu["segments"][1]:
        for site in (*layer["attn"].values(), *layer["mlp"].values()):
            if "centroids" in site:
                # centroids at the activations' scale, where k-means puts them
                site["centroids"].mul_(50.0)
    run_parity("random params, fit rule", bundle, params_cpu, tree_to(params_cpu, dev), dev, gen)

    # the same params through an artifact the port writes, loaded back on
    # each device, with every LUT site pinned to v1
    t0 = time.perf_counter()
    save_artifact(scratch / "slice", bundle, params_cpu, autotune_snapshot=False)
    art_cpu = load_artifact(scratch / "slice", device="cpu")
    art_gpu = load_artifact(scratch / "slice", device=dev)
    log(f"[slice] 2-layer artifact written and loaded on CPU and card in "
        f"{time.perf_counter() - t0:.1f}s")
    keys = pin_version(art_gpu.bundle, 1, [4, 4 * 32])
    counters.reset()
    res = run_parity("artifact, every site pinned to v1", art_gpu.bundle, art_cpu.params,
                     art_gpu.params, dev, gen)
    launches = counters.launches()
    shutil.rmtree(scratch / "slice")
    entries = autotune.get_cache().load()
    for key in keys:
        entries.pop(key)
    n_sites = len(art_gpu.bundle.lut_sites())
    log(f"[slice] launches with v1 pinned: {counters.launch_line()}")
    check(launches["lut_amm_v1"] == n_sites * res["forwards"],
          f"v1 launched {launches['lut_amm_v1']} times, expected {n_sites} per forward")
    check(launches["fused_decode"] == launches["lut_amm_v2"] == 0,
          "a site ran another kernel than the pinned v1")
    return {"v1_launches": launches["lut_amm_v1"]}


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

SAMPLED = (2, 5)                 # burst requests that sample; the rest are greedy


def phase4_burst(vocab: int) -> list[tuple[list[int], object]]:
    """8 requests (prompts 8-60 tokens), the same on every call; requests
    SAMPLED draw at temperature 0.8, top-k 50, top-p 0.9."""
    from repro_torch.serving.sampling import SamplingParams

    gen = torch.Generator().manual_seed(SEED + 1)
    burst = []
    for i in range(8):
        plen = int(torch.randint(8, 61, (1,), generator=gen))
        prompt = torch.randint(0, vocab, (plen,), generator=gen).tolist()
        burst.append((prompt, SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=SEED + i)
                      if i in SAMPLED else None))
    return burst


def run_burst(eng, burst, *, all_ok: bool = True) -> tuple[list, dict]:
    """Submit every (prompt, sampling) of the burst, 16 new tokens each, and
    run the engine dry; returns the requests in submission order and the
    engine's stats with the burst's wall time. With `all_ok` every request
    must finish "ok" with 16 tokens in the vocab."""
    vocab = eng.bundle.arch.vocab
    eng.finished.clear()
    eng.reset_stats()
    t0 = time.perf_counter()
    rids = [eng.submit(prompt, max_tokens=16, sampling=sampling) for prompt, sampling in burst]
    done = {r.rid: r for r in eng.run_until_done()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(sorted(done) == sorted(rids), "not every request finished")
    reqs = [done[rid] for rid in rids]
    check(all(0 <= t < vocab for r in reqs for t in r.out_tokens), "a token outside the vocab")
    if all_ok:
        check(all(r.status == "ok" for r in reqs), f"statuses {[r.status for r in reqs]}")
        check(all(len(r.out_tokens) == 16 for r in reqs), "every request must return 16 tokens")
    return reqs, dict(eng.stats(), wall=wall)


def tune_encode_records(bundle, counts: list[int], dev) -> int:
    """The deployment's own tuning call for the encode records an artifact's
    snapshot ships: every codebook signature of the bundle's LUT sites at
    each token count, timed on the card. Returns the number tuned."""
    from repro_torch.kernels import autotune, measure
    from repro_torch.serving.engine import lut_kernel_signatures

    sigs = sorted({(c, k, v) for _, c, k, v in lut_kernel_signatures(bundle)})
    for c, k, v in sigs:
        for n in counts:
            autotune.tune("encode", n, 0, c, k, v, save=False,
                          measure=measure.measure_encode(n, c, k, v, device=dev))
    return len(sigs) * len(counts)


def analytic_vs_measured(bundle, counts: list[int], dev, scratch: Path) -> None:
    """Time, per site signature and token count, the launch the analytic
    model would choose (its version at the wrapper's default launch) against
    the measured record's: what serving without REPRO_AUTOTUNE_MEASURE costs."""
    from repro_torch.kernels import autotune, measure
    from repro_torch.serving.engine import lut_kernel_signatures

    model = autotune.AutotuneCache(scratch / "analytic.json")
    log("[tuner] analytic choice (default launch) vs measured record, median us on the card:")
    for m, c, k, v in lut_kernel_signatures(bundle):
        for n in counts:
            a_cfg, a_rec = autotune.tune("lut_amm", n, m, c, k, v, cache=model, save=False)
            m_ver, m_cfg, _ = autotune.kernel_choice(n, m, c, k, v)
            fn = measure.measure_lut_amm(n, m, c, k, v, device=dev)
            a_us, m_us = fn(a_cfg, a_rec["version"]) * 1e6, fn(m_cfg, m_ver) * 1e6
            log(f"  N={n} {(m, c, k, v)}: analytic v{a_rec['version']} default {a_us:.1f} us; "
                f"measured v{m_ver} block_m {m_cfg.block_m} block_c {m_cfg.block_c} "
                f"{m_us:.1f} us; ratio {a_us / m_us:.2f}")


def phase_serve(dev, scratch: Path) -> dict:
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.kernels import autotune, counters
    from repro_torch.launch.serve import chosen_versions
    from repro_torch.serving import artifact
    from repro_torch.serving.engine import ServingEngine

    arch = dataclasses.replace(get_arch("qwen3_1p7b"), lut_use_kernel=True)
    bundle = build_model(arch, Mode.LUT_INFER)
    n_slots, chunk = 4, 32
    counts = [n_slots, n_slots * chunk]
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    log(f"[serve] {arch.name}: {arch.n_layers} layers, d_model {arch.d_model}, vocab {arch.vocab}, "
        f"{len(bundle.lut_sites())} LUT sites; init {time.perf_counter() - t0:.1f}s")

    # the main path: export (encode records tuned for the snapshot, the
    # artifact written), load, measured warm-up, two bursts
    counters.reset()
    t0 = time.perf_counter()
    n_enc = tune_encode_records(bundle, counts, dev)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    artifact.save_artifact(scratch / "main", bundle, params)
    del params
    torch.cuda.empty_cache()
    snap = json.loads((scratch / "main" / artifact._AUTOTUNE).read_text())["entries"]
    n_snap = sum(key.startswith("encode|") and rec["measured"] for key, rec in snap.items())
    check(n_snap == n_enc, f"the snapshot ships {n_snap} measured encode records, not {n_enc}")
    log(f"[serve] export: {n_enc} encode records measured in {t_enc:.3f}s, save_artifact "
        f"{time.perf_counter() - t0:.1f}s, snapshot of {len(snap)} records")
    t0 = time.perf_counter()
    art = artifact.load_artifact(scratch / "main", device=dev)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = ServingEngine(art.bundle, art.params, n_slots=n_slots, max_seq=256,
                        prefill_chunk=chunk, device=dev)
    t_tune = time.perf_counter() - t0
    tuner = counters.launches()             # export and warm-up: the tuner's timing runs
    versions = chosen_versions(art.bundle, counts, "float32", dev)
    log(f"[serve] load_artifact {t_load:.1f}s; measured warm-up {t_tune:.3f}s, "
        f"{eng.n_lut_shapes_tuned} lut_amm shapes tuned; kernel version per site "
        f"(M, C, K, V) at N={counts}: " + ", ".join(f"{s}: {v}" for s, v in versions.items()))
    cache = autotune.get_cache()
    for (m, c, k, v) in versions:
        for n in counts:
            for kind, mm in (("lut_amm", m), ("encode", 0)):
                rec = cache.get(autotune.shape_key(kind, n, mm, c, k, v, "float32",
                                                   autotune.BACKEND_CUDA))
                check(rec is not None and rec["measured"], f"no measured {kind} record at "
                                                           f"N={n} {(m, c, k, v)}")
                log(f"  record {kind} N={n} {(m, c, k, v)}: version {rec.get('version', '-')} "
                    f"block_m {rec['block_m']} block_c {rec['block_c']} "
                    f"{rec['predicted_us']:.1f} us")
    eng.warmup()
    before = counters.launches()
    torch.cuda.reset_peak_memory_stats(dev)
    burst = phase4_burst(arch.vocab)
    runs = [run_burst(eng, burst) for _ in range(2)]
    total = counters.launches()
    served = {k: total[k] - before[k] for k in total}
    for i, (reqs, st) in enumerate(runs):
        n_tok = sum(len(r.out_tokens) for r in reqs)
        log(f"[serve] burst {i + 1}: 8 requests ({len(SAMPLED)} sampled), {n_tok} tokens in "
            f"{st['wall']:.3f}s ({n_tok / st['wall']:.2f} tok/s); prefill "
            f"{st['prefill_tokens']} tok / {st['prefill_forwards']} fwd "
            f"({st['prefill_tok_s']:.2f} tok/s), decode {st['decode_tokens']} tok / "
            f"{st['decode_forwards']} fwd ({st['decode_tok_s']:.2f} tok/s)")
    log(f"[serve] peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
        f"launches over the main path (export, load, warm-up, 2 bursts): "
        f"{counters.launch_line()}; by the tuner (export and warm-up timing): "
        + " ".join(f"{k}={v}" for k, v in tuner.items())
        + "; in the bursts: " + " ".join(f"{k}={v}" for k, v in served.items())
        + f"; plain-version calls {counters.plain_calls()}")
    tok1, tok2 = ([r.out_tokens for r in reqs] for reqs, _ in runs)
    check(all(tok1[i] == tok2[i] for i in SAMPLED), "sampled tokens differ between the runs")
    log(f"[serve] sampled requests replay identically; greedy requests identical: "
        f"{all(tok1[i] == tok2[i] for i in range(8))}")

    # every forward's LUT sites ran the version the records chose, nothing else
    per_n = {n: {1: 0, 2: 0, 3: 0} for n in counts}
    for site in art.bundle.lut_sites():
        sig = (site.d_out, site.d_in // site.lut.v, site.lut.k, site.lut.v)
        for j, n in enumerate(counts):
            per_n[n][versions[sig][j]] += 1
    expect = {1: 0, 2: 0, 3: 0}
    for _, st in runs:
        for ver in expect:
            expect[ver] += (st["prefill_forwards"] * per_n[counts[1]][ver]
                            + st["decode_forwards"] * per_n[counts[0]][ver])
    for ver, name in ((1, "lut_amm_v1"), (2, "lut_amm_v2"), (3, "fused_decode")):
        check(served[name] == expect[ver], f"{name} launched {served[name]} times in the "
                                           f"bursts; the records say {expect[ver]}")
    check(served["encode"] == 0, "the model has no encode call site")
    for name in counters.KERNELS:
        check(total[name] > 0, f"{name} was never launched on the main path")
    check(counters.plain_calls() == 0, "the main path reached a plain version")
    analytic_vs_measured(art.bundle, counts, dev, scratch)
    profile = profile_decode(eng, arch.vocab, torch.Generator().manual_seed(SEED + 2))
    return {"launches": total, "served": served, "art": art, "engine": eng, "profile": profile}


def device_times(prof) -> dict[str, float]:
    """Device time (us) of a torch.profiler window by LUT kernel, the rest
    under "other"."""
    by_kernel: dict[str, float] = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0:
            key = next((k for k in ("fused_decode", "lut_amm_v2", "lut_amm_v1", "encode")
                        if f"{k}_kernel" in e.key), "other")
            by_kernel[key] = by_kernel.get(key, 0.0) + t
    return by_kernel


def profile_decode(eng, vocab: int, gen: torch.Generator, n_steps: int = 8) -> tuple[float, float]:
    """Where a decode forward's time goes: torch.profiler's device kernel time
    over a few decode steps of full slots, against their wall time. Returns
    (wall, device busy) per step, in us."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(eng.n_slots):
        eng.submit(torch.randint(0, vocab, (16,), generator=gen).tolist(), max_tokens=64)
    for _ in range(3):
        eng.step()                                # admit, prefill, first decodes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()                            # decode only: every prompt is in
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.abort_all("cancelled")
    by_kernel = device_times(prof)
    busy = sum(by_kernel.values())
    kind = "paged" if eng.paged else "dense"
    log(f"[profile] {n_steps} decode steps (n_slots={eng.n_slots}, {kind} cache): wall "
        f"{wall_us / n_steps:.0f} us per step (profiler on), device busy {busy / n_steps:.0f} us "
        f"per step ({100 * busy / wall_us:.1f}% of wall); device time: "
        + ", ".join(f"{k} {v / n_steps:.0f} us" for k, v in sorted(by_kernel.items())))
    return wall_us / n_steps, busy / n_steps


# ---------------------------------------------------------------------------
# phase 17: the dry run and the H100 roofline of phase 4's decode step
# ---------------------------------------------------------------------------

def _meta_like(tree, memo: dict | None = None):
    """The tree with each card tensor an empty meta tensor of its shape and
    dtype (one per distinct tensor); host tensors as they are."""
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: _meta_like(v, memo) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_like(v, memo) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.device.type != "cpu":
        if id(tree) not in memo:
            memo[id(tree)] = torch.empty(tree.shape, dtype=tree.dtype, device="meta")
        return memo[id(tree)]
    return tree


def phase_dryrun(dev, served: dict) -> dict:
    import numpy as np

    from repro_torch.configs import ModelBundle
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ops import KERNEL_OF_VERSION
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dry_mesh
    from repro_torch.roofline.analysis import analyze_trace, lut_site_cost, memory_stats
    from repro_torch.roofline.op_cost import hotspots, trace_step, tree_bytes
    from repro_torch.train.train_step import make_serve_step

    eng = served["engine"]
    wall_us, busy_us = served["profile"]
    n = eng.n_slots
    # (a) one real decode forward of the engine (its batch captured as it
    # reaches the model) around the allocator's peak
    seen: list[dict] = []
    forward_step = ModelBundle.forward_step

    def capture(self, params, batch, caches, **kw):
        seen.append(batch)
        return forward_step(self, params, batch, caches, **kw)

    toks = np.zeros((n, 1), np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ModelBundle.forward_step = capture
    try:
        eng._forward(toks, np.full((n,), 24, np.int32), np.ones((n,), np.int32))
    finally:
        ModelBundle.forward_step = forward_step
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    check(len(seen) == 1, f"the decode forward reached the model {len(seen)} times")
    batch = seen[0]

    mesh = dry_mesh(1, 1)
    params, caches = _meta_like(eng.params), _meta_like(eng.caches)
    step = make_serve_step(eng.bundle, compute_dtype=eng._compute_dtype)
    _, trace = trace_step(step, params, _meta_like(batch), caches, mesh=mesh)
    want = tree_bytes(eng.params) + tree_bytes(eng.caches) + tree_bytes(batch)
    check(trace.arg_bytes == want, f"the trace's argument bytes {trace.arg_bytes} are not the "
                                   f"engine's params, caches and batch, {want}")
    sites = eng.bundle.lut_sites()
    expect = []
    for site in sites:
        c, k, v, m = site.d_in // site.lut.v, site.lut.k, site.lut.v, site.d_out
        version, _, from_record = autotune.kernel_choice(
            n, m, c, k, v, dtype=autotune.dtype_name(eng._compute_dtype),
            backend=autotune.BACKEND_CUDA)
        check(from_record, f"no record chose the version at {(n, m, c, k, v)}")
        kernel = KERNEL_OF_VERSION[version]
        x_bytes = torch.empty((), dtype=eng._compute_dtype).element_size()
        expect.append((kernel, (n, m, c, k, v), lut_site_cost(n, c, k, v, m, x_bytes, kernel)))
    got = [(s["kernel"], s["shape"], s["cost"]) for s in trace.sites]
    check(sorted(got, key=repr) == sorted(expect, key=repr),
          f"{len(got)} LUT-site charges against {len(sites)} sites, or at other costs")
    roof = analyze_trace(trace)
    mem = memory_stats(trace)
    busy_s = busy_us * 1e-6
    log(f"[dryrun] decode step traced on meta (1, 1): {trace.n_ops} ops in "
        f"{trace.trace_s:.2f}s; {len(got)} LUT sites charged once each (versions "
        + ", ".join(f"{k}: {sum(g[0] == k for g in got)}" for k in sorted({g[0] for g in got}))
        + f"); argument bytes {trace.arg_bytes} = the engine's params, caches and batch")
    log(f"[dryrun] roofline (H100 SXM peaks): t_compute {roof.t_compute * 1e6:.2f} us "
        f"(flops by unit {({u: f'{f:.4g}' for u, f in roof.flops_by_unit.items()})}), t_memory "
        f"{roof.t_memory * 1e6:.2f} us ({roof.hbm_bytes / 1e9:.4f} GB), t_collective "
        f"{roof.t_collective * 1e6:.2f} us -> {roof.bottleneck}; t_bound "
        f"{roof.t_bound * 1e6:.2f} us against phase 4's device busy {busy_us:.1f} us per "
        f"decode step (wall {wall_us:.1f} us): busy / t_bound = {busy_s / roof.t_bound:.2f}")
    for path, c in hotspots(trace, top=4, depth=5):
        log(f"[dryrun]   {c['t_s'] * 1e6:8.1f} us  {c['hbm_bytes'] / 1e9:.4f} GB  {c['ops']:5d} "
            f"ops  {path}")
    log(f"[dryrun] memory: predicted peak {mem['total_hbm_bytes'] / 2**30:.3f} GiB "
        f"(arguments {mem['argument_size_in_bytes'] / 2**30:.3f}, temp "
        f"{mem['temp_size_in_bytes'] / 2**30:.3f}) against max_memory_allocated "
        f"{peak / 2**30:.3f} GiB around one decode forward")
    check(roof.t_bound <= busy_s, f"t_bound {roof.t_bound * 1e6:.2f} us exceeds the measured "
                                  f"device busy time {busy_us:.1f} us per step")
    # (b) the production cell on both meshes
    lines = []
    for multi_pod in (False, True):
        rec, _ = dryrun.trace_cell("qwen3_1p7b", "decode_32k", multi_pod=multi_pod)
        lines.append(dryrun.ok_line(rec))
        log(f"[dryrun] {lines[-1]} kept={rec['kept']} axes={rec['mesh_axes']}")
    return {"t_bound_us": roof.t_bound * 1e6, "busy_us": busy_us,
            "predicted_peak": mem["total_hbm_bytes"], "peak": peak, "lines": lines}


# ---------------------------------------------------------------------------
# phase 5: paged KV cache and speculative decoding at full width
# ---------------------------------------------------------------------------

TOKEN_TIE = 2 * LOGIT_ATOL   # top-2 gap of the plain run's sampler values that explains a flip
KERNEL_OF_VERSION = {1: "lut_amm_v1", 2: "lut_amm_v2", 3: "fused_decode"}


class GapRecorder:
    """Wraps a plain engine's sampler: for every token it draws, records the
    top-2 gap of the sampler's decision values (a greedy row's logits, a
    sampled row's gumbel noise plus filtered scaled logits), keyed (rid,
    token index). Another path may draw another token only where that gap is
    at most TOKEN_TIE: its logits come from other shapes (the verify's 20
    rows, the paged gather, prefix-skipped chunks), equal to float rounding."""

    def __init__(self, eng):
        self.eng = eng
        self.gaps: dict[tuple[int, int], float] = {}

    def __enter__(self):
        from repro_torch.serving import sampling

        eng, real = self.eng, self.eng._sample

        def sample(rows):
            params = [r.sampling if r is not None else sampling.GREEDY for r in eng.slots]
            counts = [len(r.out_tokens) if r is not None else 0 for r in eng.slots]
            vals = sampling.decision_values(rows, *sampling.batch_arrays(params, counts,
                                                                         rows.device))
            top2 = vals.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).cpu().tolist()
            for i, r in enumerate(eng.slots):
                if r is not None:      # the last draw at an index is the one kept
                    self.gaps[(r.rid, len(r.out_tokens))] = gap[i]
            return real(rows)

        eng._sample = sample
        return self

    def __exit__(self, *exc):
        del self.eng._sample
        return False


class LaunchesByN:
    """Kernel launches per (kernel, token count N) of an engine's forwards,
    read from the launch counters around each forward, and which models
    (the target, a speculating engine's draft) ran forwards at each N."""

    def __init__(self, eng):
        self.eng = eng
        self.by_n: dict[int, dict[str, int]] = {}
        self.models: dict[int, set[str]] = {}

    def __enter__(self):
        from repro_torch.kernels import counters

        real = self.eng._forward

        def forward(toks, cache_len, write_len, model=None):
            before = counters.launches()
            out = real(toks, cache_len, write_len, model)
            row = self.by_n.setdefault(toks.size, dict.fromkeys(before, 0))
            self.models.setdefault(toks.size, set()).add("target" if model is None else "draft")
            for k, v in counters.launches().items():
                row[k] += v - before[k]
            return out

        self.prev = self.eng.__dict__.get("_forward")     # a wrapper this one nests in
        self.eng._forward = forward
        return self

    def __exit__(self, *exc):
        if self.prev is None:
            del self.eng._forward
        else:
            self.eng._forward = self.prev
        return False

    def line(self) -> str:
        return "; ".join(f"N={n}: " + " ".join(f"{k}={v}" for k, v in row.items() if v)
                         for n, row in sorted(self.by_n.items()))


def compare_tokens(label: str, got: list, want: list, gaps: dict, tie_codes: int = 0,
                   tied: set = frozenset()) -> int:
    """Each request's tokens against the plain engine's: equal, or equal up
    to a first difference at a near-tie of the plain run (then the rest is
    conditioned on another token and not compared). A shed request is held
    over the tokens it returned. `tie_codes`: the (call, row) pairs of the
    run whose code the kernels picked at a tie of the fp32 expansion (held
    by `hold_sites`); each may explain one request that leaves the plain run
    elsewhere (a flipped code reads another table row: a table entry's
    change, not a rounding). `tied`: the requests shown to have taken a
    decision at a near-tie otherwise than the unsharded model
    (`shadow_verdict`); each may leave it. Returns the number of
    differences."""
    ties = 0
    for g, w in zip(got, want):
        j = next((j for j, (a, b) in enumerate(zip(g.out_tokens, w.out_tokens)) if a != b), None)
        if j is None:
            check(g.status != "ok" or len(g.out_tokens) == len(w.out_tokens),
                  f"{label}: request {w.rid} returned {len(g.out_tokens)} tokens, plain "
                  f"{len(w.out_tokens)}")
            continue
        gap = gaps.get((w.rid, j))
        ties += 1
        if (gap is None or gap > TOKEN_TIE) and g.rid in tied:
            log(f"  {label}: request {w.rid} differs from plain decode from token {j} on (top-2 "
                f"gap {gap:.3g}), after a decision taken at a near-tie (shown above)")
            continue
        if gap is None or gap > TOKEN_TIE:
            check(tie_codes > 0,
                  f"{label}: request {w.rid} differs from plain decode at token {j}, where the "
                  f"plain run's top-2 gap is {gap} (tie bound {TOKEN_TIE}), and no code the "
                  f"kernels picked at a tie is left to explain it")
            tie_codes -= 1
            log(f"  {label}: request {w.rid} differs from plain decode from token {j} on (top-2 "
                f"gap {gap:.3g}), after a code the kernels picked at a tie")
            continue
        log(f"  {label}: request {w.rid} differs from plain decode from token {j} on, at a "
            f"near-tie (top-2 gap {gap:.3g})")
    return ties


def prefix_burst(vocab: int) -> list[tuple[list[int], object]]:
    """8 requests sharing a 48-token prefix (3 pages of 16) plus 4-20 tokens
    of their own, 16 new tokens each, requests SAMPLED sampled; the last is a
    resubmission of the first (16 tokens of its own: 4 full pages, fully
    cached by then, so its last prompt token's write copies a page)."""
    from repro_torch.serving.sampling import SamplingParams

    gen = torch.Generator().manual_seed(SEED + 3)
    prefix = torch.randint(0, vocab, (48,), generator=gen).tolist()
    prompts = []
    for i in range(7):
        own = 16 if i == 0 else int(torch.randint(4, 21, (1,), generator=gen))
        prompts.append(prefix + torch.randint(0, vocab, (own,), generator=gen).tolist())
    prompts.append(list(prompts[0]))
    return [(p, SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=SEED + 10 + i)
             if i in SAMPLED else None) for i, p in enumerate(prompts)]


def plain_run(eng, burst) -> tuple[list, dict, dict]:
    """The plain dense engine's requests, stats and sampler gaps on a burst."""
    with GapRecorder(eng) as rec:
        reqs, st = run_burst(eng, burst)
    return reqs, st, rec.gaps


def driven(label: str, eng, burst, want: list, gaps: dict, *, all_ok: bool = True,
           tag: str = "paged/spec", hold_all: bool = False):
    """One path: the launch counts set to 0 just before the burst and read
    just after (some LUT kernel launched, no plain version called), its
    tokens held against the plain engine's. `hold_all` holds every LUT-site
    call of the burst against the plain versions (`hold_sites`), and lets
    each code picked at a tie explain one request's difference (a trained
    model's inputs sit close to its centroids, where ties are found).
    Returns (requests, stats, launches per N, differences)."""
    from repro_torch.kernels import counters
    from repro_torch.launch.serve import chosen_versions

    counters.reset()
    with LaunchesByN(eng) as by_n, (SiteCalls() if hold_all else contextlib.nullcontext()) as rec:
        reqs, st = run_burst(eng, burst, all_ok=all_ok)
    check(counters.plain_calls() == 0, f"{label}: a plain version ran on the card")
    # every kernel the records choose for the models that ran forwards at an
    # N launched at that N (the draft never runs the verify's N)
    bundles = {"target": eng.bundle,
               "draft": eng.spec.draft_bundle if eng.spec is not None else None}
    for n, row in by_n.by_n.items():
        chosen = {KERNEL_OF_VERSION[ver] for tag in by_n.models[n]
                  for vers in chosen_versions(bundles[tag], [n], "float32",
                                              eng.device).values()
                  for ver in vers}
        check(all(row[k] > 0 for k in chosen), f"{label}: at N={n} the records choose "
                                               f"{sorted(chosen)}; launched {row}")
    tie_codes = 0
    if hold_all:
        held = hold_sites(label, rec.calls)
        tie_codes = sum(len(rows) for rows in held["off_rows"])
        del rec
        log(f"[{tag}] {label}: all {held['sites']} LUT-site calls of the burst ({held['kernels']}) "
            f"equal to the plain lookup of the encode kernel's codes (max abs err "
            f"{held['err']:.3g}); {held['codes_off']} of {held['codes']} codes differ from the "
            f"plain encode's, on {tie_codes} rows, each a tie of the fp32 expansion (at most "
            f"{held['worst_tie']:.3g} of its terms)")
    ties = compare_tokens(label, reqs, want, gaps, tie_codes)
    step_ms = 1e3 * st["decode_s"] / max(st["decode_forwards"], 1)
    log(f"[{tag}] {label}: {sum(len(r.out_tokens) for r in reqs)} tokens in "
        f"{st['wall']:.3f}s; prefill {st['prefill_forwards']} fwd, decode "
        f"{st['decode_forwards']} fwd ({step_ms:.2f} ms each); tokens equal plain decode's "
        f"except {ties} near-tie difference(s); launches by N: {by_n.line()}")
    return reqs, st, by_n.by_n, ties


def spec_line(label: str, st: dict, by_n: dict) -> None:
    log(f"[spec] {label}: acceptance {st['spec_acceptance_rate']:.3f} "
        f"({st['spec_tokens_accepted']}/{st['spec_tokens_proposed']}), "
        f"target_forwards_per_token {st['target_forwards_per_token']:.3f}, rounds "
        f"{st['spec_rounds']}, draft fwd {st['spec_draft_forwards']} (+{st['spec_prefill_forwards']} "
        f"prefill), verify fwd {st['spec_verify_forwards']}, catch-up fwd "
        f"{st['spec_catchup_forwards']}, bonus tokens {st['spec_bonus_tokens']}, pages rewound "
        f"{st['spec_pages_rewound']}")
    check(any(row for n, row in by_n.items() if n == PATH_N[1] and sum(row.values())),
          f"{label}: no kernel launched at the verify shape N={PATH_N[1]}")


def phase_paged_spec(dev, scratch: Path, art, plain) -> dict:
    from repro_torch.configs import build_model
    from repro_torch.core.amm import Mode
    from repro_torch.kernels import autotune
    from repro_torch.launch.serve import chosen_versions
    from repro_torch.serving.engine import ServingEngine, lut_kernel_signatures

    vocab = art.bundle.arch.vocab
    kw = dict(n_slots=plain.n_slots, max_seq=plain.max_seq, prefill_chunk=plain.prefill_chunk,
              device=dev)
    out = {"ties": 0}

    def engine(**extra):
        return ServingEngine(art.bundle, art.params, **kw, **extra)

    # paged, prefix sharing on, the default pool
    pburst = prefix_burst(vocab)
    want, st_d, gaps = plain_run(plain, pburst)
    out["prefix_plain"] = (want, gaps)
    eng = engine(paged=True, page_size=16)
    _, st, _, ties = driven("paged, page_size 16, prefix sharing", eng, pburst, want, gaps)
    out["ties"] += ties
    check(st["prefix_hits"] > 0 and st["cow_copies"] > 0 and st["shed"] == 0,
          f"paged: prefix_hits {st['prefix_hits']}, cow_copies {st['cow_copies']}, "
          f"shed {st['shed']}")
    dense_ms = 1e3 * st_d["decode_s"] / st_d["decode_forwards"]
    paged_ms = 1e3 * st["decode_s"] / st["decode_forwards"]
    log(f"[paged] prefix_hits {st['prefix_hits']} (of {st['prefix_lookups']} lookups), prefill "
        f"tokens skipped {st['prefill_tokens_skipped']}, prefill forwards {st['prefill_forwards']} "
        f"against the dense engine's {st_d['prefill_forwards']} "
        f"({st_d['prefill_forwards'] - st['prefill_forwards']} skipped), cow_copies "
        f"{st['cow_copies']}, kv_pages_peak {st['kv_pages_peak']} of {st['kv_pages_total']}, "
        f"kv_bytes_peak {st['kv_bytes_peak']} (dense layout {st['kv_bytes_dense_equiv']}), "
        f"shed {st['shed']}; decode forward {paged_ms:.2f} ms paged, {dense_ms:.2f} ms dense")
    out["paged_profile"] = profile_decode(eng, vocab, torch.Generator().manual_seed(SEED + 2))
    out["paged"] = {k: st[k] for k in ("prefix_hits", "prefill_tokens_skipped", "cow_copies",
                                       "kv_pages_peak", "kv_bytes_peak", "shed")}
    fp32_bytes = st["kv_bytes_peak"]
    del eng

    # a pool too small for the burst: shedding, never an exception
    eng = engine(paged=True, page_size=16, n_pages=9)
    reqs, st, _, ties = driven("paged, n_pages 9 (shedding)", eng, pburst, want, gaps,
                               all_ok=False)
    out["ties"] += ties
    statuses = [r.status for r in reqs]
    check(st["shed"] > 0 and set(statuses) <= {"ok", "shed"} and "ok" in statuses,
          f"shedding burst: statuses {statuses}")
    log(f"[paged] n_pages 9: statuses {statuses}, shed {st['shed']}, kv_pages_peak "
        f"{st['kv_pages_peak']} of {st['kv_pages_total']}")
    del eng

    # fp8 storage: paged against a dense fp8 engine
    dense8 = engine(kv_dtype="float8_e4m3fn")
    want8, _, gaps8 = plain_run(dense8, pburst)
    del dense8
    eng = engine(paged=True, page_size=16, kv_dtype="float8_e4m3fn")
    _, st, _, ties = driven("paged fp8 (float8_e4m3fn) vs dense fp8", eng, pburst, want8, gaps8)
    out["ties"] += ties
    # the pool's scatters and gathers index float8_e4m3fn tensors on the card directly
    log(f"[paged] fp8 pool: kv_bytes_peak {st['kv_bytes_peak']} against fp32's {fp32_bytes} "
        f"({st['kv_bytes_peak'] / fp32_bytes:.3f}x); dense layout {st['kv_bytes_dense_equiv']}")
    out["fp8_bytes"], out["fp32_bytes"] = st["kv_bytes_peak"], fp32_bytes
    del eng

    # speculative decoding, gamma 4, on the phase-4 burst
    burst4 = phase4_burst(vocab)
    want4, _, gaps4 = plain_run(plain, burst4)
    out["burst_plain"] = (want4, gaps4)
    eng = engine(spec_decode=True, spec_gamma=GAMMA)
    cache = autotune.get_cache()
    for m, c, k, v in lut_kernel_signatures(art.bundle):
        rec = cache.get(autotune.shape_key("lut_amm", PATH_N[1], m, c, k, v, "float32",
                                           autotune.BACKEND_CUDA))
        check(rec is not None and rec["measured"], f"no measured record at N={PATH_N[1]} "
                                                   f"{(m, c, k, v)}")
    versions = chosen_versions(art.bundle, list(PATH_N), "float32", eng.device)
    mixed = [sig for sig, vs in versions.items() if 1 in vs and len(set(vs)) > 1]
    log(f"[spec] kernel version per site (M, C, K, V) at N={list(PATH_N)}: "
        + ", ".join(f"{sig}: {vs}" for sig, vs in versions.items())
        + (f"; v1 at only some counts at {mixed} (its fp32 sums differ from fused/v2's int32 "
           f"sums in the last bits)" if mixed else "; no site mixes v1 with fused/v2"))
    _, st, by_n, ties = driven("spec, self-draft", eng, burst4, want4, gaps4)
    spec_line("self-draft", st, by_n)
    # greedy requests accept every draft; the SAMPLED ones draw from the
    # target at temperature 0.8 where the draft proposes its argmax
    check(st["spec_bonus_tokens"] > 0 and st["spec_catchup_forwards"] > 0
          and st["target_forwards_per_token"] < 1.0,
          f"self-draft: target_forwards_per_token {st['target_forwards_per_token']}, bonus "
          f"{st['spec_bonus_tokens']}, catch-up {st['spec_catchup_forwards']}")
    out["ties"] += ties
    out["self"] = {k: st[k] for k in ("spec_acceptance_rate", "target_forwards_per_token")}
    del eng
    # the divergent draft: the arch at full width cut to DRAFT_LAYERS layers
    # (the self-draft above runs all 28), params from another seed
    t0 = time.perf_counter()
    draft_bundle = build_model(dataclasses.replace(art.bundle.arch, n_layers=DRAFT_LAYERS),
                               Mode.LUT_INFER)
    draft = draft_bundle.init(torch.Generator(device=dev).manual_seed(SEED + 7), device=dev)
    log(f"[spec] divergent draft: {art.bundle.arch.name} at full width and {DRAFT_LAYERS} "
        f"layers, params from seed {SEED + 7} ({time.perf_counter() - t0:.1f}s)")
    for paged in (False, True):
        extra = dict(paged=True, page_size=16) if paged else {}
        label = "divergent draft, " + ("paged" if paged else "dense")
        eng = engine(spec_decode=True, spec_gamma=GAMMA, draft_bundle=draft_bundle,
                     draft_params=draft, **extra)
        _, st, by_n, ties = driven(f"spec, {label}", eng, burst4, want4, gaps4)
        spec_line(label, st, by_n)
        check(st["spec_tokens_accepted"] < st["spec_tokens_proposed"],
              f"{label}: every draft accepted; the rollback never ran")
        check(not paged or st["spec_pages_rewound"] > 0, f"{label}: no page rewound")
        out["ties"] += ties
        out["paged_div" if paged else "dense_div"] = {
            k: st[k] for k in ("spec_acceptance_rate", "target_forwards_per_token",
                               "spec_pages_rewound")}
        del eng
    del draft, draft_bundle
    torch.cuda.empty_cache()
    out["two_plan"] = two_plan_artifact(dev, scratch)
    out["ties"] += out["two_plan"]["ties"]
    log(f"[paged/spec] tokens differing from plain decode at a near-tie, over phase 5: "
        f"{out['ties']} (bound: top-2 gap <= {TOKEN_TIE})")
    return out


def two_plan_artifact(dev, scratch: Path) -> dict:
    """A two-plan artifact at full width and 2 layers, written by the port:
    target LUTPlan.keeping_dense("mlp/down"), draft all-LUT sharing every
    other table. Loaded back, served by the launcher with --draft-plan
    draft, and by a spec engine against plain decode of the target."""
    from repro_torch.configs import build_model, effective_plan, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.launch import serve
    from repro_torch.serving.artifact import load_artifact, save_artifact
    from repro_torch.serving.engine import ServingEngine

    arch = dataclasses.replace(get_arch("qwen3_1p7b"), n_layers=2, lut_use_kernel=True)
    dbundle = build_model(arch, Mode.LUT_INFER)
    tbundle = build_model(dataclasses.replace(
        arch, lut_plan=effective_plan(arch).keeping_dense("mlp/down")), Mode.LUT_INFER)
    dparams = dbundle.init(torch.Generator(device=dev).manual_seed(SEED + 11), device=dev)
    tinit = tbundle.init(torch.Generator(device=dev).manual_seed(SEED + 12), device=dev)
    # the draft's params, but a dense down wherever the target keeps it dense
    tparams = dict(dparams, segments=[
        [dict(layer, mlp=dict(layer["mlp"], down=tlayer["mlp"]["down"]))
         if "w" in tlayer["mlp"]["down"] and "w" not in layer["mlp"]["down"] else layer
         for layer, tlayer in zip(dseg, tseg)]
        for dseg, tseg in zip(dparams["segments"], tinit["segments"])])
    del tinit
    t0 = time.perf_counter()
    path = save_artifact(scratch / "two_plan", tbundle, tparams,
                         extra_plans={"draft": (dbundle, dparams)})
    manifest = json.loads((path / "manifest.json").read_text())
    keys = [r["key"] for r in manifest["plans"]["draft"]["leaves"].values()]
    own = sorted(k for k in keys if k.startswith("plan."))
    check(own and all("mlp/down" in k for k in own),
          f"the draft should store only its down tables, stores {own}")
    target = load_artifact(path, device=dev)
    draft = load_artifact(path, plan="draft", restore_autotune=False, device=dev)
    log(f"[two-plan] 2-layer two-plan artifact written and loaded in "
        f"{time.perf_counter() - t0:.1f}s; the draft stores {len(own)} of {len(keys)} leaves "
        f"of its own, the rest shared with the target")
    serve.main(["--artifact", str(path), "--device", str(dev), "--spec-decode", "--draft-plan",
                "draft", "--spec-gamma", str(GAMMA), "--requests", "8", "--max-tokens", "16"])
    kw = dict(n_slots=4, max_seq=256, prefill_chunk=32, device=dev)
    burst = phase4_burst(target.bundle.arch.vocab)
    plain = ServingEngine(target.bundle, target.params, **kw)
    want, _, gaps = plain_run(plain, burst)
    eng = ServingEngine(target.bundle, target.params, **kw, spec_decode=True, spec_gamma=GAMMA,
                        draft_bundle=draft.bundle, draft_params=draft.params)
    _, st, by_n, ties = driven("spec, two-plan artifact's draft plan", eng, burst, want, gaps)
    spec_line("two-plan draft plan", st, by_n)
    shutil.rmtree(path)
    return {"ties": ties, "acceptance": st["spec_acceptance_rate"],
            "tfpt": st["target_forwards_per_token"]}


# ---------------------------------------------------------------------------
# phase 6: the process layer (HTTP front end, supervisor, router) on the card
# ---------------------------------------------------------------------------

SERVER_ARGS = ["--port", "0", "--replicas", "2", "--routing", "prefix_affinity", "--paged",
               "--slots", "4", "--max-seq", "256", "--prefill-chunk", "32"]
HTTP_WAIT_S = 300         # the longest a launch may take to listen, or a request to end


def percentiles(xs: list[float]) -> str:
    xs = sorted(xs)
    if not xs:
        return "n/a"
    med, p90 = (xs[min(len(xs) - 1, int(q * len(xs)))] for q in (0.5, 0.9))
    return f"median {1e3 * med:.1f} ms, p90 {1e3 * p90:.1f} ms (n={len(xs)})"


def spec_of(prompt, sampling) -> dict:
    spec = {"prompt": prompt, "max_tokens": 16}
    if sampling is not None:
        spec.update(temperature=sampling.temperature, top_k=sampling.top_k,
                    top_p=sampling.top_p, seed=sampling.seed)
    return spec


def inprocess_timing(eng, burst) -> tuple[list[float], list[float], float]:
    """The burst on the in-process engine, every request submitted at once:
    per request the time to its first token, and every gap between its
    tokens, read by a TokenTap after each step; and the mean decode forward
    (engine counters: forward and sync)."""
    from repro_torch.serving.engine import TokenTap

    eng.finished.clear()
    eng.reset_stats()
    tap = TokenTap(eng, consume=True)
    t0 = time.perf_counter()
    rids = [eng.submit(prompt, max_tokens=16, sampling=sampling) for prompt, sampling in burst]
    stamps: dict[int, list[float]] = {rid: [] for rid in rids}
    while eng.has_work():
        eng.step()
        now = time.perf_counter()
        for rid, toks in tap.poll()[0]:
            stamps[rid].extend([now] * len(toks))
    ttft = [st[0] - t0 for st in stamps.values()]
    gaps = [b - a for st in stamps.values() for a, b in zip(st, st[1:])]
    st = eng.stats()
    return ttft, gaps, st["decode_s"] / st["decode_forwards"]


class Server:
    """The launcher as a subprocess in its own process group (its workers with it),
    started at construction; `listen` reads the bound port from its first line."""

    def __init__(self, art_dir: Path, scratch: Path, extra: list[str], tag: str):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.log = scratch / f"server_{tag}.log"
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--artifact", str(art_dir),
             *SERVER_ARGS, *extra], stdout=subprocess.PIPE, stderr=self.log.open("w"),
            text=True, env=env, start_new_session=True)

    def listen(self) -> "Server":
        ready, _, _ = select.select([self.proc.stdout], [], [], HTTP_WAIT_S)
        line = self.proc.stdout.readline() if ready else ""
        self.listen_s = time.perf_counter() - self.t0
        m = re.search(r"serving .* on http://([\d.]+):(\d+) ", line)
        if m is None:
            self.stop()
            check(False, f"the launcher printed no address: {line!r}; "
                         f"stderr: {self.log.read_text()[-3000:]}")
        self.url = f"http://{m.group(1)}:{m.group(2)}"
        log(f"[process] {line.strip()} ({self.listen_s:.1f}s after the launch)")
        return self

    def get(self, path: str) -> tuple[int, bytes]:
        try:
            with urllib.request.urlopen(self.url + path, timeout=HTTP_WAIT_S) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def stats(self) -> dict:
        code, body = self.get("/stats")
        check(code == 200, f"/stats answered {code}")
        return json.loads(body)

    def wait_replicas(self, n: int = 2) -> dict:
        """/readyz turns 200 with the first replica up: wait for all n."""
        deadline = time.perf_counter() + HTTP_WAIT_S
        while True:
            st = self.stats()
            per = st["per_replica"].values()
            if st["replicas_live"] == n and all(ps["startups"] for ps in per):
                return st
            check(time.perf_counter() < deadline, f"not all {n} replicas came up: {st}")
            time.sleep(0.1)

    def generate(self, spec: dict) -> dict:
        """One streamed request: its final line, the tokens as streamed
        (restart events honoured), the send time and each token's arrival."""
        req = urllib.request.Request(self.url + "/generate",
                                     data=json.dumps(dict(spec, stream=True)).encode())
        t0 = time.perf_counter()
        streamed, stamps, restarts, final = [], [], 0, None
        with urllib.request.urlopen(req, timeout=HTTP_WAIT_S) as resp:
            for raw in resp:
                line = json.loads(raw)
                if "token" in line:
                    streamed.append(line["token"])
                    stamps.append(time.perf_counter())
                elif line.get("restart"):
                    streamed, stamps, restarts = [], [], restarts + 1
                elif "status" in line:
                    final = line
        check(final is not None, "a stream ended without its final line")
        return {"final": final, "streamed": streamed, "t0": t0, "stamps": stamps,
                "restarts": restarts}

    def burst(self, specs: list[dict], threads: int) -> list[dict]:
        with ThreadPoolExecutor(threads) as pool:
            return list(pool.map(self.generate, specs))

    def stop(self, expect_exit: int | None = None) -> None:
        """SIGTERM (a drain), then wait; a launcher that outlives the wait
        is killed with its whole process group."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            code = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=30)
            code = None
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)       # no worker outlives its launcher
        except ProcessLookupError:
            pass
        if expect_exit is not None:
            check(code == expect_exit, f"the launcher exited {code} on SIGTERM, not "
                                       f"{expect_exit}; stderr: {self.log.read_text()[-3000:]}")


def served_requests(outs: list[dict], want: list) -> list:
    """The HTTP results as request-like records for compare_tokens; every
    streamed token list must equal its final line's."""
    recs = []
    for o, w in zip(outs, want):
        check(o["streamed"] == o["final"]["tokens"], "streamed tokens != the final line's")
        recs.append(types.SimpleNamespace(out_tokens=o["final"]["tokens"],
                                          status=o["final"]["status"], rid=w.rid))
    return recs


def launch_deltas(before: dict, after: dict) -> dict[str, int]:
    from repro_torch.kernels import counters

    keys = [f"launches_{k}" for k in counters.KERNELS] + ["plain_calls"]
    return {k: after.get(k, 0) - before.get(k, 0) for k in keys}


def check_path_launches(label: str, delta: dict, counts: list[int], bundle) -> None:
    """Every kernel the records choose at the engine's token counts launched
    in the run; no plain version was called."""
    from repro_torch.launch.serve import chosen_versions

    chosen = {KERNEL_OF_VERSION[ver] for vers in
              chosen_versions(bundle, counts, "float32", torch.device("cuda")).values()
              for ver in vers}
    check(delta["plain_calls"] == 0, f"{label}: the workers called a plain version")
    check(all(delta[f"launches_{k}"] > 0 for k in chosen),
          f"{label}: the records choose {sorted(chosen)}; the workers launched {delta}")
    log(f"[process] {label}: launches in the workers: "
        + " ".join(f"{k}={v}" for k, v in delta.items()))


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


def gpu_used_mib() -> int:
    return int(smi("--query-gpu=memory.used").splitlines()[0])


def phase_process(scratch: Path, plain, refs: dict) -> dict:
    art_dir = scratch / "main"
    bundle = plain.bundle
    counts = [plain.n_slots, plain.n_slots * plain.prefill_chunk]
    burst = phase4_burst(bundle.arch.vocab)
    want4, gaps4 = refs["burst_plain"]
    wantp, gapsp = refs["prefix_plain"]
    pburst = prefix_burst(bundle.arch.vocab)
    ttft_in, gaps_in, fwd_in = inprocess_timing(plain, burst)
    log(f"[process] in process (phase 4's engine, dense), the phase-4 burst: time to first token "
        f"{percentiles(ttft_in)}; inter-token gap {percentiles(gaps_in)}; decode forward "
        f"{1e3 * fwd_in:.1f} ms (engine counters)")
    out = {"ties": 0}
    torch.cuda.synchronize()
    base_mib = gpu_used_mib()         # this process's own, idle through phase 6

    # launch 1: the routed deployment, a transient fault on replica 0
    srv = Server(art_dir, scratch, ["--fault-json", '{"error_steps": [3]}', "--fault-replica",
                                    "0"], "main").listen()
    srv2 = None
    try:
        check(srv.get("/readyz")[0] == 200, "/readyz is not 200 after the address line")
        st0 = srv.wait_replicas()
        check(all(v == 0 for v in launch_deltas({}, st0).values()),
              f"the workers launched kernels before any request: {launch_deltas({}, st0)}")
        for rep, ps in sorted(st0["per_replica"].items()):
            (su,) = ps["startups"]
            log(f"[process] replica {rep} ready {su['ready_s']:.2f}s after its spawn: "
                f"interpreter and torch import {su['entered_s']:.2f}s, CUDA context "
                f"{su['cuda_s'] - su['entered_s']:.2f}s, artifact load "
                f"{su['loaded_s'] - su['cuda_s']:.2f}s, record restore "
                f"{su['restored_s'] - su['loaded_s']:.3f}s, engine "
                f"{su['engine_s'] - su['restored_s']:.3f}s, first report "
                f"{su['ready_s'] - su['engine_s']:.3f}s")
        out["startups"] = {rep: ps["startups"][0] for rep, ps in st0["per_replica"].items()}
        # the burst twice: on cold workers (their first forwards, never warmed:
        # the reference's workers are not), then warm, as phase 4's engine is
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            outs = srv.burst([spec_of(p, smp) for p, smp in burst], threads=8)
            wall = time.perf_counter() - t0
            st1 = srv.stats()
            check_path_launches(f"phase-4 burst over HTTP ({run})", launch_deltas(st0, st1),
                                counts, bundle)
            got = served_requests(outs, want4)
            check(all(r.status == "ok" and len(r.out_tokens) == 16 for r in got),
                  f"HTTP burst statuses {[r.status for r in got]}")
            out["ties"] += compare_tokens(f"phase-4 burst over HTTP ({run})", got, want4, gaps4)
            ttft = [o["stamps"][0] - o["t0"] for o in outs]
            gaps = [b - a for o in outs for a, b in zip(o["stamps"], o["stamps"][1:])]
            per = {r: {k: ps[k] - st0["per_replica"][r][k]
                       for k in ("routed", "decode_s", "decode_forwards")}
                   for r, ps in sorted(st1["per_replica"].items())}
            log(f"[process] over HTTP (2 replicas, paged), the phase-4 burst ({run}) from 8 "
                f"client threads in {wall:.3f}s: time to first token {percentiles(ttft)}; "
                f"inter-token gap {percentiles(gaps)}; per replica routed, decode forward "
                f"(worker counters): "
                + ", ".join(f"{r}: {d['routed']}, "
                            f"{1e3 * d['decode_s'] / d['decode_forwards']:.1f} ms"
                            for r, d in per.items() if d["decode_forwards"]))
            st0 = st1
        rep0 = st1["per_replica"]["0"]
        check(rep0["routed"] > 0 and rep0.get("faults_error", 0) >= 1 and st1["restarts"] == 0,
              f"the transient fault on replica 0: routed {rep0['routed']}, "
              f"faults_error {rep0.get('faults_error')}, restarts {st1['restarts']}")
        log(f"[process] replica 0's transient fault at its step 3 retried in place: "
            f"faults_error {rep0['faults_error']}, restarts 0, tokens as in process")
        # each worker reports its own allocator's device memory; the CUDA
        # contexts and kernel images lie outside it, and inside a container
        # nvidia-smi's compute apps may show one pid for every process, so
        # that part is the card's used memory less this process's and the
        # workers' allocators, split evenly
        used_mib = gpu_used_mib()
        check(used_mib > base_mib, f"the workers hold no device memory: {used_mib} MiB")
        mem = {r: {k: ps[f"device_mem_{k}_bytes"] / 2**20
                   for k in ("reserved", "peak_reserved", "allocated")}
               for r, ps in sorted(st1["per_replica"].items())}
        check(all(m["reserved"] > 0 for m in mem.values()),
              f"a worker reports no device memory of its own: {mem}")
        outside = (used_mib - base_mib - sum(m["reserved"] for m in mem.values())) / len(mem)
        log(f"[process] device memory per worker, its own allocator (reserved, peak reserved, "
            f"allocated): "
            + ", ".join(f"replica {r}: {m['reserved']:.0f}, {m['peak_reserved']:.0f}, "
                        f"{m['allocated']:.0f} MiB" for r, m in mem.items())
            + f"; cross-check: the card's used memory {used_mib} MiB with the workers serving, "
            f"{base_mib} MiB before the launch, so {outside:.0f} MiB per worker outside the "
            f"allocators (CUDA context, kernel images, split evenly); nvidia-smi's compute "
            f"apps: {smi('--query-compute-apps=pid,used_memory')!r}")
        out["worker_mib"] = {r: m["reserved"] + outside for r, m in mem.items()}
        # launch 2 (below) starts up while this one serves the prefix burst
        # and drains: nothing of launch 1 is timed from here on
        srv2 = Server(art_dir, scratch, ["--fault-json", '{"kill_at_step": 4}',
                                         "--fault-replica", "0"], "kill")
        # phase 5's shared-prefix burst, in waves of 4 (a wave never loads the
        # favorite past its 4 slots, so nothing spills): one replica serves it
        outs = []
        for wave in range(2):
            outs += srv.burst([spec_of(p, smp) for p, smp in pburst[4 * wave: 4 * wave + 4]],
                              threads=4)
            time.sleep(0.5)                 # the workers' load reports catch up
        st2 = srv.stats()
        routed = {r: st2["per_replica"][r]["routed"] - st1["per_replica"][r]["routed"]
                  for r in st2["per_replica"]}
        check(sorted(routed.values()) == [0, 8], f"the prefix burst spread over replicas: "
                                                 f"{routed}")
        check(st2["affinity_hits"] - st1["affinity_hits"] == 8 and st2["spills"] == st1["spills"],
              "the prefix burst spilled")
        metrics = srv.get("/metrics")[1].decode()
        hits = next((float(line.split()[-1]) for line in metrics.splitlines()
                     if line.startswith("lutnn_serving_prefix_hits ")), 0.0)
        check(hits > 0, "no prefix hit in /metrics")
        out["ties"] += compare_tokens("prefix burst over HTTP", served_requests(outs, wantp),
                                      wantp, gapsp)
        check_path_launches("prefix burst over HTTP", launch_deltas(st1, st2), counts, bundle)
        log(f"[process] prefix burst: all 8 on replica "
            f"{next(r for r, n in routed.items() if n)}, lutnn_serving_prefix_hits {hits:.0f}, "
            f"affinity_hits {st2['affinity_hits']}, spills {st2['spills']}")
    except BaseException:
        if srv2 is not None:
            srv2.stop()
        raise
    finally:
        srv.stop()
    check(srv.proc.returncode == 0, f"SIGTERM: the launcher exited {srv.proc.returncode}")
    log("[process] SIGTERM: the launcher drained and exited 0")

    # launch 2: replica 0's worker killed at its 5th step, restarted, requests requeued
    srv = srv2
    try:
        srv.listen()
        st0 = srv.wait_replicas()
        outs = srv.burst([spec_of(p, smp) for p, smp in burst], threads=8)
        st1 = srv.stats()
        got = served_requests(outs, want4)
        check(all(r.status == "ok" for r in got), f"statuses {[r.status for r in got]}")
        out["ties"] += compare_tokens("phase-4 burst over HTTP, replica 0 killed", got, want4,
                                      gaps4)
        check(st1["restarts"] >= 1 and st1["requeued"] >= 1 and st1["lost"] == 0,
              f"kill: restarts {st1['restarts']}, requeued {st1['requeued']}, lost {st1['lost']}")
        check_path_launches("burst with a kill", launch_deltas(st0, st1), counts, bundle)
        sus = st1["per_replica"]["0"]["startups"]
        check(len(sus) >= 2, f"replica 0 restarted {len(sus) - 1} times")
        su = sus[1]
        log(f"[process] kill at replica 0's step 4: restarts {st1['restarts']}, requeued "
            f"{st1['requeued']}, streams restarted {sum(o['restarts'] for o in outs)}; the "
            f"restarted worker ready {su['ready_s']:.2f}s after its spawn (import "
            f"{su['entered_s']:.2f}s, CUDA context {su['cuda_s'] - su['entered_s']:.2f}s, "
            f"load {su['loaded_s'] - su['cuda_s']:.2f}s, restore "
            f"{su['restored_s'] - su['loaded_s']:.3f}s); every request ok with the "
            f"fault-free tokens")
        out["restart"] = su
    finally:
        srv.stop()
    check(srv.proc.returncode == 0, f"SIGTERM: the launcher exited {srv.proc.returncode}")
    log(f"[process] SIGTERM: exit 0; tokens differing from plain decode at a near-tie over "
        f"phase 6: {out['ties']}")
    return out


# ---------------------------------------------------------------------------
# phase 11: tensor-parallel serving (tp 2) from phase 4's artifact
# ---------------------------------------------------------------------------

TP = 2
TP_LAYERS = 2            # phase 11's depth of qwen3_1p7b (full width): cut from phase 4's 28
                         # layers so that chip_smoke keeps inside its time limit with phase
                         # 12, then from 4 with phase 13
TP_PROFILE_STEPS = 8
# the leader's marks between forwards, passed to every follower's on_mark
MARK_COUNT, MARK_READ, MARK_PROFILE, MARK_PROFILED = 1, 2, 3, 4


def tp_devices() -> tuple[int, list[str]]:
    """(cards on the host, each rank's device): a card per rank where the
    host has TP of them, else every rank on the one card."""
    n_cards = torch.cuda.device_count()
    return n_cards, [f"cuda:{r}" for r in range(TP)] if n_cards >= TP else ["cuda:0"] * TP


def start_ranks(target, devices: list[str], *args) -> dict:
    """A process for each of `devices` running `target(rank, jobs, devices,
    init, q, *args)`, spawned now: `jobs` is the rank's own queue for what
    the parent sends it later, `q` the one every rank answers on. Spawned a
    phase ahead, the ranks' start (interpreter, torch, the CUDA context, the
    mesh) runs beside that phase."""
    import multiprocessing as mp
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    jobs = [ctx.Queue() for _ in devices]
    procs = [ctx.Process(target=target, args=(r, jobs[r], devices, init, q, *args), daemon=True)
             for r in range(len(devices))]
    for p in procs:
        p.start()
    return {"procs": procs, "q": q, "jobs": jobs, "devices": devices,
            "cards": torch.cuda.device_count(), "t0": time.perf_counter()}


def wait_ranks(q, n: int, seconds: float) -> list:
    """The ranks' next `n` answers on `q`, (status, value) each. A failed
    rank ends the wait (its peers would hang), as does no answer within
    `seconds`."""
    import queue

    got: list = []
    deadline = time.monotonic() + seconds
    try:
        while len(got) < n:
            got.append(q.get(timeout=max(1.0, deadline - time.monotonic())))
            if got[-1][0] != "ok":
                break
    except queue.Empty:
        got.append(("error", {"trace": f"no result from {n - len(got)} rank(s) in "
                                       f"{seconds:.0f} s"}))
    return got


def stop_ranks(procs, ok: bool) -> None:
    """Join the rank processes (after a failure, hardly wait), killing any
    still alive."""
    for p in procs:
        p.join(timeout=60 if ok else 1)
        if p.is_alive():
            p.kill()
            p.join(timeout=30)


def tp_expected_launches(local, lay, counts: list[int], prefill_fwd: int, decode_fwd: int,
                         dev) -> dict[str, int]:
    """Launches of each kernel that the records choose for a rank's LUT sites
    (`tensor_parallel.kernel_signatures`: column sites at M / tp, row sites
    at C / tp in float32) over the given prefill and decode forwards: one
    per site call (the hybrid's shared block once per invocation, the
    expert sites none)."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.kernels import autotune

    backend = autotune.backend_for(dev)
    want = dict.fromkeys(KERNEL_OF_VERSION.values(), 0)
    sig_of = {}
    for m, c, k, v, dt in tensor_parallel.kernel_signatures(local, lay, "float32"):
        sig_of[(m, c, k, v)] = dt
    # the hybrid's shared block runs once per invocation; expert sites launch no kernel
    n_inv = len(local.cfg.invocation_points) if local.kind == "hybrid" else 1
    for site in local.lut_sites():
        if site.kind in tensor_parallel.EXPERT_KINDS:
            continue
        times = n_inv if site.path.startswith("shared/") else 1
        sig = (site.d_out, site.d_in // site.lut.v, site.lut.k, site.lut.v)
        for n, fwd in ((counts[1], prefill_fwd), (counts[0], decode_fwd)):
            ver = autotune.kernel_choice(n, *sig, dtype=sig_of[sig], backend=backend)[0]
            want[KERNEL_OF_VERSION[ver]] += fwd * times
    return want


class TPProbe:
    """The instruments of phases 11 and 12 on one rank's engine, through the
    hooks of `serve_on_mesh`: every forward timed; the launch counts,
    collectives and device memory read between the leader's marks; every
    `ops.lut_amm` call (`SiteCalls`) of the counted burst's first prefill and
    first decode forward, or with `record_all` of all its forwards,
    recorded, and each row-parallel LUT site's reduced output and each MoE
    layer's input, output and expert calls of those two forwards; a
    profiled window of decode steps. The leader serves `burst(vocab)`."""

    def __init__(self, mesh, burst=None, record_all: bool = False, shadow=None):
        self.mesh, self.dev, self.t0 = mesh, mesh.device, time.perf_counter()
        self.burst, self.record_all = burst or phase4_burst, record_all
        # the unsharded model (bundle, whole params) of a `Shadow`, and the
        # request in each row of each counted forward (the leader's)
        self.shadow_model, self.shadow, self.rids = shadow, None, []
        self.tp_peak = 0
        self.res: dict = {}
        self.acc = {"prefill_forwards": 0, "prefill_s": 0.0, "decode_forwards": 0,
                    "decode_s": 0.0}
        self.to_record: set[str] = set()
        self.counting = False
        self.calls: list = []
        # (call index in its forward, the rank's params, input, reduced output)
        self.rows: list = []
        # MoE layers: (layer call in its forward, input, output); expert
        # calls: (layer call, site, the experts' global ids, input, output)
        self.moe_layers: list = []
        self.experts: list = []
        self.eng = None

    def engine(self, eng) -> None:
        self.res.update(build_s=time.perf_counter() - self.t0, tuned=eng.n_lut_shapes_tuned)
        self.eng, real = eng, eng._forward
        if self.shadow_model is not None:
            self.shadow = Shadow(eng, self.shadow_model, self.mesh.model_rank)

        def forward(toks, cache_len, write_len, model=None):
            phase = "decode" if toks.shape[1] == 1 else "prefill"
            first = phase in self.to_record
            self.to_record.discard(phase)
            shadowed = self.shadow is not None and self.counting
            if shadowed:
                torch.cuda.reset_peak_memory_stats(self.dev)
            t = time.perf_counter()
            with (self.recorder(first) if first or (self.record_all and self.counting)
                  else contextlib.nullcontext()), \
                    (Decisions() if shadowed else contextlib.nullcontext()) as dec:
                logits = real(toks, cache_len, write_len, model)
            torch.cuda.synchronize(self.dev)
            self.acc[f"{phase}_forwards"] += 1
            self.acc[f"{phase}_s"] += time.perf_counter() - t
            if shadowed:
                # the rank's own peak, before its twin runs
                self.tp_peak = max(self.tp_peak, torch.cuda.max_memory_allocated(self.dev))
                self.rids.append([r.rid if r is not None else None for r in self.eng.slots])
                self.shadow.step(toks, cache_len, write_len, logits, dec)
            return logits

        eng._forward = forward

    @contextlib.contextmanager
    def recorder(self, first: bool):
        from repro_torch.core.amm import Mode
        from repro_torch.models import moe, sharded

        real, n = (sharded.linear, moe.moe, moe.expert_linear), [0, 0, 0]

        def linear(site, p, x):
            y = real[0](site, p, x)
            if site.tp == "row" and site.mode == Mode.LUT_INFER:
                self.rows.append((n[0], p, x.reshape(-1, x.shape[-1]).clone(),
                                  y.reshape(-1, y.shape[-1]).clone()))
                n[0] += 1
            return y

        def moe_layer(cfg, p, x):
            n[1:] = n[1] + 1, 0
            y, aux = real[1](cfg, p, x)
            self.moe_layers.append((n[1] - 1, x.clone(), y.clone()))
            return y, aux

        def expert_linear(s, p, x, ids=None):
            y = real[2](s, p, x, ids)
            lo = self.mesh.model_rank * s.n_experts
            self.experts.append((n[1] - 1, ("gate", "up", "down")[n[2]], ids + lo,
                                 x.clone(), y.clone()))
            n[2] += 1
            return y

        if first:
            sharded.linear, moe.moe, moe.expert_linear = linear, moe_layer, expert_linear
        try:
            with SiteCalls() as rec:
                yield
        finally:
            sharded.linear, moe.moe, moe.expert_linear = real
        self.calls += rec.calls

    def mark(self, code: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels import counters

        mesh, dev, res = self.mesh, self.dev, self.res
        if code == MARK_COUNT:
            counters.reset()
            mesh.reset_counters()
            for k in self.acc:
                self.acc[k] = 0 if isinstance(self.acc[k], int) else 0.0
            torch.cuda.reset_peak_memory_stats(dev)
            self.tp_peak = 0
            self.to_record = {"prefill", "decode"}
            self.counting = True
        elif code == MARK_READ:
            self.counting = False
            res.update(launches=counters.launches(), plain=counters.plain_calls(),
                       coll=dict(mesh.counters), fwd=dict(self.acc),
                       peak=self.tp_peak or torch.cuda.max_memory_allocated(dev),
                       reserved=torch.cuda.memory_reserved(dev), card_mib=gpu_used_mib())
        elif code == MARK_PROFILE:
            torch.cuda.synchronize(dev)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t_prof = time.perf_counter()
        elif code == MARK_PROFILED:
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - self.t_prof
            self.prof.__exit__(None, None, None)
            busy = sum(device_times(self.prof).values())
            res["profile"] = {"wall_us": 1e6 * wall / TP_PROFILE_STEPS,
                              "busy_us": busy / TP_PROFILE_STEPS}

    def lead(self, eng, source: str) -> None:
        """Rank 0: the warm-up, the burst between the count marks, then a
        profiled window of decode steps."""
        res, vocab = self.res, eng.bundle.arch.vocab
        eng.warmup()
        eng.tp_mark(MARK_COUNT)
        self.mark(MARK_COUNT)
        reqs, st = run_burst(eng, self.burst(vocab))
        eng.tp_mark(MARK_READ)
        self.mark(MARK_READ)
        res["source"] = source
        res["tokens"] = [(r.rid, r.status, list(r.out_tokens)) for r in reqs]
        res["stats"] = {k: st[k] for k in ("prefill_forwards", "decode_forwards",
                                           "prefill_s", "decode_s", "wall")}
        if eng.paged:
            res["stats"].update(prefix_hits=st["prefix_hits"], shed=st["shed"])
        gen = torch.Generator().manual_seed(SEED + 2)
        for _ in range(eng.n_slots):
            eng.submit(torch.randint(0, vocab, (16,), generator=gen).tolist(), max_tokens=64)
        for _ in range(3):
            eng.step()                # admit, prefill, first decodes
        eng.tp_mark(MARK_PROFILE)
        self.mark(MARK_PROFILE)
        for _ in range(TP_PROFILE_STEPS):
            eng.step()                # decode only
        eng.tp_mark(MARK_PROFILED)
        self.mark(MARK_PROFILED)
        eng.abort_all("cancelled")


def gather_dim0(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` concatenated over dim 0 in rank order, as float32
    (exact for the int8 tables and the codes)."""
    return mesh.gather_last(t.float().movedim(0, -1).contiguous()).movedim(-1, 0).contiguous()


def hold_rows(label: str, mesh, rows: list, tables: dict) -> dict:
    """Each recorded row-parallel LUT site's reduced output held against the
    unsharded site on the same input: the ranks' input columns, centroids
    and int8 tables gathered (`tables` keeps them by the call's index in its
    forward, which names the same layer's site in every forward), and the
    plain lookup of the encode kernel's codes on them. Bytewise on every
    row whose unsharded codes are the concatenation of the ranks' (the
    exact int32 sums reduced before the one epilogue); a code that differs
    must be a tie of the fp32 expansion. Every rank makes the same
    collectives in the same order."""
    from repro_torch.kernels import dist_argmin as enc_mod
    from repro_torch.kernels import ref

    out = {"calls": 0, "rows": 0, "codes_off": 0, "err": 0.0}
    for k, p, x, y in rows:
        if k not in tables:
            tables[k] = (gather_dim0(mesh, p["centroids"]),
                         gather_dim0(mesh, p["table_q"]).to(torch.int8))
        c_full, q_full = tables[k]
        x_full = mesh.gather_last(x.float())
        shard_codes = mesh.gather_last(enc_mod.encode(x.float(), p["centroids"]).float()).int()
        codes = enc_mod.encode(x_full, c_full)
        want = ref.lookup(codes, q_full, p["table_scale"], bias=p.get("b"), dtype=y.dtype)
        reduced = ref.lookup(shard_codes, q_full, p["table_scale"], bias=p.get("b"),
                             dtype=y.dtype)
        torch.cuda.synchronize()
        name = (f"{label} row site call {k} (N={x.shape[0]}, C={c_full.shape[0]}, "
                f"M={q_full.shape[-1]})")
        check(torch.equal(y, reduced), f"{name}: the reduced output differs from the plain "
                                       f"lookup of the ranks' codes on the whole table")
        same = (codes == shard_codes).all(dim=1)
        bad = (y != want).any(dim=1) & same
        check(not bad.any().item(), f"{name}: {int(bad.sum())} rows differ from the unsharded "
                                    f"site's (max err {(y - want).abs().max().item():.3g})")
        out["codes_off"] += tie_codes(name, x_full, c_full, codes, shard_codes)
        out["calls"] += 1
        out["rows"] += x.shape[0]
        out["err"] = max(out["err"], (y - want).abs().max().item())
    return out


def tp_rank(rank: int, art_dir: str, devices: list[str], init: str, q) -> None:
    """One rank of phase 11, in its own process: a dense and a paged engine
    from `tp_model`'s artifact, each through the launcher's rank function
    (`serve_on_mesh`) with a `TPProbe` on its hooks (rank 0 leads phase 4's
    burst and a profiled window, the other rank follows); then, on every
    rank, the recorded LUT-site calls held against the plain versions."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets the fp32 matmul policy)
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh

    out: dict = {"rank": rank}
    try:
        t0 = time.perf_counter()
        mesh = make_host_mesh(data=1, model=len(devices), rank=rank, devices=devices,
                              init_method=init, timeout_s=600)
        out["mesh_s"] = time.perf_counter() - t0
        tables: dict = {}
        for label, flags in (("dense", []), ("paged", ["--paged", "--page-size", "16"])):
            args = serve.parse_args(["--artifact", art_dir, "--slots", "4", "--max-seq", "256",
                                     "--prefill-chunk", "32", *flags])
            probe = TPProbe(mesh)
            serve.serve_on_mesh(mesh, args, lead=probe.lead, on_mark=probe.mark,
                                on_engine=probe.engine)
            res, eng = probe.res, probe.eng
            res["counts"] = [eng.n_slots, eng.n_slots * eng.prefill_chunk]
            res["expected"] = tp_expected_launches(eng.bundle, eng.layout, res["counts"],
                                                   res["fwd"]["prefill_forwards"],
                                                   res["fwd"]["decode_forwards"], mesh.device)
            res["sigs"] = sorted({(s.d_out, s.d_in // s.lut.v) for s in eng.bundle.lut_sites()})
            res["per_forward"] = (len(eng.bundle.lut_sites()),
                                  sum(eng.layout.roles.get(s.path) == "row"
                                      for s in eng.bundle.lut_sites()))
            tag = f"tp {label} rank {rank}"
            res["rows_held"] = hold_rows(tag, mesh, probe.rows, tables)
            held = hold_sites(tag, probe.calls)
            held.pop("off_rows")
            res["held"] = held
            out[label] = res
            del eng, probe
            torch.cuda.empty_cache()
        out["backend"] = mesh.backend
        mesh.close()
        q.put(("ok", out))
    except BaseException:                     # noqa: BLE001 — the parent reports it
        import traceback

        q.put(("error", {"rank": rank, "trace": traceback.format_exc()}))


def tp_model(dev, scratch: Path) -> tuple[str, tuple]:
    """Phase 11's model: qwen3_1p7b at full width and TP_LAYERS layers
    (phase 4's seed) written as an artifact, and its plain run of phase 4's
    burst ((requests, sampler gaps): the reference of its tokens)."""
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.serving import artifact
    from repro_torch.serving.engine import ServingEngine

    arch = dataclasses.replace(get_arch("qwen3_1p7b"), lut_use_kernel=True, n_layers=TP_LAYERS)
    bundle = build_model(arch, Mode.LUT_INFER)
    params = bundle.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    path = artifact.save_artifact(scratch / "tp", bundle, params)
    with PlainLUT():
        want, _, gaps = plain_run(ServingEngine(bundle, params, n_slots=4, max_seq=256,
                                                prefill_chunk=32, device=dev,
                                                autotune_lut=False), phase4_burst(arch.vocab))
    return str(path), (want, gaps)


def phase_tp(dev, scratch: Path) -> dict:
    """Tensor-parallel serving at tp 2 of `tp_model`'s artifact: over NCCL
    when the host has two cards, else both ranks on the one card over gloo
    (two processes, two CUDA contexts). Phase 4's burst, dense and paged,
    against the model's plain run; per rank the launch counts (the kernels
    the records choose at the rank's shapes, no plain call), the decode
    forward's wall and busy time, the all-reduces per forward and their
    host time, and device memory."""
    import multiprocessing as mp
    import socket

    from repro_torch.launch.mesh import backend_for

    t0 = time.perf_counter()
    art, (want, gaps) = tp_model(dev, scratch)
    torch.cuda.empty_cache()
    log(f"[tp] qwen3_1p7b at {TP_LAYERS} layers written and run plain in "
        f"{time.perf_counter() - t0:.1f}s")

    n_cards, devices = tp_devices()
    backend = backend_for(devices)
    log(f"[tp] tp={TP} on {n_cards} card(s): ranks on {devices}, backend {backend}"
        + ("" if backend == "nccl" else " (both ranks share the card: NCCL is not measured)"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=tp_rank, args=(r, art, devices, init, q),
                         daemon=True) for r in range(TP)]
    for p in procs:
        p.start()
    got = wait_ranks(q, TP, 500)
    t_results = time.perf_counter() - t0
    stop_ranks(procs, got[-1][0] == "ok")
    errors = [val["trace"] for status, val in got if status != "ok"]
    check(not errors, "a tp rank failed:\n" + "\n".join(errors))
    ranks = sorted((val for _, val in got), key=lambda v: v["rank"])
    log(f"[tp] both ranks' results in {t_results:.1f}s (spawn, import, mesh, load, warm-up, 2 "
        f"engines), both exited {time.perf_counter() - t0 - t_results:.1f}s later")
    shutil.rmtree(art, ignore_errors=True)
    out = {"ties": 0, "launches": dict.fromkeys(ranks[0]["dense"]["launches"], 0),
           "backend": backend, "cards": n_cards}
    for label in ("dense", "paged"):
        lead = ranks[0][label]
        got_reqs = [types.SimpleNamespace(rid=rid, status=status, out_tokens=toks)
                    for rid, status, toks in lead["tokens"]]
        check(all(r.status == "ok" and len(r.out_tokens) == 16 for r in got_reqs),
              f"tp {label}: statuses {[r.status for r in got_reqs]}")
        ties = compare_tokens(f"tp {label}", got_reqs, want, gaps)
        out["ties"] += ties
        st = lead["stats"]
        for rank in ranks:
            res = rank[label]
            fwd, coll = res["fwd"], res["coll"]
            check(fwd["prefill_forwards"] == st["prefill_forwards"]
                  and fwd["decode_forwards"] == st["decode_forwards"],
                  f"tp {label} rank {rank['rank']}: {fwd} forwards, the leader's {st}")
            check(res["plain"] == 0, f"tp {label} rank {rank['rank']}: a plain version ran")
            for name, n in res["expected"].items():
                check(res["launches"][name] == n,
                      f"tp {label} rank {rank['rank']}: {name} launched "
                      f"{res['launches'][name]} times, the records say {n}")
            for name, n in res["launches"].items():
                out["launches"][name] += n
            check(sum(res["launches"].values()) > 0, f"tp {label}: no kernel launched")
            n_fwd = fwd["prefill_forwards"] + fwd["decode_forwards"]
            prof = res["profile"]
            held, rows = res["held"], res["rows_held"]
            n_lut, n_row = res["per_forward"]
            check(held["sites"] == 2 * n_lut and rows["calls"] == 2 * n_row > 0,
                  f"tp {label} rank {rank['rank']}: {held['sites']} LUT-site calls and "
                  f"{rows['calls']} row-site outputs recorded in two forwards of {n_lut} LUT "
                  f"sites, {n_row} of them row-parallel")
            log(f"[tp] {label} rank {rank['rank']}: {held['sites']} LUT-site calls of the first "
                f"prefill and decode forward ({held['kernels']}) equal to the plain lookup of "
                f"the encode kernel's codes at the rank's shapes (max abs err {held['err']:.3g}; "
                f"{held['codes_off']} of {held['codes']} codes off the plain encode's, each a "
                f"tie); {rows['calls']} row-site outputs ({rows['rows']} rows) bytewise the "
                f"unsharded site's on the gathered input and tables ({rows['codes_off']} codes "
                f"of the unsharded encode off the ranks', each a tie; max abs err "
                f"{rows['err']:.3g})")
            log(f"[tp] {label} rank {rank['rank']} ({devices[rank['rank']]}): load and engine "
                f"{res['build_s']:.1f}s ({res['tuned']} shapes "
                f"tuned); site shapes (M, C) {res['sigs']}; decode forward "
                f"{1e3 * fwd['decode_s'] / max(fwd['decode_forwards'], 1):.2f} ms "
                f"({fwd['decode_forwards']} fwd), prefill "
                f"{1e3 * fwd['prefill_s'] / max(fwd['prefill_forwards'], 1):.2f} ms "
                f"({fwd['prefill_forwards']} fwd); all_reduce {coll['all_reduce'] / n_fwd:.1f} "
                f"per forward, {1e6 * coll['all_reduce_s'] / max(coll['all_reduce'], 1):.1f} us "
                f"host each ({coll['all_reduce_bytes'] / n_fwd / 1e6:.2f} MB per forward); "
                f"profiled decode step {prof['wall_us']:.0f} us wall, device busy "
                f"{prof['busy_us']:.0f} us ({100 * prof['busy_us'] / prof['wall_us']:.1f}%); "
                f"peak {res['peak'] / 2**30:.2f} GiB allocated, {res['reserved'] / 2**30:.2f} "
                f"GiB reserved; launches "
                + " ".join(f"{k}={v}" for k, v in res["launches"].items()))
        n_tok = sum(len(r.out_tokens) for r in got_reqs)
        log(f"[tp] {label}: {n_tok} tokens in {st['wall']:.3f}s ({n_tok / st['wall']:.2f} "
            f"tok/s); tokens equal the plain run except {ties} near-tie difference(s)"
            + (f"; prefix_hits {st['prefix_hits']}, shed {st['shed']}" if label == "paged"
               else ""))
        out[label] = {"decode_ms": 1e3 * st["decode_s"] / st["decode_forwards"],
                      "tok_s": n_tok / st["wall"]}
    return out


# ---------------------------------------------------------------------------
# phase 12: tensor-parallel serving (tp 2) of the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------

SHADOW_TIE = 1e-4        # a decision's relative margin under which rounding may flip it


class Uncounted:
    """Kernel launches and plain calls made while active are taken back off
    the counts: a check's own calls never count as the path's."""

    def __enter__(self):
        from repro_torch.kernels import counters, ref

        self.launches, self.plain = counters.launches(), dict(ref.calls)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import dist_argmin, fused_decode, lut_amm, ref

        n = self.launches
        fused_decode.launches, lut_amm.launches = n["fused_decode"], n["lut_amm_v2"]
        lut_amm.launches_v1, dist_argmin.launches = n["lut_amm_v1"], n["encode"]
        ref.calls.update(self.plain)
        return False


class Decisions:
    """The discrete decisions of one forward, each with its place in the
    forward's call order: every LUT kernel call's input and centroids (its
    codes), every MoE layer's input, config and router (its routing), every
    LUT expert-site call's input, centroids and experts (global ids)."""

    def __init__(self):
        self.lut, self.route, self.exp, self.seq = [], [], [], 0

    def _note(self, store: list, *item) -> None:
        store.append((self.seq, *item))
        self.seq += 1

    def __enter__(self):
        from repro_torch.core.amm import Mode
        from repro_torch.kernels import ops
        from repro_torch.models import moe, sharded

        self.real = lut_amm, layer, expert_linear = ops.lut_amm, moe.moe, moe.expert_linear
        site = [0]

        def lut(x, c, q, s, **kw):
            self._note(self.lut, x.clone(), c)
            return lut_amm(x, c, q, s, **kw)

        def moe_layer(cfg, p, x):
            self._note(self.route, x.clone(), cfg, p["router"])
            site[0] = 0
            return layer(cfg, p, x)

        def expert(s, p, x, ids=None):
            if s.mode == Mode.LUT_INFER:
                cfg = self.route[-1][2]
                lo = sharded.model_rank() * s.n_experts if cfg.ep > 1 else 0
                self._note(self.exp, len(self.route) - 1, site[0], p["centroids"], x.clone(),
                           ids + lo)
            site[0] += 1
            return expert_linear(s, p, x, ids)

        ops.lut_amm, moe.moe, moe.expert_linear = lut, moe_layer, expert
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.models import moe

        ops.lut_amm, moe.moe, moe.expert_linear = self.real
        return False


def expert_codes(x, cents):
    """An expert site's codes of its input rows, as `moe.expert_linear` picks them."""
    from repro_torch.core import pq

    return pq.pairwise_sq_dists(pq.split_subvectors(x, cents.shape[-1]), cents).argmin(-1)


def first_flips(tp: Decisions, sh: Decisions, rank: int, write_len, s_len: int) -> dict:
    """{batch row: (order, what, margin)}: each row's first decision (in the
    unsharded run's call order) at a valid position (< its write length)
    that a tensor-parallel rank took otherwise than the unsharded model on
    its own input: its codes at a LUT kernel call (at a row site, the rank's
    codebooks), its routing at an MoE layer, its codes at a LUT expert site
    (the rank's experts). The margin is the unsharded run's: a code's
    distance gap over the expansion's terms (`code_margins`), a routing's
    gap between the k-th and the next router probability over the k-th."""
    from repro_torch.kernels import dist_argmin as enc_mod
    from repro_torch.models import moe

    valid_len = torch.as_tensor(write_len).long()
    flips: dict = {}

    def note(order: int, tokens: torch.Tensor, margins: torch.Tensor, what: str) -> None:
        tokens, margins = tokens.cpu(), margins.cpu()
        keep = tokens % s_len < valid_len[tokens // s_len]
        for t, m in zip(tokens[keep].tolist(), margins[keep].tolist()):
            row = t // s_len
            if row not in flips or (order, m) < flips[row][::2]:
                flips[row] = (order, what, m)

    for k, ((_, xt, ct), (order, xs, cs)) in enumerate(zip(tp.lut, sh.lut, strict=True)):
        n_c = ct.shape[0]
        if n_c != cs.shape[0]:                        # a row site: the rank's codebooks
            v = cs.shape[-1]
            xs = xs[:, rank * n_c * v:(rank + 1) * n_c * v].contiguous()
            cs = cs[rank * n_c:(rank + 1) * n_c].contiguous()
        rows, rel = code_margins(xs, cs, enc_mod.encode(xt, ct), enc_mod.encode(xs, cs))[:2]
        note(order, rows, rel, f"codes of LUT call {k} (N={xt.shape[0]}, C={n_c})")
    routes = []
    for k, ((_, xt, cfg, pr), (order, xs, _, _)) in enumerate(zip(tp.route, sh.route,
                                                                   strict=True)):
        top = cfg.top_k
        _, pt, dt, _, _ = moe.route(cfg, {"router": pr}, xt)      # each run's own routing
        _, ps, ds, _, cap = moe.route(cfg, {"router": pr}, xs)
        vs, js = ps.topk(top + 1, dim=-1)
        chose = (pt.topk(top, dim=-1).indices.sort(-1).values
                 != js[..., :top].sort(-1).values).any(-1)         # (G, g)
        rel = (vs[..., top - 1] - vs[..., top]) / vs[..., top - 1]
        note(order, chose.flatten().nonzero()[:, 0], rel.flatten()[chose.flatten()],
             f"routing at MoE layer {k}")
        # the same choices, another drop: capacity a token of its group (its
        # request) routed otherwise took. A padded position's routing is no
        # near-tie (the dense and paged engines compute it from other data):
        # the known reference fault (ROADMAP); a valid token's is noted above
        g = ds.shape[1]
        tok = torch.arange(ds.shape[0] * g, device=ds.device).view(-1, g)
        padded = tok % s_len >= valid_len.to(ds.device)[tok // s_len]
        dropped = (dt.any(-1) != ds.any(-1)).any(-1) & ~chose
        cause = (chose & padded).any(-1, keepdim=True).expand_as(chose)
        hit = dropped & cause
        note(order, tok[hit], torch.zeros(int(hit.sum())), f"capacity at MoE layer {k}, taken "
             f"by a padded position routed otherwise (the known reference fault)")
        note(order, tok[dropped & ~cause], torch.full((int((dropped & ~cause).sum()),),
                                                      math.inf),
             f"capacity at MoE layer {k}, with no choice of its group taken otherwise")
        routes.append((dt, ds, cap))
    sh_exp = {(k, site): (xs, ids) for _, k, site, _, xs, ids in sh.exp}
    order_of = {(k, site): order for order, k, site, *_ in sh.exp}
    for _, k, site, cents, xt, ids in tp.exp:
        xs, ids_s = sh_exp[(k, site)]
        dt, ds, cap = routes[k]
        g = ds.shape[1]
        where = {e: j for j, e in enumerate(ids_s.tolist())}
        for a, e in enumerate(ids.tolist()):
            if e not in where:                        # routed otherwise: noted there
                continue
            # each token kept by expert e in both runs, at its slot in each
            both = (dt[:, :, e].any(-1) & ds[:, :, e].any(-1)).nonzero()
            grp, pos = both[:, 0], both[:, 1]
            row_t = grp * cap + dt[grp, pos, e].float().argmax(-1)
            row_s = grp * cap + ds[grp, pos, e].float().argmax(-1)
            x_s = xs[where[e]][row_s]
            n, rel = code_margins(x_s, cents, expert_codes(xt[a][row_t], cents),
                                  expert_codes(x_s, cents))[:2]
            note(order_of[(k, site)], grp[n] * g + pos[n], rel,
                 f"codes of expert {e} at MoE layer {k} site {site}")
    return flips


class Shadow:
    """A tensor-parallel rank's unsharded twin: each forward of the counted
    burst runs again through the whole model (`model`: bundle and whole
    params) on the same batch, its launches uncounted, with caches of its
    own of the engine's kind (a paged engine's pool geometry, block tables
    and page copies). Per written row: the largest logit distance at its
    valid positions ("dlogit"), and its first decision the rank took
    otherwise (`first_flips`, "flips"), by forward."""

    def __init__(self, eng, model, rank: int):
        from repro_torch.models.attention import PagedSpec

        self.eng, (self.bundle, self.params), self.rank = eng, model, rank
        paged = PagedSpec(eng.pool.n_pages, eng.pool.page_size) if eng.paged else None
        self.caches = self.bundle.init_caches(eng.n_slots, eng.max_seq, dtype=eng.kv_dtype,
                                              device=eng.device, paged=paged)
        self.n, self.seconds = 0, 0.0
        self.dlogit: list = []
        self.flips: list = []
        if eng.paged:
            from repro_torch.configs import cache_leaves

            real = eng._apply_copies

            def apply_copies(pairs):             # the same page copies in the twin's pool
                real(pairs)
                ids = torch.tensor(pairs, dtype=torch.long, device=eng.device)
                for name, t in cache_leaves(self.caches):
                    if name in ("k_pool", "v_pool"):
                        t[:, ids[:, 1]] = t[:, ids[:, 0]]

            eng._apply_copies = apply_copies

    def step(self, toks, cache_len, write_len, logits, dec: Decisions) -> None:
        import numpy as np

        t0 = time.perf_counter()
        with Uncounted(), torch.inference_mode():
            batch = {"tokens": torch.from_numpy(toks).to(self.eng.device),
                     "cache_len": torch.from_numpy(cache_len.astype(np.int64)),
                     "write_len": torch.from_numpy(write_len)}
            if self.eng.paged:
                batch["block_tables"] = torch.from_numpy(self.eng.block_tables)
            else:
                batch["write_rows"] = torch.from_numpy(np.flatnonzero(write_len))
            with Decisions() as sh:
                ls, _ = self.bundle.forward_step(self.params, batch, self.caches,
                                                 compute_dtype=self.eng._compute_dtype)
            s_len = toks.shape[1]
            valid = (torch.arange(s_len, device=ls.device)[None, :]
                     < torch.as_tensor(write_len, device=ls.device)[:, None])
            d = ((logits.float() - ls.float()).abs().amax(-1) * valid).amax(-1).tolist()
            self.dlogit += [(self.n, int(r), d[r]) for r in np.flatnonzero(write_len)]
            self.flips += [(self.n, r, *f) for r, f in
                           first_flips(dec, sh, self.rank, write_len, s_len).items()]
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.n += 1


def shadow_verdict(tag: str, ranks: list, key: str) -> tuple[set, dict]:
    """The requests of a tensor-parallel run that took a decision otherwise
    than the unsharded model, each first at a near-tie (its margin within
    SHADOW_TIE; checked), and the logits of every other written row within
    LOGIT_ATOL of the unsharded model's (checked). Returns (their rids, a
    summary)."""
    rid_of = ranks[0][key]["rids"]
    first: dict = {}
    for rank in ranks:
        for f, row, order, what, m in rank[key]["flips"]:
            rid = rid_of[f][row]
            if rid not in first or (f, order) < first[rid][:2]:
                first[rid] = (f, order, what, m, rank["rank"])
    for rid, (f, _, what, m, r) in sorted(first.items()):
        check(m <= SHADOW_TIE, f"{tag}: request {rid} first left the unsharded model at forward "
                               f"{f}, {what} on rank {r}, with margin {m:.3g} > {SHADOW_TIE}")
    worst = 0.0
    for f, row, d in ranks[0][key]["dlogit"]:
        rid = rid_of[f][row]
        if rid in first and first[rid][0] <= f:
            continue
        check(d <= LOGIT_ATOL, f"{tag}: request {rid}'s logits at forward {f} are {d:.3g} off "
                               f"the unsharded model's with no decision taken otherwise")
        worst = max(worst, d)
    return set(first), {"worst": worst, "first": first,
                        "forwards": len(rid_of), "seconds": [r[key]["shadow_s"] for r in ranks]}


TP_FAMILIES = ("mamba2_370m", "zamba2_1p2b", "arctic_480b")
TP_PAGED = ("zamba2_1p2b", "arctic_480b")        # the families with attention


def hold_moe(label: str, model, layers: list, experts: list) -> dict:
    """Each recorded expert call of a rank held bytewise against the
    unsharded site (the whole params) on the same input and experts, and
    each MoE layer's combined output (the ranks' shares all-reduced in fp32)
    against the unsharded layer on the same input: the elements that differ
    and the largest difference, which must stay within fp32 rounding."""
    from repro_torch.models import moe

    bundle, params = model
    segs = bundle.cfg.segments
    where = [(i, j) for i, (count, _) in enumerate(segs) for j in range(count)]
    out = {"calls": 0, "experts": 0, "layers": 0, "elems": 0, "elems_off": 0, "err": 0.0}
    for k, site, ids, x, y in experts:
        i, j = where[k]
        full = moe.expert_linear(getattr(segs[i][1].moe, site),
                                 params["segments"][i][j]["moe"][site], x, ids)
        check(torch.equal(full, y), f"{label}: layer {k} {site} experts {ids.tolist()[:4]}...: "
                                    f"the rank's output differs from the unsharded site's")
        out["calls"] += 1
        out["experts"] += len(ids)
    for k, x, y in layers:
        i, j = where[k]
        full, _ = moe.moe(segs[i][1].moe, params["segments"][i][j]["moe"], x)
        err = (full - y).abs().max().item()
        check(err <= 1e-5 * max(1.0, full.abs().max().item()),
              f"{label}: layer {k}'s combined output is {err:.3g} off the unsharded layer's")
        out["layers"] += 1
        out["elems"] += y.numel()
        out["elems_off"] += int((full != y).sum())
        out["err"] = max(out["err"], err)
    return out


def tp_family_rank(rank: int, jobs_q, devices: list[str], init: str, q) -> None:
    """One rank of phase 12, in its own process, started before phase 8:
    join the model mesh, wait for the jobs phase 8's models make (None:
    phase 8 failed, the end), then serve each of phase 8's models
    served through the launcher's rank function (`serve_on_mesh`) with a
    `TPProbe` that records every LUT-site call of the counted burst, dense
    and, where the family has attention, paged. The recurrent families load
    their shards from phase 8's artifacts; arctic_480b's params arrive as
    CUDA IPC views of the parent's tensors on the card (phase 8's), so a
    rank's experts are views and nothing of them is copied. Then, on every
    rank, the calls held against the plain versions (`hold_sites`), the row
    sites against the unsharded site (`hold_rows`) and arctic's experts and
    expert combine against the unsharded ones (`hold_moe`)."""
    sys.path.insert(0, str(ROOT / "src"))
    import gc

    import repro_torch  # noqa: F401  (sets the fp32 matmul policy)
    from repro_torch.distributed.tensor_parallel import EXPERT_KINDS
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.artifact import load_artifact

    out: dict = {"rank": rank}
    try:
        t0 = time.perf_counter()
        mesh = make_host_mesh(data=1, model=len(devices), rank=rank, devices=devices,
                              init_method=init, timeout_s=600)
        out["mesh_s"] = time.perf_counter() - t0
        for name, art, model in jobs_q.get(timeout=900) or ():
            tables: dict = {}
            # the unsharded twin's model: the whole params (arctic's are the
            # parent's, viewed; the recurrent two's read from the artifact)
            whole = model
            if whole is None:
                loaded = load_artifact(art, device=mesh.device, restore_autotune=False)
                whole = (loaded.bundle, loaded.params)
            labels = (("dense", []), ("paged", ["--paged", "--page-size", "16"]))
            for label, flags in labels[:2 if name in TP_PAGED else 1]:
                args = serve.parse_args(["--slots", "4", "--max-seq", "256", "--prefill-chunk",
                                         "32", *flags] + (["--artifact", art] if art else
                                                          ["--arch", name]))
                moe_paged = label == "paged" and whole[0].arch.family == "moe"
                probe = TPProbe(mesh, burst=whole_chunk_burst if moe_paged else family_burst,
                                record_all=True, shadow=whole)
                serve.serve_on_mesh(mesh, args, model=model, lead=probe.lead,
                                    on_mark=probe.mark, on_engine=probe.engine)
                res, eng = probe.res, probe.eng
                res["serve_s"] = time.perf_counter() - probe.t0
                res["counts"] = [eng.n_slots, eng.n_slots * eng.prefill_chunk]
                res["expected"] = tp_expected_launches(
                    eng.bundle, eng.layout, res["counts"], res["fwd"]["prefill_forwards"],
                    res["fwd"]["decode_forwards"], mesh.device)
                res["sigs"] = sorted({(s.d_out, s.d_in // s.lut.v) for s in eng.bundle.lut_sites()
                                      if s.kind not in EXPERT_KINDS})
                n_inv = (len(eng.bundle.cfg.invocation_points) if eng.bundle.kind == "hybrid"
                         else 1)
                res["per_forward"] = (lut_calls_per_forward(eng.bundle), sum(
                    n_inv if s.path.startswith("shared/") else 1
                    for s in eng.bundle.lut_sites() if eng.layout.roles.get(s.path) == "row"))
                res["param_gb"] = sum(t.numel() * t.element_size()
                                      for t in _tensors(eng.params)) / 1e9
                res["kept"] = eng.layout.kept
                tag = f"tp12 {name} {label} rank {rank}"
                res["rows_held"] = hold_rows(tag, mesh, probe.rows, tables)
                held = hold_sites(tag, probe.calls)
                res["tie_rows"] = sum(len(r) for r in held.pop("off_rows"))
                res["held"] = held
                if model is not None:
                    res["moe_held"] = hold_moe(tag, model, probe.moe_layers, probe.experts)
                sh = probe.shadow
                res.update(rids=probe.rids, flips=sh.flips, dlogit=sh.dlogit,
                           shadow_s=sh.seconds)
                out[f"{name}/{label}"] = res
                del eng, probe
                gc.collect()
                torch.cuda.empty_cache()
        out["backend"] = mesh.backend
        mesh.close()
        q.put(("ok", out))
    except BaseException:                     # noqa: BLE001 — the parent reports it
        import traceback

        q.put(("error", {"rank": rank, "trace": traceback.format_exc()}))


def phase_tp_families(scratch: Path, fam: dict, started: dict) -> dict:
    """Phase 12: phase 8's models at tp 2 through the launcher's rank
    function, over NCCL when the host has two cards, else both ranks on the
    one card over gloo; phase 8's burst against phase 8's plain run, and per
    rank the launch counts, the holds, the decode forward's wall and busy
    time, the all-reduces per forward and their host time, and memory.
    `started`: the ranks `start_ranks` spawned before phase 8."""
    from repro_torch.launch.mesh import backend_for

    procs, q, devices, n_cards = (started[k] for k in ("procs", "q", "devices", "cards"))
    backend = backend_for(devices)
    log(f"[tp12] tp={TP} on {n_cards} card(s): ranks on {devices}, backend {backend}; "
        + ", ".join(f"{name} ({'artifact' if fam[name]['art'] else 'the card-resident params'})"
                    for name in TP_FAMILIES))
    jobs = [(name, str(fam[name]["art"]) if fam[name]["art"] else None, fam[name]["model"])
            for name in TP_FAMILIES]
    for jq in started["jobs"]:
        jq.put(jobs)
    t0 = time.perf_counter()
    got = wait_ranks(q, TP, 500)
    t_results = time.perf_counter() - t0
    stop_ranks(procs, got[-1][0] == "ok")
    errors = [val["trace"] for status, val in got if status != "ok"]
    check(not errors, "a tp12 rank failed:\n" + "\n".join(errors))
    ranks = sorted((val for _, val in got), key=lambda v: v["rank"])
    log(f"[tp12] both ranks' results in {t_results:.1f}s (3 models, 5 engines; spawned "
        f"{t0 - started['t0']:.1f}s before, beside phase 8: import, mesh "
        f"{ranks[0]['mesh_s']:.1f}s), both exited {time.perf_counter() - t0 - t_results:.1f}s "
        f"later")
    total_mib = int(smi("--query-gpu=memory.total").splitlines()[0])
    out = {"ties": 0, "launches": dict.fromkeys(ranks[0][f"{TP_FAMILIES[0]}/dense"]["launches"], 0),
           "backend": backend, "cards": n_cards}
    for name in TP_FAMILIES:
        for label in ("dense", "paged")[:2 if name in TP_PAGED else 1]:
            key, tag = f"{name}/{label}", f"tp12 {name} {label}"
            # against phase 8's plain run of the same cache kind (MoE paged: of
            # whole-chunk prompts, where the dense and paged engines agree)
            want, _, gaps = fam[name]["paged"] if label == "paged" else (
                fam[name]["want"], None, fam[name]["gaps"])
            lead = ranks[0][key]
            got_reqs = [types.SimpleNamespace(rid=rid, status=status, out_tokens=toks)
                        for rid, status, toks in lead["tokens"]]
            check(all(r.status == "ok" and len(r.out_tokens) == 16 for r in got_reqs),
                  f"{tag}: statuses {[r.status for r in got_reqs]}")
            tied, verdict = shadow_verdict(tag, ranks, key)
            ties = compare_tokens(tag, got_reqs, want, gaps,
                                  sum(rank[key]["tie_rows"] for rank in ranks), tied=tied)
            log(f"[tp12] {name} {label}: every one of {verdict['forwards']} forwards run again by "
                f"the unsharded model on each rank ("
                + ", ".join(f"{t:.1f}" for t in verdict["seconds"]) + " s): logits within "
                f"{verdict['worst']:.3g} of its on every written row of a request that took no "
                f"decision otherwise; {len(tied)} request(s) took one, each first at a near-tie: "
                + ("; ".join(f"request {rid} at forward {f}, {what} on rank {r}, margin {m:.3g}"
                             for rid, (f, _, what, m, r) in sorted(verdict["first"].items()))
                   or "none"))
            out["ties"] += ties
            st = lead["stats"]
            for rank in ranks:
                res, r = rank[key], rank["rank"]
                fwd, coll = res["fwd"], res["coll"]
                n_fwd = fwd["prefill_forwards"] + fwd["decode_forwards"]
                check(fwd["prefill_forwards"] == st["prefill_forwards"]
                      and fwd["decode_forwards"] == st["decode_forwards"],
                      f"{tag} rank {r}: {fwd} forwards, the leader's {st}")
                check(res["plain"] == 0, f"{tag} rank {r}: a plain version ran")
                for kname, n in res["expected"].items():
                    check(res["launches"][kname] == n,
                          f"{tag} rank {r}: {kname} launched {res['launches'][kname]} times, "
                          f"the records say {n}")
                for kname, n in res["launches"].items():
                    out["launches"][kname] += n
                check(sum(res["launches"].values()) > 0, f"{tag}: no kernel launched")
                held, rows = res["held"], res["rows_held"]
                n_lut, n_row = res["per_forward"]
                check(held["sites"] == n_fwd * n_lut and rows["calls"] == 2 * n_row > 0,
                      f"{tag} rank {r}: {held['sites']} LUT-site calls recorded over {n_fwd} "
                      f"forwards of {n_lut}, {rows['calls']} row-site outputs in two forwards of "
                      f"{n_row}")
                moe_line = ""
                if "moe_held" in res:
                    mh = res["moe_held"]
                    check(mh["calls"] > 0 and mh["layers"] > 0, f"{tag} rank {r}: no MoE held")
                    moe_line = (f"; {mh['calls']} expert-site calls ({mh['experts']} experts) "
                                f"bytewise the unsharded sites' on the same inputs; {mh['layers']} "
                                f"MoE layer outputs (the ranks' shares all-reduced in fp32): "
                                f"{mh['elems_off']} of {mh['elems']} elements differ from the "
                                f"unsharded layer's, max abs err {mh['err']:.3g}")
                log(f"[tp12] {name} {label} rank {r}: all {held['sites']} LUT-site calls of the "
                    f"burst ({held['kernels']}) equal to the plain lookup of the encode kernel's "
                    f"codes at the rank's shapes (max abs err {held['err']:.3g}; "
                    f"{held['codes_off']} of {held['codes']} codes off the plain encode's, on "
                    f"{res['tie_rows']} rows, each a tie); {rows['calls']} row-site outputs of "
                    f"the first prefill and decode forward ({rows['rows']} rows) bytewise the "
                    f"unsharded site's on the gathered input and tables ({rows['codes_off']} "
                    f"codes of the unsharded encode off the ranks', each a tie)" + moe_line)
                prof = res["profile"]
                check(res["card_mib"] < total_mib, f"{tag}: the card's memory is full")
                log(f"[tp12] {name} {label} rank {r} ({devices[r]}): load and engine "
                    f"{res['build_s']:.1f}s ({res['tuned']} shapes tuned), served in "
                    f"{res['serve_s']:.1f}s; kept {res['kept']}; site shapes (M, C) "
                    f"{res['sigs']}; decode forward "
                    f"{1e3 * fwd['decode_s'] / max(fwd['decode_forwards'], 1):.2f} ms "
                    f"({fwd['decode_forwards']} fwd), prefill "
                    f"{1e3 * fwd['prefill_s'] / max(fwd['prefill_forwards'], 1):.2f} ms "
                    f"({fwd['prefill_forwards']} fwd); all_reduce "
                    f"{coll['all_reduce'] / n_fwd:.1f} per forward, "
                    f"{1e6 * coll['all_reduce_s'] / max(coll['all_reduce'], 1):.1f} us host each "
                    f"({coll['all_reduce_bytes'] / n_fwd / 1e6:.2f} MB per forward); profiled "
                    f"decode step {prof['wall_us']:.0f} us wall, device busy "
                    f"{prof['busy_us']:.0f} us ({100 * prof['busy_us'] / prof['wall_us']:.1f}%); "
                    f"params {res['param_gb']:.2f} GB, peak {res['peak'] / 2**30:.2f} GiB "
                    f"allocated, {res['reserved'] / 2**30:.2f} GiB reserved; card memory used "
                    f"{res['card_mib']} of {total_mib} MiB (every process); launches "
                    + " ".join(f"{k}={v}" for k, v in res["launches"].items()))
            n_tok = sum(len(r.out_tokens) for r in got_reqs)
            log(f"[tp12] {name} {label}: {n_tok} tokens in {st['wall']:.3f}s "
                f"({n_tok / st['wall']:.2f} tok/s; phase 8 single-process decode forward "
                f"{fam[name]['decode_ms']:.2f} ms); tokens equal phase 8's plain "
                f"{'dense run of whole-chunk prompts' if name == 'arctic_480b' and label == 'paged' else label + ' run'} except "
                f"{ties} near-tie difference(s)")
            out[key] = {"decode_ms": 1e3 * st["decode_s"] / st["decode_forwards"],
                        "tok_s": n_tok / st["wall"]}
    return out


# ---------------------------------------------------------------------------
# phase 7: training on the card
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 2         # depth of phase 7's recipe run (full width always; cut from 28 to
                         # 14, then to 8 when phase 11 came, to 4 when phase 12 came and to 2
                         # when phase 13 came, to keep the whole run in its time limit: its
                         # checkpoints dominate)
TRAIN_STEPS = 4          # steps of its dense and soft-PQ stages
LAUNCHER_STEPS = 60      # the launcher's --steps: ckpt_every = max(50, steps // 4) = 50, so
                         # soft-PQ commits at step 50 and a kill after it resumes there
SPEC_STEPS = 10          # the --spec-draft run's --steps (no kill, so no commit needed; 20
                         # until phase 12 came)
PARITY_LR = 1e-3         # phase 7(a)'s soft-PQ lr (cosine, 2 warm-up steps)


def du(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


class PlainLUT:
    """Every LUT site's `ops.lut_amm` replaced by the plain version of the
    kernel its dispatch chooses, on the same device: where the records
    choose v1, v1's (fp32 sums of the dequantized entries in the record's
    chunks of the codebook sum, then bias and act, as `ops.lut_amm` adds
    them), else the v2 kernel's (what fused and v2 compute, exact int32 sums
    dequantized once): the reference the kernels are held against."""

    def __enter__(self):
        from repro_torch.kernels import autotune, ops, ref

        self.ops, self.real = ops, ops.lut_amm

        def plain(x, c, q, s, *, bias=None, act="none", version=None, blocks=None):
            if version is None:
                version, rec, _ = autotune.kernel_choice(
                    x.shape[0], q.shape[-1], *c.shape, dtype=autotune.dtype_name(x.dtype),
                    backend=autotune.backend_of(x))
                blocks = blocks or rec
            if version != ops.VERSION_V1:
                return ref.lut_amm_v2_plain(x, c, q, s, bias=bias, act=act)
            y = ref.lut_amm_v1_plain(x, c, q, s, block_c=autotune.v1_launch(
                blocks or autotune.DEFAULT)["block_c"])
            if bias is not None:
                y = y + bias.to(y.dtype)
            return ref.apply_act(y, act).to(y.dtype)

        ops.lut_amm = plain
        return self

    def __exit__(self, *exc):
        self.ops.lut_amm = self.real
        return False


class SiteCalls:
    """Keeps every `ops.lut_amm` call made while active: the kernel it
    launched, its inputs and its output (copies: the model may reuse the
    buffers)."""

    def __enter__(self):
        from repro_torch.kernels import counters, ops

        self.ops, self.real, self.calls = ops, ops.lut_amm, []

        def record(x, c, q, s, *, bias=None, act="none", **kw):
            before = counters.launches()
            y = self.real(x, c, q, s, bias=bias, act=act, **kw)
            after = counters.launches()
            kernel = [k for k in after if after[k] != before[k]]
            self.calls.append((kernel, x.clone(), c, q, s, bias, act, y.clone()))
            return y

        ops.lut_amm = record
        return self

    def __exit__(self, *exc):
        self.ops.lut_amm = self.real
        return False


def hold_sites(label: str, calls: list) -> dict:
    """Each recorded LUT-site call held against the plain versions on its own
    inputs. The kernels' lookup is exact given the codes, so every row of
    the output is held against the plain lookup of the codes the encode
    kernel picks for the same input (bytewise where the epilogue is exact:
    m-shared or scalar scale, no exp/tanh activation; else within
    KERNEL_ATOL). Each of those codes that differs from the plain encode's
    must be a tie of the fp32 expansion |a|^2 - 2 a.p + |p|^2: the float64
    distances of the two choices within TIE_EPS of the expansion's terms.
    (A trained site's input lies close to its centroid, so a distance can
    be far below the terms it is summed from, whose rounding decides a
    tie.) Returns the counts, the largest error, and per call the rows
    whose codes differ from the plain encode's ("off_rows")."""
    from repro_torch.kernels import dist_argmin as enc_mod
    from repro_torch.kernels import ref

    out = {"sites": len(calls), "rows": 0, "codes": 0, "codes_off": 0, "rows_off": 0,
           "worst_tie": 0.0, "worst_code": (0.0, 0.0, 0.0), "err": 0.0, "kernels": {},
           "off_rows": []}
    for i, (kernel, x, c, q, s, bias, act, got) in enumerate(calls):
        name = (f"{label} site call {i} ({'/'.join(kernel)}, N={x.shape[0]}, M={q.shape[-1]}, "
                f"C={c.shape[0]})")
        check(len(kernel) == 1 and kernel[0] in ("fused_decode", "lut_amm_v2", "lut_amm_v1"),
              f"{name}: expected one LUT kernel launch")
        out["kernels"][kernel[0]] = out["kernels"].get(kernel[0], 0) + 1
        codes, plain = enc_mod.encode(x, c), ref.encode_ref(x, c)
        if kernel[0] == "lut_amm_v1":
            # v1 sums fp32-dequantized entries in its own order: its plain
            # version, on the rows whose codes the two encodes agree on
            same = (codes == plain).all(dim=1)
            want = ref.apply_act(ref.lut_amm_v1_plain(x, c, q, s) + (0 if bias is None
                                                                      else bias), act)
        else:
            same = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
            want = ref.lookup(codes, q, s, bias=bias, act=act, dtype=x.dtype)
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        if kernel[0] != "lut_amm_v1" and s.shape[0] == 1 and act in ("none", "relu", "relu2"):
            bad = (g != w).any(dim=1)
        else:
            bad = ((g - w).abs() > KERNEL_ATOL * max(1.0, w.abs().max().item())).any(dim=1)
        bad &= same
        check(not bad.any().item(), f"{name}: {int(bad.sum())} rows differ from the plain lookup "
                                    f"of the encode kernel's codes (max err "
                                    f"{(g - w).abs().max().item():.3g})")
        out["err"] = max(out["err"], (g - w).abs().max().item())
        off = codes != plain
        out["rows"] += x.shape[0]
        out["codes"] += codes.numel()
        out["rows_off"] += int(off.any(dim=1).sum())
        out["off_rows"].append(off.any(dim=1).nonzero().flatten().tolist())
        out["codes_off"] += tie_codes(name, x, c, codes, plain, out)
    return out


def code_margins(x, c, codes, plain):
    """Where `codes` differ from `plain` (both (N, C) for the input x and
    centroids c): (their rows, the float64 distance gap of the two choices
    over the fp32 expansion's terms |a|^2 + |p|^2 + 2|a.p|, the distance to
    `plain`'s choice, the terms, the gap)."""
    from repro_torch.core import pq

    n_idx, c_idx = (codes != plain).nonzero(as_tuple=True)
    a = pq.split_subvectors(x.double(), c.shape[-1])[n_idx, c_idx]     # (F, V)
    p1 = c.double()[c_idx, codes.long()[n_idx, c_idx]]
    p2 = c.double()[c_idx, plain.long()[n_idx, c_idx]]
    d2 = ((a - p2) ** 2).sum(-1)
    gap = ((a - p1) ** 2).sum(-1) - d2
    terms = (a * a).sum(-1) + (p1 * p1).sum(-1) + 2 * (a * p1).sum(-1).abs()
    return n_idx, gap.abs() / terms, d2, terms, gap


def tie_codes(name: str, x, c, codes, plain, worst: dict | None = None) -> int:
    """The number of `codes` that differ from `plain` (both (N, C) for the
    input x and centroids c); each must be a tie of the fp32 expansion: the
    float64 distances of the two choices within TIE_EPS of the expansion's
    terms. `worst` keeps the largest such gap ("worst_tie", "worst_code")."""
    if not (codes != plain).any():
        return 0
    n_idx, rel, d2, terms, gap = code_margins(x, c, codes, plain)
    j = int(rel.argmax())
    if worst is not None and rel[j].item() >= worst["worst_tie"]:
        worst["worst_tie"] = rel[j].item()
        worst["worst_code"] = (d2[j].item(), terms[j].item(), gap[j].item())
    check(bool((rel <= TIE_EPS).all()),
          f"{name}: {int((rel > TIE_EPS).sum())} codes differ from the plain encode's "
          f"off a tie of the expansion (worst {rel.max().item():.3g} of its terms)")
    return len(n_idx)


class Timed:
    """Adds the wall time of every call of `module.name` (the card
    synchronized after it) to `self.seconds`, while active."""

    def __init__(self, module, name: str):
        self.module, self.name, self.seconds, self.calls = module, name, 0.0, 0

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def train_step_parity(dev) -> dict:
    """(a) One soft-PQ step at full width and 2 layers, card against CPU."""
    from repro_torch import testing
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.data import MarkovLM
    from repro_torch.optim import SOFT_PQ_RULES, AdamW
    from repro_torch.optim.schedule import cosine_with_warmup

    arch = dataclasses.replace(get_arch("qwen3_1p7b"), n_layers=2)
    bundle = build_model(arch, Mode.LUT_TRAIN)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator().manual_seed(SEED), device="cpu")
    for layer in params["segments"][1]:
        for site in (*layer["attn"].values(), *layer["mlp"].values()):
            if "centroids" in site:
                site["centroids"].mul_(50.0)      # at the activations' scale, as k-means puts them
    batch = MarkovLM(vocab=arch.vocab, seq_len=32, batch=4).batch_at(0)
    opt = AdamW(lr=cosine_with_warmup(PARITY_LR, total_steps=4, warmup_steps=2),
                rules=SOFT_PQ_RULES)
    res = testing.lut_train_step_parity(bundle, params, batch, dev, opt, tie_eps=TIE_EPS,
                                        witness=dev)
    errs = res["grad_errs"]

    def worst(key: str, i: int, n: int = 4) -> str:
        top = sorted(errs.items(), key=lambda kv: -kv[1][key][i])[:n]
        return ", ".join(f"{k} {e[key][0]:.3g}/{e[key][1]:.3g}" for k, e in top)

    ratio = sorted(((max(e["card_f64"][0] / max(e["cpu_f64"][0], testing.FLOOR_L2),
                         e["card_f64"][1] / max(e["cpu_f64"][1], testing.FLOOR_MAX)), k)
                    for k, e in errs.items()), reverse=True)
    log(f"[train] soft-PQ step, full width, 2 layers, {res['tokens']} tokens, card vs CPU, float64 "
        f"on the card as witness ({time.perf_counter() - t0:.1f}s, beside the two-plan launcher run): loss {res['loss_dev']:.7f} "
        f"card, {res['loss_cpu']:.7f} CPU, {res['loss_f64']:.7f} float64; codes picked otherwise "
        f"at a near-tie of {res['codes']}: card {res['pinned_codes']['card']}, float64 "
        f"{res['pinned_codes']['float64']}; fake-quant entries rounded to "
        f"the other integer at a half-integer (|T/scale| within {testing.HALF_EPS}) of "
        f"{res['rounded_entries']}: card {res['rounding_flips']['card']}, float64 "
        f"{res['rounding_flips']['float64']} (the card and float64 take the CPU's codes and "
        f"integers)")
    log(f"[train] {res['grad_leaves']} gradient leaves, gap as a fraction of the leaf's L2 norm / "
        f"largest entry. Card vs CPU (bounds {testing.GRAD_L2} / {testing.GRAD_MAX}), the "
        f"largest: {worst('card_cpu', 1)}. CPU fp32 vs float64: {worst('cpu_f64', 1)}. Card vs "
        f"float64: {worst('card_f64', 1)}. Card's gap over the CPU's (bound {testing.WITNESS}; "
        f"floors {testing.FLOOR_L2} / {testing.FLOOR_MAX}), the largest: "
        + ", ".join(f"{k} {r:.3g}" for r, k in ratio[:4]))
    lt = res["log_t_errs"]
    log(f"[train] log_t, gap over its terms' magnitudes: card vs CPU {lt['card_cpu']:.3g} (bound "
        f"1e-6), card vs float64 {lt['card_f64']:.3g}, CPU vs float64 {lt['cpu_f64']:.3g}; grad "
        f"norm {res['grad_norm'][0]:.6g} card, {res['grad_norm'][1]:.6g} CPU; the card's AdamW "
        f"update equal to the CPU's rule on the card's moment ({res['updated']} elements moved); "
        f"t_mean {res['t_mean']:.4f} t_min {res['t_min']:.4f}")
    check(not res["failures"], "soft-PQ step, card vs CPU: " + "; ".join(res["failures"]))
    return res


def run_recipe(label: str, arch, data, dev, scratch: Path, adir: Path) -> dict:
    """`default_recipe(steps=TRAIN_STEPS)` through `Recipe.run` on `arch`
    (dense pretrain, tape + k-means init, soft-PQ, int8 deploy to `adir`,
    Eval), its stage and step times, checkpoint bytes and peak memory; the
    launch counts read around the run (Eval is its only LUT_INFER forward:
    one kernel per LUT-site call, no plain call), Eval's loss held against
    the plain versions and each of Eval's LUT-site calls against the plain
    version on its own inputs. The stage checkpoints are deleted after."""
    import gc

    from repro_torch.checkpoint import checkpointer as ckpt_mod
    from repro_torch.core import convert, kmeans
    from repro_torch.kernels import counters
    from repro_torch.train.recipe import default_recipe

    free = shutil.disk_usage(scratch).free
    recipe = default_recipe(steps=TRAIN_STEPS, lut=True, artifact_dir=str(adir))
    log(f"[{label}] {arch.name}: d_model {arch.d_model}, d_ff {arch.d_ff}, heads "
        f"{arch.n_heads}/{arch.n_kv_heads}, vocab {arch.vocab}, {arch.n_layers} layers; {data}; "
        f"{recipe.describe()}; {free / 1e9:.1f} GB free on the scratch disk")
    torch.cuda.reset_peak_memory_stats(dev)
    counters.reset()
    with Timed(convert, "kmeans_init_lut") as t_init, Timed(kmeans, "kmeans_per_codebook") as t_km, \
            Timed(convert, "deploy_to_artifact") as t_dep, \
            Timed(ckpt_mod, "reference_arrays") as t_copy, \
            Timed(ckpt_mod.Checkpointer, "_write") as t_write, SiteCalls() as eval_sites:
        t0 = time.perf_counter()
        res = recipe.run(arch, data, ckpt_dir=scratch / "train", device=dev)
        wall = time.perf_counter() - t0
    launches, plain = counters.launches(), counters.plain_calls()
    peak = torch.cuda.max_memory_allocated(dev)
    n_calls = lut_calls_per_forward(res.inf_bundle)
    deployed = res.stage_result("eval")["deployed_loss"]
    # the recipe's only LUT_INFER forward is Eval's: one kernel per LUT-site call
    check(plain == 0, f"{label}: Eval reached a plain version {plain} times")
    lut = launches["fused_decode"] + launches["lut_amm_v2"] + launches["lut_amm_v1"]
    check(lut == n_calls and launches["encode"] == 0,
          f"{label}: Eval launched {launches}, expected one LUT kernel per site call ({n_calls})")
    with PlainLUT(), torch.no_grad():
        batch = {k: v.to(dev) for k, v in data.batch_at(99_999).items()}
        plain_loss = float(res.inf_bundle.loss(res.inf_params, batch,
                                               compute_dtype=torch.float32))
    check(abs(plain_loss - deployed) <= KERNEL_ATOL * abs(plain_loss),
          f"{label}: Eval loss {deployed} through the kernels, {plain_loss} through the plain "
          f"versions")
    # and each site's kernel output in Eval against the plain versions on its inputs
    held = hold_sites(f"{label} Eval", eval_sites.calls)
    del eval_sites
    d_plain, terms, farther = held["worst_code"]
    log(f"[{label}] Eval's {held['sites']} LUT-site calls ({held['kernels']}), N = "
        f"{data.batch * data.seq_len} rows each, {held['rows']} rows: every row equal to the "
        f"plain lookup of the encode kernel's codes (max abs err {held['err']:.3g}); "
        f"{held['codes_off']} of {held['codes']} codes differ from the plain encode's, on "
        f"{held['rows_off']} rows, each a tie of the fp32 expansion (float64 gap at most "
        f"{held['worst_tie']:.3g} of its terms, bound {TIE_EPS}; there the plain choice's "
        f"distance is {d_plain:.9g}, its terms {terms:.6g}, and the encode kernel's choice "
        f"is farther by {farther:.3g})")
    hist = res.histories
    steps = {name: [round(h["seconds"], 3) for h in hist[name]] for name in ("dense", "soft_pq")}
    ck_bytes = {p.name: du(p) for p in sorted((scratch / "train").iterdir()) if p.is_dir()}
    art_bytes = du(adir)
    sp = res.stage_result("soft_pq")
    out = {"step_s": steps, "tape_kmeans_s": t_init.seconds, "kmeans_s": t_km.seconds,
           "kmeans_calls": t_km.calls, "deploy_s": t_dep.seconds, "ckpt_copy_s": t_copy.seconds,
           "ckpt_write_s": t_write.seconds, "artifact_bytes": art_bytes,
           "ckpt_bytes": ck_bytes, "peak_bytes": peak, "wall_s": wall,
           "dense_loss": res.stage_result("dense")["final_loss"], "soft_pq_loss":
           sp["final_loss"], "deployed_loss": deployed, "plain_loss": plain_loss,
           "t_mean": sp["t_mean"], "t_min": sp["t_min"], "eval_launches": launches,
           "eval_sites": held}
    log(f"[{label}] {wall:.1f}s: step seconds {steps}; tape + k-means {t_init.seconds:.2f}s of "
        f"which k-means {t_km.seconds:.2f}s over {t_km.calls} sites; deploy (tables + "
        f"save_artifact) {t_dep.seconds:.2f}s; checkpoints {ck_bytes} bytes, {t_copy.calls} "
        f"saves: host copy {t_copy.seconds:.2f}s, writes {t_write.seconds:.2f}s (a background "
        f"thread, waited for at each stage's end); artifact {art_bytes} bytes; peak device "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"[{label}] losses: dense {out['dense_loss']:.4f}, soft-PQ {out['soft_pq_loss']:.4f}, "
        f"deployed {deployed:.6f} through the kernels, {plain_loss:.6f} through the plain "
        f"versions (bound {KERNEL_ATOL} relative); t_mean {sp['t_mean']:.4f} t_min "
        f"{sp['t_min']:.4f}; Eval launches "
        + " ".join(f"{k}={v}" for k, v in launches.items()) + f", plain calls {plain}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(scratch / "train")
    return out


def recipe_full_width(dev, scratch: Path) -> dict:
    """(b) default_recipe at the published width through Recipe.run, the
    Eval stage through the kernels (held against the plain versions), then
    the trained artifact served with measured warm-up."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.data import MarkovLM
    from repro_torch.launch.serve import chosen_versions
    from repro_torch.serving.artifact import load_artifact
    from repro_torch.serving.engine import ServingEngine

    # a fresh autotune cache: the trained artifact's warm-up measures its own
    # records (none from phase 4 ride in its snapshot)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(scratch / "autotune_train.json")
    arch = dataclasses.replace(get_arch("qwen3_1p7b"), n_layers=TRAIN_LAYERS,
                               lut_use_kernel=True)
    data = MarkovLM(vocab=arch.vocab, seq_len=256, batch=4)
    adir = scratch / "trained"
    out = run_recipe("recipe", arch, data, dev, scratch, adir)

    # the trained artifact, served: measured warm-up, then the phase-4 burst
    # against the same engine over the plain versions
    t0 = time.perf_counter()
    art = load_artifact(adir, device=dev)
    kw = dict(n_slots=4, max_seq=256, prefill_chunk=32, device=dev)
    eng = ServingEngine(art.bundle, art.params, **kw)
    counts = [4, 4 * 32]
    versions = chosen_versions(art.bundle, counts, "float32", dev)
    v1 = sorted(sig for sig, vs in versions.items() if 1 in vs)
    log(f"[recipe] trained artifact loaded and warmed up in {time.perf_counter() - t0:.1f}s "
        f"({eng.n_lut_shapes_tuned} lut_amm shapes measured); version per site (M, C, K, V) at "
        f"N={counts}: " + ", ".join(f"{sig}: {vs}" for sig, vs in versions.items())
        + (f"; v1 picked at {v1}" if v1 else "; no record picks v1"))
    check(eng.n_lut_shapes_tuned > 0, "the trained artifact's warm-up measured nothing")
    burst = phase4_burst(art.bundle.arch.vocab)
    with PlainLUT():
        plain_eng = ServingEngine(art.bundle, art.params, **kw)
        want, _, gaps = plain_run(plain_eng, burst)
    del plain_eng
    _, st, _, ties = driven("trained artifact", eng, burst, want, gaps)
    out.update(versions={str(k): v for k, v in versions.items()}, v1_sites=len(v1),
               serve_ties=ties)
    del eng, art
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(adir)
    return out


def run_logged(cmd: list[str], log_path: Path, timeout: float,
               autotune_cache: Path | None = None) -> str:
    """Run a launcher to its end; fail on a non-zero exit. Returns its output.
    `autotune_cache`: the run's own autotune records, for a launcher that
    runs beside this process's engines (the two would otherwise rewrite one
    file)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if autotune_cache is not None:
        env["REPRO_AUTOTUNE_CACHE"] = str(autotune_cache)
    with log_path.open("w") as f:
        proc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, env=env, timeout=timeout)
    text = log_path.read_text()
    check(proc.returncode == 0, f"{' '.join(cmd[2:5])} exited {proc.returncode}: {text[-3000:]}")
    return text


def launcher_resume(scratch: Path) -> dict:
    """(c) The training launcher at its default size: killed mid soft-PQ and
    re-run, its artifact served, beside (b); its own autotune records."""
    cache = scratch / "autotune_resume.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_AUTOTUNE_CACHE=str(cache))
    py = [sys.executable, "-m"]
    ck, art = scratch / "launch_ck", scratch / "launch_art"
    train = py + ["repro_torch.launch.train", "--lut", "--steps", str(LAUNCHER_STEPS),
                  "--ckpt-dir", str(ck), "--artifact-dir", str(art)]
    out: dict = {}
    t0 = time.perf_counter()
    first = scratch / "train_killed.log"
    with first.open("w") as f:
        proc = subprocess.Popen(train, stdout=f, stderr=subprocess.STDOUT, env=env)
    manifest = ck / "recipe_run.json"
    deadline = time.perf_counter() + 300
    stage = {}
    while proc.poll() is None and time.perf_counter() < deadline:
        try:
            stage = {e["name"]: e for e in json.loads(manifest.read_text())["stages"]}
        except (OSError, ValueError, KeyError):
            stage = {}
        if stage.get("soft_pq", {}).get("step") is not None:
            proc.send_signal(signal.SIGKILL)
            break
        time.sleep(0.01)
    proc.wait(timeout=60)
    check(proc.returncode == -signal.SIGKILL,
          f"the launcher was not killed mid soft-PQ (exit {proc.returncode}): "
          f"{first.read_text()[-2000:]}")
    stage = {e["name"]: e for e in json.loads(manifest.read_text())["stages"]}
    committed = stage["soft_pq"]["step"]
    check(stage["dense"]["status"] == stage["centroid_init"]["status"] == "done"
          and stage["soft_pq"]["status"] == "running" and committed,
          f"manifest after the kill: {[(n, e['status'], e['step']) for n, e in stage.items()]}")
    text = run_logged(train, scratch / "train_resumed.log", 600, autotune_cache=cache)
    softpq = text.split("[soft_pq]", 1)[-1]
    first_step = re.search(r"step\s+(\d+) loss", softpq)
    check("[dense] already done — restored" in text
          and "[centroid_init] already done — restored" in text
          and first_step is not None and int(first_step.group(1)) == committed
          and "wrote LUTArtifact" in text,
          f"the re-run did not resume soft-PQ at step {committed}: {text[-3000:]}")
    out["killed_at_commit"] = committed
    log(f"[launcher] --steps {LAUNCHER_STEPS}: SIGKILL after soft-PQ committed step {committed}; "
        f"the re-run restored dense and centroid_init, resumed soft-PQ at step "
        f"{first_step.group(1)} and wrote the artifact ({time.perf_counter() - t0:.1f}s)")
    for line in text.splitlines():
        if line.startswith(("[eval]", "step ")):
            log(f"  {line}")
    text = run_logged(py + ["repro_torch.launch.serve", "--artifact", str(art)],
                      scratch / "serve.log", 600, autotune_cache=cache)
    check(f"artifact {art}" in text, f"serve did not name its artifact: {text[-2000:]}")
    log("[launcher] served: " + " | ".join(l.strip() for l in text.splitlines()[:3]))

    for d in (ck, art):
        shutil.rmtree(d, ignore_errors=True)
    return out


def launcher_spec(scratch: Path) -> dict:
    """(c)'s second part, run beside (a): a `--steps SPEC_STEPS --spec-draft
    attn/*` run (a two-plan artifact) served with speculative decoding; its
    own autotune records."""
    py = [sys.executable, "-m"]
    ck2, art2 = scratch / "launch_ck2", scratch / "launch_art2"
    cache = scratch / "autotune_spec.json"
    t0 = time.perf_counter()
    run_logged(py + ["repro_torch.launch.train", "--lut", "--steps", str(SPEC_STEPS),
                     "--spec-draft", "attn/*", "--ckpt-dir", str(ck2), "--artifact-dir",
                     str(art2)], scratch / "train_spec.log", 600, autotune_cache=cache)
    text = run_logged(py + ["repro_torch.launch.serve", "--artifact", str(art2),
                            "--spec-decode", "--draft-plan", "draft"],
                      scratch / "serve_spec.log", 600, autotune_cache=cache)
    m = re.search(r"acceptance=([\d.]+) target_forwards_per_token=([\d.]+)", text)
    check(m is not None, f"no spec line: {text[-2000:]}")
    out = {"acceptance": float(m.group(1)), "tfpt": float(m.group(2))}
    log(f"[launcher] two-plan artifact (target keeps attn/* dense, the trained plan as the "
        f"draft) trained for --steps {SPEC_STEPS} and served with --spec-decode in "
        f"{time.perf_counter() - t0:.1f}s (beside (a)'s step parity): "
        f"acceptance {out['acceptance']}, target forwards per token {out['tfpt']}")
    for d in (ck2, art2):
        shutil.rmtree(d, ignore_errors=True)
    return out


def phase_train(dev, scratch: Path) -> dict:
    import gc

    # (c)'s launcher runs, processes of their own at the launcher's default
    # size, go beside the rest: the two-plan run beside (a), whose time is
    # mostly the CPU's side of the parity, the killed and resumed run beside
    # (b), whose step and stage times are taken beside it
    pool = ThreadPoolExecutor(max_workers=1)
    spec = pool.submit(launcher_spec, scratch)
    out = {"step": train_step_parity(dev)}
    spec_out = spec.result(timeout=900)
    gc.collect()
    torch.cuda.empty_cache()
    resume = pool.submit(launcher_resume, scratch)
    out["recipe"] = recipe_full_width(dev, scratch)
    out["launcher"] = resume.result(timeout=900) | spec_out
    pool.shutdown()
    return out


# ---------------------------------------------------------------------------
# phase 8: the MoE, SSM and hybrid families at full width
# ---------------------------------------------------------------------------

ARCTIC_LAYERS = 2        # arctic_480b's depth in phases 8 and 12: layer 0 dense, layer 1 LUT
# depth of phase 8's recurrent families (full width; cut from 48 and 38 so that
# chip_smoke keeps inside its time limit with phase 11, then from 24 to 12 so
# that phase 12 serves the same models at tp 2, then both to 6 with phase 13):
# zamba2_1p2b's shared block (after every 6th layer) runs once
SERVE_FAMILY_LAYERS = {"mamba2_370m": 6, "zamba2_1p2b": 6, "arctic_480b": ARCTIC_LAYERS}
# prompt lengths of phase 8's burst at a prefill chunk of 32: exactly one
# chunk, exactly two, ragged over two chunks and ragged inside one
FAMILY_PROMPTS = (32, 64, 45, 17, 32, 50, 9, 60)
# whole prefill chunks: the burst of phase 12's paged MoE engine. On a ragged
# chunk the paged engine's MoE output depends on what its pages held before
# (padded positions read stale pages and take expert capacity: a known
# reference fault, ROADMAP), so it is held where the engines are defined
WHOLE_CHUNK_PROMPTS = (32, 64, 64, 32, 32, 64, 32, 64)


def family_burst(vocab: int, lengths=FAMILY_PROMPTS) -> list[tuple[list[int], object]]:
    """8 requests of `lengths` tokens, requests SAMPLED sampled."""
    from repro_torch.serving.sampling import SamplingParams

    gen = torch.Generator().manual_seed(SEED + 20)
    return [(torch.randint(0, vocab, (n,), generator=gen).tolist(),
             SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=SEED + 20 + i)
             if i in SAMPLED else None) for i, n in enumerate(lengths)]


def whole_chunk_burst(vocab: int) -> list[tuple[list[int], object]]:
    return family_burst(vocab, WHOLE_CHUNK_PROMPTS)


class FirstForwards:
    """Records (`SiteCalls`) every LUT-site call of an engine's first forward
    at each token count N: each LUT site's first launch at each shape."""

    def __init__(self, eng):
        self.eng, self.calls, self.seen = eng, [], set()

    def __enter__(self):
        real = self.eng._forward

        def forward(toks, cache_len, write_len, model=None):
            if toks.size in self.seen:
                return real(toks, cache_len, write_len, model)
            self.seen.add(toks.size)
            with SiteCalls() as rec:
                out = real(toks, cache_len, write_len, model)
            self.calls += rec.calls
            return out

        self.eng._forward = forward
        return self

    def __exit__(self, *exc):
        del self.eng._forward
        return False


def lut_calls_per_forward(bundle) -> int:
    """LUT-site calls of one forward through common.linear: the expert sites
    contract in plain tensor ops, and the hybrid's shared block runs once
    per invocation."""
    n_inv = len(bundle.cfg.invocation_points) if bundle.kind == "hybrid" else 1
    return sum(n_inv if s.path.startswith("shared/") else 1 for s in bundle.lut_sites()
               if s.kind not in ("moe/gate", "moe/up", "moe/down"))


def time_signatures(label: str, bundle, counts: list[int], dev) -> list[dict]:
    """Each LUT kernel site signature of the bundle at each token count: the
    kernel its record chooses (through ops.lut_amm) and the plain version,
    timed on random inputs of the site's shape, with the byte bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import chosen_versions

    gen = torch.Generator().manual_seed(SEED + 21)
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    rows = []
    for (m, c, k, v), vers in chosen_versions(bundle, counts, "float32", dev).items():
        for n, ver in zip(counts, vers):
            x, p, q, sc = make_site(n, c, m, gen, dev, k=k, v=v)
            ms = time_ms(lambda: ops.lut_amm(x, p, q, sc), flush)
            plain = time_ms(lambda: ref.lut_amm_v2_plain(x, p, q, sc), flush)
            bound, by = bound_ms(n, c, k, v, m, 4, kernel=KERNEL_OF_VERSION[ver])
            rows.append({"sig": (m, c, k, v), "n": n, "kernel": KERNEL_OF_VERSION[ver],
                         "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by})
            log(f"  [{label}] N={n} (M, C, K, V)={(m, c, k, v)}: {KERNEL_OF_VERSION[ver]} "
                f"{ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, bound {bound * 1e3:.3f} us "
                f"({by})")
    return rows


def check_auto_disable(label: str, bundle, params, dev) -> None:
    """A recurrent family turns speculative decoding and prefix sharing off,
    each with its warning, and serves on."""
    import warnings

    from repro_torch.serving.engine import ServingEngine

    kw = dict(n_slots=4, max_seq=256, prefill_chunk=32, device=dev, autotune_lut=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        spec = ServingEngine(bundle, params, **kw, spec_decode=True)
        paged = ServingEngine(bundle, params, **kw, paged=True, page_size=16)
    text = [str(w.message) for w in caught]
    check(spec.spec is None and any(t.startswith("spec_decode disabled") for t in text),
          f"{label}: speculative decoding did not auto-disable with its warning ({text})")
    check(not paged.pool.prefix_sharing and any(t.startswith("prefix sharing disabled")
                                                 for t in text),
          f"{label}: prefix sharing did not auto-disable with its warning ({text})")
    log(f"[families] {label}: spec_decode and prefix sharing auto-disabled, warnings: "
        + " | ".join(t.split(":")[0] for t in text))
    del spec, paged


def serve_family(label: str, bundle, params, dev, *, recurrent: bool,
                 hold_all: bool = False, paged_plain: bool = False) -> dict:
    """Phase 8's path for one model: the measured warm-up, the burst through
    the plain versions, then through the kernels (counts set to 0 before,
    read after) with every LUT site's first launch at each N held against
    the plain version; a profiled decode step; the new signatures timed."""
    from repro_torch.kernels import autotune
    from repro_torch.launch.serve import chosen_versions
    from repro_torch.serving.engine import ServingEngine

    kw = dict(n_slots=4, max_seq=256, prefill_chunk=32, device=dev)
    counts = [4, 4 * 32]
    t0 = time.perf_counter()
    eng = ServingEngine(bundle, params, **kw)
    t_tune = time.perf_counter() - t0
    versions = chosen_versions(bundle, counts, "float32", dev)
    cache = autotune.get_cache()
    for sig in versions:
        for n in counts:
            rec = cache.get(autotune.shape_key("lut_amm", n, *sig, "float32",
                                               autotune.BACKEND_CUDA))
            check(rec is not None and rec["measured"], f"{label}: no measured record at N={n} "
                                                       f"{sig}")
    log(f"[families] {label}: measured warm-up {t_tune:.1f}s, {eng.n_lut_shapes_tuned} lut_amm "
        f"shapes tuned; version per site (M, C, K, V) at N={counts}: "
        + ", ".join(f"{sig}: {vs}" for sig, vs in versions.items()))
    if recurrent:
        check_auto_disable(label, bundle, params, dev)
    burst = family_burst(bundle.arch.vocab)
    with PlainLUT():
        plain_eng = ServingEngine(bundle, params, **kw, autotune_lut=False)
        want, st_plain, gaps = plain_run(plain_eng, burst)
        paged = None
        if paged_plain:
            # phase 12's reference for its paged engines: the plain paged run,
            # or for MoE the plain run of whole-chunk prompts
            paged = plain_run(ServingEngine(bundle, params, **kw, autotune_lut=False, paged=True,
                                            page_size=16), burst)
            n_off = sum(a.out_tokens != b.out_tokens for a, b in zip(paged[0], want))
            moe = bundle.arch.family == "moe"
            log(f"[families] {label}: the plain paged engine (page 16): {n_off} of "
                f"{len(want)} requests' tokens differ from the plain dense engine's"
                + (" (padded positions of a ragged chunk read stale pages, not the chunk, and "
                   "take expert capacity before the chunk's second choices: a known reference "
                   "fault, ROADMAP)" if n_off and moe else ""))
            if moe:
                paged = plain_run(plain_eng, whole_chunk_burst(bundle.arch.vocab))
    del plain_eng
    with FirstForwards(eng) as first:
        reqs, st, by_n, ties = driven(label, eng, burst, want, gaps, tag="families",
                                      hold_all=hold_all)
    held = hold_sites(label, first.calls)
    n_calls = lut_calls_per_forward(bundle)
    check(held["sites"] == n_calls * len(counts),
          f"{label}: {held['sites']} first site calls recorded, expected {n_calls} LUT sites x "
          f"{len(counts)} token counts")
    log(f"[families] {label}: each LUT site's first launch at N={counts} ({held['sites']} calls, "
        f"{held['kernels']}) equal to the plain lookup of the encode kernel's codes (max abs err "
        f"{held['err']:.3g}); {held['codes_off']} of {held['codes']} codes differ from the plain "
        f"encode's, each a tie of the fp32 expansion")
    launches = {k: sum(row[k] for row in by_n.values()) for k in next(iter(by_n.values()))}
    wall, busy = profile_decode(eng, bundle.arch.vocab, torch.Generator().manual_seed(SEED + 22))
    log(f"[families] {label}: decode {st['decode_tok_s']:.2f} tok/s ({st['decode_tokens']} tok / "
        f"{st['decode_forwards']} fwd), prefill {st['prefill_tok_s']:.2f} tok/s, burst "
        f"{st['wall']:.2f}s (plain versions {st_plain['wall']:.2f}s); launches "
        + " ".join(f"{k}={v}" for k, v in launches.items())
        + f"; profiled decode step {wall:.0f} us wall, device busy {busy:.0f} us "
          f"({100 * busy / wall:.1f}%); near-tie token differences {ties}")
    sigs = time_signatures(label, bundle, counts, dev)
    del eng
    return {"launches": launches, "ties": ties, "decode_tok_s": st["decode_tok_s"],
            "busy_share": busy / wall, "step_wall_us": wall, "step_busy_us": busy,
            "versions": {str(k): v for k, v in versions.items()}, "sigs": sigs,
            "first_sites": held["sites"], "tune_s": t_tune, "want": want, "gaps": gaps,
            "paged": paged,
            "tokens": reqs, "decode_ms": 1e3 * st["decode_s"] / st["decode_forwards"]}


def phase_families(dev, scratch: Path) -> dict:
    """Phase 8: mamba2_370m and zamba2_1p2b at full width and
    SERVE_FAMILY_LAYERS layers through artifacts; arctic_480b at full width
    with ARCTIC_LAYERS layers, its params built on the card. Phase 12 serves
    the same models: each result keeps the plain run's requests and gaps,
    the recurrent families' artifact ("art") and arctic's model ("model",
    its params on the card)."""
    import gc

    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.serving import artifact

    out = {}
    for name in ("mamba2_370m", "zamba2_1p2b", "arctic_480b"):
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)        # what the earlier phases left
        t0 = time.perf_counter()
        arch = dataclasses.replace(get_arch(name), lut_use_kernel=True,
                                   n_layers=SERVE_FAMILY_LAYERS[name])
        bundle = build_model(arch, Mode.LUT_INFER)
        params = bundle.init(torch.Generator(device=dev).manual_seed(SEED + 23), device=dev)
        n_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
        where = "built on the card"
        path = None
        if name != "arctic_480b":
            path = artifact.save_artifact(scratch / name, bundle, params)
            del params
            art = artifact.load_artifact(path, device=dev)
            bundle, params = art.bundle, art.params
            del art
            where = "exported as an artifact and loaded"
        log(f"[families] {name}: {arch.n_layers} layers, d_model {arch.d_model}, vocab "
            f"{arch.vocab}, {len(bundle.lut_sites())} LUT sites, {n_bytes / 1e9:.2f} GB of params "
            f"({arch.param_dtype}), {where} in {time.perf_counter() - t0:.1f}s")
        # the recurrent families' burst held call by call, as 10 (b) holds
        # the trained ones: a code picked at a tie inside the kernels is then
        # counted and may explain a request's difference
        res = serve_family(name, bundle, params, dev, recurrent=name != "arctic_480b",
                           hold_all=name != "arctic_480b", paged_plain=name in TP_PAGED)
        res["peak_gib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        res["param_bytes"] = n_bytes
        log(f"[families] {name}: peak device memory {res['peak_gib']:.2f} GiB above the "
            f"{base / 2**30:.2f} GiB the earlier phases left allocated")
        res.update(art=path, model=(bundle, params) if path is None else None)
        out[name] = res
        del bundle, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: the enc-dec and vision-LM families at full width
# ---------------------------------------------------------------------------

ROWS9 = 4                # batch rows of phase 9's forwards
VLM_SERVE_LAYERS = 4     # qwen2_vl_7b's depth in phases 9 and 16 (a) (full width; cut from
                         # 28 so that chip_smoke keeps inside its time limit with phase
                         # 11, then from 8 with phase 16)
WHISPER_PROMPT = 8       # decoder tokens of whisper's prefill, beside its frames
VLM_GRID = (4, 8)        # qwen2_vl's prefill: a 4 x 8 grid of patch embeddings ...
VLM_TEXT = 8             # ... then 8 text tokens' embedding rows
GREEDY_STEPS = 16        # greedy decode steps after each prefill
MAX_SEQ9 = 64            # cache positions per row (4 pages of 16 in the paged run)
# phase 9's artifacts, kept for phase 16's ranks to read their shards of: {arch: path}
KEPT_ARTIFACTS: dict[str, str] = {}


def greedy_forwards(bundle, params, batch: dict, caches, feed, *,
                    record: list | None = None, step=None) -> dict:
    """`batch` (a prefill) through `ModelBundle.forward_step` (or `step(batch,
    caches)`), then GREEDY_STEPS greedy decode steps, each next input
    `feed(tokens (B, 1))`. Each forward is timed with the card synchronized
    around it; `record` collects each forward's LUT-site calls
    (`SiteCalls`), one list per forward. Returns the tokens (B, 1 + steps),
    the top-2 logit gap of each, and the seconds of the prefill and of each
    decode forward."""
    toks, gaps, secs = [], [], []
    cache_len = batch["cache_len"]
    step = step or (lambda b, c: bundle.forward_step(params, b, c))
    with torch.inference_mode():
        for i in range(1 + GREEDY_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if record is not None:
                with SiteCalls() as rec:
                    logits, caches = step(batch, caches)
                record.append(rec.calls)
            else:
                logits, caches = step(batch, caches)
            last = logits[:, -1].float()
            top2 = last.topk(2, dim=-1).values
            nxt = last.argmax(-1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            check(bool(torch.isfinite(logits).all()) and logits.shape[-1] == bundle.arch.vocab,
                  f"{bundle.arch.name}: forward {i} gave non-finite or misshapen logits")
            toks.append(nxt.cpu())
            gaps.append((top2[:, 0] - top2[:, 1]).cpu())
            cache_len = cache_len + logits.shape[1]
            batch = {**{k: v for k, v in batch.items() if k == "block_tables"},
                     "cache_len": cache_len, **feed(nxt[:, None])}
    return {"tokens": torch.stack(toks, 1), "gaps": torch.stack(gaps, 1), "prefill_s": secs[0],
            "decode_s": secs[1:], "caches": caches, "last": batch}


def held_forwards(label: str, per_forward: list[list]) -> tuple[dict, dict[int, int]]:
    """Every LUT-site call of a kernel run's forwards (`greedy_forwards`'
    record) held against the plain versions (`hold_sites`). Returns the
    counts and, for each batch row with a code the kernels picked otherwise
    than the plain encode (each at a tie of the fp32 expansion), the first
    forward that did: from there on the row's values, and its tokens, may
    leave the plain run's (a code picks a table row of its own, so one
    flip moves a site's output by a table entry, not by a rounding)."""
    calls = [c for fwd in per_forward for c in fwd]
    held = hold_sites(label, calls)
    taint: dict[int, int] = {}
    k = 0
    for i, fwd in enumerate(per_forward):
        for _, x, *_ in fwd:
            per_row = x.shape[0] // ROWS9
            for n in held["off_rows"][k]:
                taint[n // per_row] = min(taint.get(n // per_row, i), i)
            k += 1
    return held, taint


def compare_greedy(label: str, got: dict, want: dict, taint: dict[int, int]) -> int:
    """Each row's greedy tokens against the plain run's: equal, or equal up
    to a first difference where the plain run's top-2 logit gap is a
    near-tie, or at or after the forward where the kernels picked a code at
    a tie in that row (`held_forwards`); the rest follows another token and
    is not compared. Returns the number of such differences."""
    ties = 0
    for r in range(got["tokens"].shape[0]):
        diff = (got["tokens"][r] != want["tokens"][r]).nonzero()
        if not len(diff):
            continue
        j = int(diff[0])
        gap = float(want["gaps"][r, j])
        why = (f"a code picked at a tie in forward {taint[r]}" if taint.get(r, j + 1) <= j
               else f"a near-tie (top-2 gap {gap:.3g})")
        check(gap <= TOKEN_TIE or taint.get(r, j + 1) <= j,
              f"{label}: row {r} differs from the plain run at token {j}, where its top-2 gap "
              f"is {gap:.3g} (tie bound {TOKEN_TIE}) and no code of the row was picked at a tie")
        log(f"  {label}: row {r} differs from the plain run from token {j} on, after {why}")
        ties += 1
    return ties


def kernel_run(label: str, bundle, counts: list[int], dev, fn):
    """fn() through the kernels, the launch counts set to 0 just before and
    read just after: every kernel the records choose at these token counts
    launched, no plain version called. Returns (fn's result, launches)."""
    from repro_torch.kernels import counters
    from repro_torch.launch.serve import chosen_versions

    counters.reset()
    out = fn()
    launches, plain = counters.launches(), counters.plain_calls()
    chosen = {KERNEL_OF_VERSION[ver] for vers in chosen_versions(bundle, counts, "float32",
                                                                 dev).values() for ver in vers}
    check(plain == 0, f"{label}: a plain version ran on the card ({plain} calls)")
    check(all(launches[k] > 0 for k in chosen), f"{label}: the records choose {sorted(chosen)} "
                                                f"at N={counts}; launched {launches}")
    return out, launches


def profile_forward(fn, n_steps: int = 8) -> tuple[float, float, dict]:
    """(wall us, device-busy us, device us by kernel) per call of fn, over
    n_steps calls under torch.profiler after one warm call."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
    by_kernel = device_times(prof)
    return wall / n_steps, sum(by_kernel.values()) / n_steps, \
        {k: v / n_steps for k, v in by_kernel.items()}


def family_model(name: str, dev, scratch: Path, n_layers: int | None = None,
                 keep: bool = False):
    """(bundle, params, param bytes) of `name` at full published width and
    depth (or `n_layers`), LUT_INFER through the kernels: built on the card
    from a seed, exported as an artifact and loaded back; the artifact is
    deleted, or with `keep` kept for phase 16 (its path then the bundle's
    `artifact` in `KEPT_ARTIFACTS`)."""
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.serving import artifact

    t0 = time.perf_counter()
    arch = dataclasses.replace(get_arch(name), lut_use_kernel=True)
    if n_layers is not None:
        arch = dataclasses.replace(arch, n_layers=n_layers)
    bundle = build_model(arch, Mode.LUT_INFER)
    params = bundle.init(torch.Generator(device=dev).manual_seed(SEED + 30), device=dev)
    n_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    path = artifact.save_artifact(scratch / name, bundle, params)
    del params
    art = artifact.load_artifact(path, device=dev)
    if keep:
        KEPT_ARTIFACTS[name] = str(path)
    else:
        shutil.rmtree(path)
    log(f"[encdec/vlm] {name}: {art.bundle.kind}, {arch.n_layers} layers"
        + (f" + {arch.n_enc_layers} encoder layers over {arch.enc_frames} frames"
           if arch.n_enc_layers else "")
        + f", d_model {arch.d_model}, vocab {arch.vocab}, {len(art.bundle.lut_sites())} LUT "
          f"sites, {n_bytes / 1e9:.2f} GB of params, exported as an artifact and loaded in "
          f"{time.perf_counter() - t0:.1f}s")
    return art.bundle, art.params, n_bytes


def tune_family(label: str, bundle, counts: list[int], dev) -> dict:
    """The measured warm-up at the phase's token counts (`warm_lut_autotune`,
    and the encode records), each record checked measured; logs the
    version per site signature."""
    from repro_torch.kernels import autotune
    from repro_torch.launch.serve import chosen_versions
    from repro_torch.serving.engine import warm_lut_autotune

    t0 = time.perf_counter()
    tuned = warm_lut_autotune(bundle, counts, device=dev)
    n_enc = tune_encode_records(bundle, counts, dev)
    versions = chosen_versions(bundle, counts, "float32", dev)
    for sig in versions:
        for n in counts:
            rec = autotune.get_cache().get(autotune.shape_key("lut_amm", n, *sig, "float32",
                                                              autotune.BACKEND_CUDA))
            check(rec is not None and rec["measured"], f"{label}: no measured record at N={n} "
                                                       f"{sig}")
    log(f"[encdec/vlm] {label}: measured warm-up {time.perf_counter() - t0:.1f}s ({tuned} "
        f"lut_amm and {n_enc} encode shapes); version per site (M, C, K, V) at N={counts}: "
        + ", ".join(f"{sig}: {vs}" for sig, vs in versions.items()))
    return {str(k): v for k, v in versions.items()}


def check_refused(label: str, bundle, params, dev, reason: str) -> None:
    """ServingEngine refuses the family at construction, naming why."""
    from repro_torch.serving.engine import ServingEngine

    try:
        ServingEngine(bundle, params, device=dev, autotune_lut=False)
    except ValueError as e:
        check(reason in str(e), f"{label}: the engine refused with {e}")
        log(f"[encdec/vlm] {label}: ServingEngine refuses it: {e}")
        return
    check(False, f"{label}: ServingEngine did not refuse it")


def report_family(label: str, bundle, held: dict, want: dict, got: dict, launches: dict,
                  ties: int, dev, counts: list[int]) -> dict:
    """Log the held first site calls, the forwards' times and a profiled
    decode forward; time the new site signatures. Returns the numbers."""
    log(f"[encdec/vlm] {label}: every LUT-site call of the kernel run (each site's first "
        f"launch at N={counts} among them; {held['sites']} calls, {held['kernels']}) equal to "
        f"the plain lookup of the encode kernel's codes (max abs err {held['err']:.3g}); "
        f"{held['codes_off']} of {held['codes']} codes differ from the plain encode's, on "
        f"{held['rows_off']} rows, each a tie of the fp32 expansion (at most "
        f"{held['worst_tie']:.3g} of its terms)")
    dec_ms = 1e3 * sum(got["decode_s"]) / len(got["decode_s"])
    last = got["last"]
    wall, busy, by_kernel = profile_forward(
        lambda: bundle.forward_step(got["params"], last, got["caches"]))
    log(f"[encdec/vlm] {label}: prefill forward {1e3 * got['prefill_s']:.1f} ms (plain versions "
        f"{1e3 * want['prefill_s']:.1f}), decode forward {dec_ms:.2f} ms mean over "
        f"{len(got['decode_s'])} (plain {1e3 * sum(want['decode_s']) / len(want['decode_s']):.2f})"
        f"; launches " + " ".join(f"{k}={v}" for k, v in launches.items())
        + f"; tokens equal the plain run's except {ties} near-tie difference(s); profiled decode "
          f"forward {wall:.0f} us wall, device busy {busy:.0f} us ({100 * busy / wall:.1f}%: "
        + ", ".join(f"{k} {v:.0f} us" for k, v in sorted(by_kernel.items())) + ")")
    sigs = time_signatures(label, bundle, counts, dev)
    return {"launches": launches, "ties": ties, "prefill_ms": 1e3 * got["prefill_s"],
            "decode_ms": dec_ms, "busy_share": busy / wall, "step_wall_us": wall,
            "step_busy_us": busy, "site_calls_held": held["sites"], "sigs": sigs}


def phase9_whisper(dev, scratch: Path, model: tuple | None = None) -> dict:
    """whisper_tiny at full width and depth: 4 rows of stub frames, an
    8-token prefill with them (the encoder and cross K/V at N = 6000), 16
    greedy decode steps, through the plain versions and the kernels on
    dense caches, then the kernels on paged caches. `model` (bundle,
    params, bytes) replaces the seeded artifact (phase 10's trained one)."""
    from repro_torch.models.attention import PagedSpec

    bundle, params, n_bytes = model or family_model("whisper_tiny", dev, scratch,
                                                    keep=True)
    arch = bundle.arch
    check_refused("whisper_tiny", bundle, params, dev, "could not run the encoder")
    counts = [ROWS9, ROWS9 * WHISPER_PROMPT, ROWS9 * arch.enc_frames]
    versions = tune_family("whisper_tiny", bundle, counts, dev)
    gen = torch.Generator().manual_seed(SEED + 31)
    frames = torch.randn(ROWS9, arch.enc_frames, arch.d_model, generator=gen).to(dev)
    prompt = torch.randint(0, arch.vocab, (ROWS9, WHISPER_PROMPT), generator=gen,
                           dtype=torch.int32).to(dev)
    n_tables = MAX_SEQ9 // 16

    def run(paged: bool, record: list | None = None) -> dict:
        spec = PagedSpec(n_pages=ROWS9 * n_tables + 1, page_size=16) if paged else None
        caches = bundle.init_caches(ROWS9, MAX_SEQ9, dtype=torch.float32, device=dev,
                                    paged=spec)
        batch = {"tokens": prompt, "cache_len": torch.zeros(ROWS9, dtype=torch.long),
                 "frames": frames}
        if paged:
            batch["block_tables"] = torch.arange(1, 1 + ROWS9 * n_tables).view(ROWS9, n_tables)
        out = greedy_forwards(bundle, params, batch, caches,
                              lambda t: {"tokens": t.to(torch.int32)}, record=record)
        return dict(out, params=params)

    with PlainLUT():
        want = run(False)
    per_forward: list = []
    recorded = run(False, per_forward)
    held, taint = held_forwards("whisper_tiny", per_forward)
    lut = bundle.lut_sites()
    n_decode = sum(s.path.startswith("decoder/") and s.kind not in ("cross/k", "cross/v")
                   for s in lut)
    check([len(f) for f in per_forward] == [len(lut)] + [n_decode] * GREEDY_STEPS,
          f"whisper_tiny: site calls per forward {[len(f) for f in per_forward]}, expected "
          f"{len(lut)} then {n_decode}")
    check(per_forward[0][0][1].shape[0] == counts[-1], "whisper_tiny: the encoder's first site "
                                                       "did not run at N=6000")
    del per_forward
    ties = compare_greedy("whisper_tiny dense", recorded, want, taint)
    # the path, timed without the recording: the recorded run's tokens; and
    # paged, whose gather reads the dense layout back, so the same values
    got, launches = kernel_run("whisper_tiny", bundle, counts, dev, lambda: run(False))
    paged, launches_p = kernel_run("whisper_tiny paged", bundle, counts, dev, lambda: run(True))
    check(torch.equal(got["tokens"], recorded["tokens"]) and
          torch.equal(paged["tokens"], recorded["tokens"]),
          "whisper_tiny: the dense or paged kernel run's tokens differ from the recorded run's")
    log(f"[encdec/vlm] whisper_tiny paged: launches "
        + " ".join(f"{k}={v}" for k, v in launches_p.items())
        + "; tokens equal the dense kernel run's")
    res = report_family("whisper_tiny", bundle, held, want, got, launches, ties, dev,
                        counts)
    # phase 16's reference: the plain run, on the same inputs
    plain = {"tokens": want["tokens"], "gaps": want["gaps"], "counts": counts,
             "inputs": {"prompt": prompt.cpu().numpy(), "frames": frames.cpu().numpy()}}
    return dict(res, versions=versions, param_bytes=n_bytes, paged_launches=launches_p,
                plain=plain)


def phase9_vlm(dev, scratch: Path, model: tuple | None = None) -> dict:
    """qwen2_vl_7b at full width and VLM_SERVE_LAYERS layers: 4 rows of 32 patch
    embeddings and 8 text tokens' embedding rows as the prefill, 16 greedy
    decode steps fed back as embedding rows, through the plain versions and
    the kernels; then a no-cache forward with the grid's distinct (t, h, w)
    M-RoPE streams, through both. `model` (bundle, params, bytes) replaces
    the seeded artifact (phase 10's trained one)."""
    from repro_torch.models import transformer as tf_mod
    from repro_torch.testing import grid_positions

    bundle, params, n_bytes = model or family_model("qwen2_vl_7b", dev, scratch,
                                                    n_layers=VLM_SERVE_LAYERS, keep=True)
    arch = bundle.arch
    check_refused("qwen2_vl_7b", bundle, params, dev, "could not give this model the embeddings")
    n_patch = VLM_GRID[0] * VLM_GRID[1]
    counts = [ROWS9, ROWS9 * (n_patch + VLM_TEXT)]
    versions = tune_family("qwen2_vl_7b", bundle, counts, dev)
    table = params["embed"]["table"]
    gen = torch.Generator().manual_seed(SEED + 32)
    patches = torch.randn(ROWS9, n_patch, arch.d_model, generator=gen) * 0.02
    text = torch.randint(0, arch.vocab, (ROWS9, VLM_TEXT), generator=gen)
    embeds = torch.cat([patches.to(dev), table[text.to(dev)]], dim=1)

    def run(record: list | None = None) -> dict:
        caches = bundle.init_caches(ROWS9, MAX_SEQ9, dtype=torch.float32, device=dev)
        batch = {"embeds": embeds, "cache_len": torch.zeros(ROWS9, dtype=torch.long)}
        out = greedy_forwards(bundle, params, batch, caches, lambda t: {"embeds": table[t]},
                              record=record)
        return dict(out, params=params)

    with PlainLUT():
        want = run()
    per_forward: list = []
    recorded = run(per_forward)
    held, taint = held_forwards("qwen2_vl_7b", per_forward)
    check([len(f) for f in per_forward] == [len(bundle.lut_sites())] * (1 + GREEDY_STEPS),
          f"qwen2_vl_7b: site calls per forward {[len(f) for f in per_forward]}, expected "
          f"{len(bundle.lut_sites())}")
    del per_forward
    ties = compare_greedy("qwen2_vl_7b", recorded, want, taint)
    # the path, timed without the recording: the recorded run's tokens
    got, launches = kernel_run("qwen2_vl_7b", bundle, counts, dev, run)
    check(torch.equal(got["tokens"], recorded["tokens"]),
          "qwen2_vl_7b: the kernel run's tokens differ from the recorded run's")
    del recorded
    res = report_family("qwen2_vl_7b", bundle, held, want, got, launches, ties, dev, counts)
    # phase 16's reference: the plain run, on the same inputs
    plain = {"tokens": want["tokens"], "gaps": want["gaps"], "counts": counts,
             "inputs": {"embeds": embeds.cpu().numpy()}}
    del got, want

    # M-RoPE at work: the grid's (t, h, w) streams against the serving
    # positions (one stream, where M-RoPE is RoPE)
    pos3 = torch.from_numpy(grid_positions(ROWS9, VLM_TEXT, *VLM_GRID)).to(dev)
    flat = torch.arange(n_patch + VLM_TEXT, device=dev)[None].expand(ROWS9, -1)
    with torch.inference_mode():
        with SiteCalls() as rec:
            grid, _, _ = tf_mod.lm_apply(bundle.cfg, params, embeds=embeds, pos=pos3)
        with PlainLUT():
            grid_plain, _, _ = tf_mod.lm_apply(bundle.cfg, params, embeds=embeds, pos=pos3)
        serving, _, _ = tf_mod.lm_apply(bundle.cfg, params, embeds=embeds,
                                        pos=flat[None].expand(3, -1, -1))
    held_grid = hold_sites("qwen2_vl_7b grid", rec.calls)
    err = (grid - grid_plain).abs().max().item()
    moved = (grid - serving).abs().max().item()
    check(bool(torch.isfinite(grid).all()), "qwen2_vl_7b grid: non-finite logits")
    check(held_grid["codes_off"] > 0 or err <= LOGIT_ATOL,
          f"qwen2_vl_7b grid: kernel and plain logits differ by {err:.3g} with every code equal")
    check(moved > LOGIT_ATOL, f"qwen2_vl_7b grid: the (t, h, w) streams moved the logits by only "
                              f"{moved:.3g}")
    log(f"[encdec/vlm] qwen2_vl_7b: no-cache forward over a {VLM_GRID[0]} x {VLM_GRID[1]} patch "
        f"grid + {VLM_TEXT} text positions in distinct (t, h, w) streams: kernels vs plain "
        f"versions max logit err {err:.3g} ({held_grid['sites']} site calls held, "
        f"{held_grid['codes_off']} codes off at ties); the streams move the logits by "
        f"{moved:.3g} against the serving positions")
    return dict(res, versions=versions, param_bytes=n_bytes, grid_err=err, plain=plain)


def phase_encdec_vlm(dev, scratch: Path) -> dict:
    """Phase 9: whisper_tiny (full depth) and qwen2_vl_7b (VLM_SERVE_LAYERS)
    at full width through artifacts, driven by `ModelBundle.forward_step`
    (the engine refuses both families: it feeds token ids only)."""
    import gc

    out = {}
    for name, fn in (("whisper_tiny", phase9_whisper), ("qwen2_vl_7b", phase9_vlm)):
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)        # what the earlier phases left
        res = fn(dev, scratch)
        res["peak_gib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        log(f"[encdec/vlm] {name}: peak device memory {res['peak_gib']:.2f} GiB above the "
            f"{base / 2**30:.2f} GiB the earlier phases left allocated")
        out[name] = res
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 16 (a): tensor-parallel serving (tp 2) of the enc-dec and the vision-LM
# ---------------------------------------------------------------------------

TPE_RECORDED = 2         # forwards whose LUT-site calls are held: the first prefill and decode


def tpe_rank(rank: int, jobs_q, devices: list[str], init: str, q) -> None:
    """One rank of phase 16 (a), in its own process, started before phase 9:
    join the model mesh, wait for the jobs phase 9's artifacts make (None:
    phase 9 failed, the end), then serve each job's model from its artifact
    (`tpe_rank_work`)."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets the fp32 matmul policy)
    from repro_torch.launch.mesh import make_host_mesh

    try:
        t0 = time.perf_counter()
        mesh = make_host_mesh(data=1, model=len(devices), rank=rank, devices=devices,
                              init_method=init, timeout_s=600)
        out: dict = {"rank": rank, "mesh_s": time.perf_counter() - t0}
        jobs = jobs_q.get(timeout=900)
        for job in jobs or ():
            out[job["name"]] = tpe_rank_work(mesh, job)
            torch.cuda.empty_cache()
        out["backend"] = mesh.backend
        mesh.close()
        # numpy arrays: a queue would hand a CPU tensor over as shared
        # memory that dies with the exiting rank
        q.put(("ok", map_tensors(out, lambda t: t.detach().cpu().numpy())))
    except BaseException:                     # noqa: BLE001 — the parent reports it
        import traceback

        q.put(("error", {"rank": rank, "trace": traceback.format_exc()}))


def map_tensors(obj, fn):
    """`obj` with `fn` applied to every tensor, through dicts, lists and
    tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    return obj


def tpe_rank_work(mesh, job: dict) -> dict:
    """A rank's serving of one model: its shards read from phase 9's
    artifact (`load_artifact(mesh=)`), the measured warm-up of its site
    shapes (rank 0 tunes, every rank takes its records), then phase 9's
    prefill (frames, or embeddings) and GREEDY_STEPS greedy steps through
    `make_serve_step(local, mesh=)`, on dense then paged caches, with the
    counts set to 0 just before each run and read just after, each LUT-site
    call's (N, signature) tallied for the kernel its record chooses; the
    dense run's first prefill and decode recorded (their LUT-site calls held
    against the plain versions, their row sites against the unsharded
    site)."""
    from repro_torch.core.amm import Mode
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.kernels import autotune, counters, ops
    from repro_torch.models import sharded
    from repro_torch.models.attention import PagedSpec
    from repro_torch.serving.artifact import load_artifact
    from repro_torch.serving.engine import tp_warm_lut_autotune
    from repro_torch.train.train_step import make_serve_step

    dev, name = mesh.device, job["name"]
    t0 = time.perf_counter()
    art = load_artifact(job["art"], mesh=mesh, restore_autotune=False)
    local, lp, lay = tensor_parallel.place(art.bundle, art.params, ShardingRules.for_mesh(mesh),
                                           mesh)
    torch.cuda.synchronize(dev)
    out: dict = {"load_s": time.perf_counter() - t0, "kept": lay.kept,
                 "param_bytes": sum(t.numel() * t.element_size() for t in _tensors(lp))}
    t0 = time.perf_counter()
    counts = job["counts"]
    out["tuned"] = tp_warm_lut_autotune(local, lay, mesh, counts, "float32", dev)
    out["tune_s"] = time.perf_counter() - t0
    backend = autotune.backend_for(dev)
    out["sigs"] = {str(sig[:4]): [autotune.kernel_choice(n, *sig[:4], dtype=sig[4],
                                                         backend=backend)[0] for n in counts]
                   for sig in tensor_parallel.kernel_signatures(local, lay, "float32")}
    inputs = {k: torch.from_numpy(v).to(dev) for k, v in job["inputs"].items()}
    serve_step = make_serve_step(local, compute_dtype=torch.float32, mesh=mesh)
    if local.arch.takes_embeds:
        first = {"embeds": inputs["embeds"]}

        def feed(t):               # the tokens' rows of the rank's vocab shard, reduced
            with sharded.bound(mesh):
                return {"embeds": sharded.embed(lp["embed"], t)}
    else:
        first = {"tokens": inputs["prompt"], "frames": inputs["frames"]}

        def feed(t):
            return {"tokens": t.to(torch.int32)}
    n_tables = MAX_SEQ9 // 16

    def run(paged: bool, step) -> dict:
        spec = PagedSpec(n_pages=ROWS9 * n_tables + 1, page_size=16) if paged else None
        caches = local.init_caches(ROWS9, MAX_SEQ9, dtype=torch.float32, device=dev, paged=spec)
        batch = {**first, "cache_len": torch.zeros(ROWS9, dtype=torch.long)}
        if paged:
            batch["block_tables"] = torch.arange(1, 1 + ROWS9 * n_tables).view(ROWS9, n_tables)
        return greedy_forwards(local, lp, batch, caches, feed, step=step)

    def counted(paged: bool, step) -> dict:
        tally, plain_fn = [], ops.lut_amm

        def tallied(x, c, q_, s, **kw):
            tally.append((x.shape[0], q_.shape[-1], *c.shape, autotune.dtype_name(x.dtype)))
            return plain_fn(x, c, q_, s, **kw)

        mesh.reset_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        counters.reset()
        ops.lut_amm = tallied
        try:
            res = run(paged, step)
        finally:
            ops.lut_amm = plain_fn
        launches, plain = counters.launches(), counters.plain_calls()
        want = dict.fromkeys(KERNEL_OF_VERSION.values(), 0)
        for n, m, c, k, v, dt in tally:
            want[KERNEL_OF_VERSION[autotune.kernel_choice(n, m, c, k, v, dtype=dt,
                                                          backend=backend)[0]]] += 1
        return {"tokens": res["tokens"], "prefill_s": res["prefill_s"],
                "decode_s": res["decode_s"], "launches": launches, "plain": plain,
                "expected": want, "calls": len(tally), "coll": dict(mesh.counters),
                "peak": torch.cuda.max_memory_allocated(dev)}

    # the dense run's first prefill's and decode's LUT-site calls, and their
    # row sites' inputs and reduced outputs
    calls, rows, n_fwd, real = [], [], [0], sharded.linear

    def linear(site, p, x):
        y = real(site, p, x)
        if site.tp == "row" and site.mode == Mode.LUT_INFER:
            rows.append((p["table_q"].data_ptr(), p, x.reshape(-1, x.shape[-1]).clone(),
                         y.reshape(-1, y.shape[-1]).clone()))
        return y

    def recorded(b, c):
        n_fwd[0] += 1
        if n_fwd[0] > TPE_RECORDED:
            return serve_step(lp, b, c)
        sharded.linear = linear
        try:
            with SiteCalls() as rec:
                res = serve_step(lp, b, c)
        finally:
            sharded.linear = real
        calls.append(rec.calls)
        return res

    out["dense"] = counted(False, recorded)
    out["paged"] = counted(True, lambda b, c: serve_step(lp, b, c))
    held, taint = held_forwards(f"tp {name} rank {mesh.rank}", calls)
    held.pop("off_rows")
    lut = local.lut_sites()
    decode_sites = [s for s in lut if not s.path.startswith("encoder/")
                    and s.kind not in ("cross/k", "cross/v")]
    check([len(f) for f in calls] == [len(lut), len(decode_sites)],
          f"tp {name} rank {mesh.rank}: LUT-site calls in the recorded forwards "
          f"{[len(f) for f in calls]}, expected {len(lut)} then {len(decode_sites)}")
    n_rows = sum(lay.roles.get(s.path) == "row" for s in lut) + sum(
        lay.roles.get(s.path) == "row" for s in decode_sites)
    rows_held = hold_rows(f"tp {name} rank {mesh.rank}", mesh, rows, {})
    check(rows_held["calls"] == n_rows > 0, f"tp {name} rank {mesh.rank}: {rows_held['calls']} "
                                            f"row-site outputs recorded, expected {n_rows}")
    del calls, rows
    out.update(held=held, taint=taint, rows_held=rows_held)
    out["allocated"] = torch.cuda.memory_allocated(dev)
    return out


def phase_tp_encdec_vlm(dev, scratch: Path, p9: dict, started: dict) -> dict:
    """Phase 16 (a): tensor-parallel serving at tp 2 of phase 9's whisper_tiny
    (4 + 4 layers, 1500 frames) and qwen2_vl_7b (VLM_SERVE_LAYERS layers)
    from their artifacts, both ranks on the one card over gloo unless the
    host has two cards: phase 9's prefill and greedy steps through
    `make_serve_step(local, mesh=)` on dense and paged caches. Holds the
    tokens against phase 9's plain run (near-ties and codes picked at ties
    as phase 9 treats them), per rank the launch counts (the kernels the
    records choose at the rank's shapes, one per LUT-site call, no plain
    call), the first prefill's and decode's LUT-site calls against the
    plain versions and their row sites bytewise against the unsharded site;
    prints the decode forward's wall time, the all-reduces per forward and
    their host time, and device memory. `started`: the ranks `start_ranks`
    spawned before phase 9."""
    from repro_torch.launch.mesh import backend_for

    jobs = [{"name": name, "art": KEPT_ARTIFACTS[name], "counts": p9[name]["plain"]["counts"],
             "inputs": p9[name]["plain"]["inputs"]} for name in ("whisper_tiny", "qwen2_vl_7b")]
    procs, q, devices, n_cards = (started[k] for k in ("procs", "q", "devices", "cards"))
    backend = backend_for(devices)
    for jq in started["jobs"]:
        jq.put(jobs)
    t0 = time.perf_counter()
    got = wait_ranks(q, TP, 500)
    t_results = time.perf_counter() - t0
    stop_ranks(procs, got[-1][0] == "ok")
    for path in KEPT_ARTIFACTS.values():
        shutil.rmtree(path, ignore_errors=True)
    KEPT_ARTIFACTS.clear()
    errors = [val["trace"] for status, val in got if status != "ok"]
    check(not errors, "a phase-16 tp rank failed:\n" + "\n".join(errors))
    ranks = sorted((val for _, val in got), key=lambda v: v["rank"])
    log(f"[tpe] tp={TP} on {n_cards} card(s): ranks on {devices}, backend {backend}"
        + ("" if backend == "nccl" else " (both ranks share the card: NCCL is not measured)")
        + f"; started {t0 - started['t0']:.1f}s before (spawn, import, mesh "
          f"{ranks[0]['mesh_s']:.1f}s, beside phase 9); both ranks' results in "
          f"{t_results:.1f}s (load, warm-up, 2 runs of each model)")
    out: dict = {"launches": {}}
    for job in jobs:
        name = job["name"]
        want = p9[name]["plain"]
        for rank in ranks:
            res = rank[name]
            tag = f"tp {name} rank {rank['rank']}"
            held, rows = res["held"], res["rows_held"]
            dense = torch.from_numpy(res["dense"]["tokens"])
            ties = compare_greedy(tag, {"tokens": dense}, want, res["taint"])
            check(torch.equal(torch.from_numpy(res["paged"]["tokens"]), dense),
                  f"{tag}: the paged run's tokens differ from the dense run's")
            for case in ("dense", "paged"):
                r = res[case]
                check(r["plain"] == 0, f"{tag} {case}: a plain version ran ({r['plain']} calls)")
                check(r["launches"] == {k: r["expected"].get(k, 0) for k in r["launches"]}
                      and sum(r["launches"].values()) == r["calls"] > 0,
                      f"{tag} {case}: launches {r['launches']}, the records say "
                      f"{r['expected']} over {r['calls']} LUT-site calls")
                for k, v in r["launches"].items():
                    out["launches"][k] = out["launches"].get(k, 0) + v
            d, c = res["dense"], res["dense"]["coll"]
            n_fwd = 1 + GREEDY_STEPS
            dec_ms = 1e3 * sum(d["decode_s"]) / len(d["decode_s"])
            log(f"[tpe] {tag}: shards read in {res['load_s']:.1f}s "
                f"({res['param_bytes'] / 1e9:.2f} GB), warm-up {res['tune_s']:.1f}s "
                f"({res['tuned']} shapes tuned on rank 0; kept: {', '.join(res['kept'])}); "
                f"version per rank site (M, C, K, V) at N={job['counts']}: {res['sigs']}")
            log(f"[tpe] {tag}: {held['sites']} LUT-site calls of the first prefill and decode "
                f"({held['kernels']}) equal to the plain lookup of the encode kernel's codes "
                f"(max abs err {held['err']:.3g}; {held['codes_off']} of {held['codes']} codes "
                f"off the plain encode's, each a tie); {rows['calls']} row-site outputs "
                f"({rows['rows']} rows) bytewise the unsharded site's ({rows['codes_off']} codes "
                f"off, each a tie); tokens equal phase 9's plain run but {ties} near-tie "
                f"difference(s)")
            log(f"[tpe] {tag}: prefill forward {1e3 * d['prefill_s']:.1f} ms, decode forward "
                f"{dec_ms:.2f} ms mean over {len(d['decode_s'])}; all_reduce "
                f"{c['all_reduce'] / n_fwd:.1f} per forward, "
                f"{1e6 * c['all_reduce_s'] / max(c['all_reduce'], 1):.1f} us host each "
                f"({c['all_reduce_bytes'] / n_fwd / 1e6:.2f} MB per forward); peak "
                f"{d['peak'] / 2**30:.2f} GiB allocated; launches dense "
                + " ".join(f"{k}={v}" for k, v in d["launches"].items()) + ", paged "
                + " ".join(f"{k}={v}" for k, v in res["paged"]["launches"].items()))
            out[f"{name}/{rank['rank']}"] = {"decode_ms": dec_ms, "ties": ties,
                                             "all_reduce_per_fwd": c["all_reduce"] / n_fwd}
    return out


# ---------------------------------------------------------------------------
# phase 10: training the MoE, SSM, hybrid, enc-dec and vision-LM families
# ---------------------------------------------------------------------------

# depth of each family's soft-PQ step parity (full width always): 2 layers,
# the hybrid the 6 mamba layers that invoke its shared block once, whisper
# all of its 4 + 4. qwen2_vl_7b's step is held at reduced size on the card
# (`tests/test_torch_cuda.py`), not here: at full width its host side (the
# CPU step and two AdamW updates over ~1.3e9 trainable entries) took ~90 s
# of chip_smoke's time limit
PARITY_LAYERS = {"mamba2_370m": 2, "zamba2_1p2b": 6, "whisper_tiny": 4}
# rows x tokens of each parity batch
PARITY_BATCH = {"mamba2_370m": (4, 32), "zamba2_1p2b": (4, 32), "whisper_tiny": (4, 32)}
TRAIN_VLM_LAYERS = 2     # qwen2_vl_7b's depth in (c): 28 layers in fp32 with AdamW are ~122 GB
                         # (4 until phase 16, which trains it at 2 layers too)
# depth of (b)'s recipe runs (full width; cut from 48 and 38 so that chip_smoke
# keeps inside its time limit with phase 11): zamba2_1p2b's shared block runs once
RECIPE_LAYERS = {"mamba2_370m": 6, "zamba2_1p2b": 6}
FAMILY_STEPS = 2         # (c)'s dense and soft-PQ steps
FAMILY_ROWS, FAMILY_SEQ = 4, 64
FAMILY_LAUNCHER_STEPS = 10   # (d)'s --steps: no kill, so no commit needed (20 until phase 12)


def family_step_parity(name: str, dev) -> dict:
    """(a) One soft-PQ step of `name` at full width and PARITY_LAYERS[name]
    layers, card against CPU against float64 (`lut_train_step_parity`), on
    the family's batch (`testing.family_batch`: tokens, stub frames, or
    patch embeddings with grid positions)."""
    from repro_torch import testing
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.optim import SOFT_PQ_RULES, AdamW
    from repro_torch.optim.schedule import cosine_with_warmup
    from repro_torch.weights import tree_map_ref

    t0 = time.perf_counter()
    base = get_arch(name)
    arch = dataclasses.replace(base, n_layers=PARITY_LAYERS[name])
    bundle = build_model(arch, Mode.LUT_TRAIN)
    params = bundle.init(torch.Generator().manual_seed(SEED + 40), device="cpu")
    # at the activations' scale, as k-means puts them
    tree_map_ref(lambda p, t: t.mul_(50.0) if p.endswith("centroids") else None, params)
    batch = {k: torch.from_numpy(v) for k, v in
             testing.family_batch(arch, *PARITY_BATCH[name], seed=SEED + 41).items()}
    opt = AdamW(lr=cosine_with_warmup(PARITY_LR, total_steps=4, warmup_steps=2),
                rules=SOFT_PQ_RULES)
    res = testing.lut_train_step_parity(bundle, params, batch, dev, opt, tie_eps=TIE_EPS,
                                        witness=dev)
    errs = res["grad_errs"]
    worst = max(errs.items(), key=lambda kv: kv[1]["card_cpu"][1])
    ratio = max((max(e["card_f64"][0] / max(e["cpu_f64"][0], testing.FLOOR_L2),
                     e["card_f64"][1] / max(e["cpu_f64"][1], testing.FLOOR_MAX)), k)
                for k, e in errs.items())
    cut = "" if arch.n_layers == base.n_layers else f" (of {base.n_layers})"
    log(f"[train10] {name} soft-PQ step, full width, {arch.n_layers} layers{cut}, "
        f"{res['tokens']} tokens"
        + (f" + {arch.enc_frames} stub frames a row" if arch.enc_frames else "")
        + f", card vs CPU vs float64 ({time.perf_counter() - t0:.1f}s, beside (d)): loss "
          f"{res['loss_dev']:.7f} card, {res['loss_cpu']:.7f} CPU, {res['loss_f64']:.7f} float64;"
          f" codes picked otherwise at a near-tie of {res['codes']}: card "
          f"{res['pinned_codes']['card']}, float64 {res['pinned_codes']['float64']}; half-integer "
          f"fake-quant entries of {res['rounded_entries']}: card {res['rounding_flips']['card']}, "
          f"float64 {res['rounding_flips']['float64']}; {res['grad_leaves']} gradient leaves, "
          f"largest card-vs-CPU gap {worst[0]} {worst[1]['card_cpu'][0]:.3g}/"
          f"{worst[1]['card_cpu'][1]:.3g} (bounds {testing.GRAD_L2}/{testing.GRAD_MAX}); card's "
          f"gap from float64 over the CPU's at most {ratio[0]:.3g} ({ratio[1]}; bound "
          f"{testing.WITNESS}); log_t card vs CPU {res['log_t_errs']['card_cpu']:.3g} of its "
          f"terms; {res['updated']} elements moved")
    check(not res["failures"], f"{name} soft-PQ step, card vs CPU: " + "; ".join(res["failures"]))
    return {k: res[k] for k in ("loss_dev", "loss_cpu", "loss_f64", "pinned_codes", "codes",
                                "rounding_flips", "rounded_entries", "grad_leaves", "updated")}


def arctic_step(dev) -> dict:
    """(a') One soft-PQ step of arctic_480b at full width, ARCTIC_LAYERS
    layers, bf16 params, on the card alone: every layer LUT (a dense expert
    layer's trainable weights with their fp32 AdamW moments would be ~134 GB
    more), the routed experts' tables built per chunk and recomputed in
    backward. The loss finite, the aux value > 0, the expert sites' shared
    codebooks a nonzero finite gradient, the update finite; peak memory.
    Should the step not fit in 80 GB, the peak is printed and the step runs
    at `reduce_arch(arctic_480b)` instead."""
    import gc

    from repro_torch.configs import build_model, get_arch, reduce_arch
    from repro_torch.core.amm import Mode
    from repro_torch.data import MarkovLM
    from repro_torch.optim import SOFT_PQ_RULES, AdamW, lut_frozen_mask
    from repro_torch.train.train_step import grads_tree, trainable_view
    from repro_torch.weights import tree_map_ref

    def step(arch, seq: int) -> dict:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        bundle = build_model(arch, Mode.LUT_TRAIN)
        params = bundle.init(torch.Generator(device=dev).manual_seed(SEED + 42), device=dev)
        n_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
        t_init = time.perf_counter() - t0
        batch = {k: v.to(dev) for k, v in MarkovLM(vocab=arch.vocab, seq_len=seq,
                                                   batch=1).batch_at(0).items()}
        frozen = lut_frozen_mask(params)
        opt = AdamW(lr=1e-3, rules=SOFT_PQ_RULES)
        state = opt.init(params, frozen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live, leaves = trainable_view(params, frozen)
        logits, aux = bundle.train_logits(live, batch, compute_dtype=torch.bfloat16)
        loss = bundle.loss_from_logits(logits, aux, batch["labels"])
        del logits
        grads = grads_tree(loss, leaves, params, frozen)
        del live, leaves
        new, _, gnorm = opt.update(grads, state, params, frozen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        cgrads = [grads["segments"][i][j]["moe"][k]["centroids"]
                  for i, (count, _) in enumerate(bundle.cfg.segments) for j in range(count)
                  for k in ("gate", "up", "down")]
        gmax = max(float(g.abs().max()) for g in cgrads)
        finite = all(bool(torch.isfinite(g).all()) for g in cgrads)
        # the updated leaves (the frozen expert weights are the same tensors)
        bad: list[str] = []
        tree_map_ref(lambda p, t, fz: None if fz or bool(torch.isfinite(t).all())
                     else bad.append(p), new, frozen)
        moved = not bad
        out = {"loss": float(loss), "aux": float(aux), "grad_norm": float(gnorm),
               "centroid_grad_max": gmax, "step_s": secs, "init_s": t_init,
               "peak_gib": peak / 2**30, "param_bytes": n_bytes, "layers": arch.n_layers,
               "d_model": arch.d_model, "experts": arch.n_experts}
        log(f"[train10] arctic_480b soft-PQ step on the card, {arch.n_layers} layers, d_model "
            f"{arch.d_model}, {arch.n_experts} experts top-{arch.top_k}, {arch.param_dtype} "
            f"params ({n_bytes / 1e9:.2f} GB, built in {t_init:.1f}s), 1 x {seq} tokens: loss "
            f"{out['loss']:.5f}, aux {out['aux']:.5f}, grad norm {out['grad_norm']:.4g}, the "
            f"expert sites' shared centroids' largest gradient {gmax:.3g}; step {secs:.2f}s; "
            f"peak device memory {out['peak_gib']:.2f} GiB above the {base / 2**30:.2f} GiB "
            f"left allocated")
        check(math.isfinite(out["loss"]) and out["aux"] > 0,
              f"arctic_480b step: loss {out['loss']}, aux {out['aux']}")
        check(finite and gmax > 0, f"arctic_480b step: expert centroid gradients finite "
                                   f"{finite}, largest {gmax}")
        check(moved, f"arctic_480b step: the update left non-finite params at {bad}")
        del bundle, params, grads, new, state, cgrads
        gc.collect()
        torch.cuda.empty_cache()
        return out

    arch = dataclasses.replace(get_arch("arctic_480b"), n_layers=ARCTIC_LAYERS, lut_policy="all")
    try:
        return step(arch, 256)
    except torch.cuda.OutOfMemoryError as e:
        reason = str(e).splitlines()[0]
    # out of the handler, so that the failed step's tensors are freed
    peak = torch.cuda.max_memory_allocated(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train10] arctic_480b at full width does not fit: {reason}; peak "
        f"{peak / 2**30:.2f} GiB; the step runs at reduce_arch(arctic_480b)")
    return dict(step(reduce_arch(arch, lut_policy="all"), 64), full_width_oom_gib=peak / 2**30)


def family_recipe(name: str, dev, scratch: Path) -> dict:
    """(b) `Recipe.run` (`run_recipe`) at full width and RECIPE_LAYERS[name]
    layers, then the trained artifact loaded and served as phase 8 serves
    (`serve_family`: measured warm-up, the burst against the plain
    versions)."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.data import MarkovLM
    from repro_torch.serving.artifact import load_artifact

    os.environ["REPRO_AUTOTUNE_CACHE"] = str(scratch / f"autotune_{name}.json")
    arch = dataclasses.replace(get_arch(name), lut_use_kernel=True,
                               n_layers=RECIPE_LAYERS[name])
    data = MarkovLM(vocab=arch.vocab, seq_len=256, batch=4)
    adir = scratch / f"trained_{name}"
    out = run_recipe(f"recipe10 {name}", arch, data, dev, scratch, adir)
    t0 = time.perf_counter()
    art = load_artifact(adir, device=dev)
    log(f"[recipe10] {name}: trained artifact ({du(adir) / 1e9:.2f} GB) loaded in "
        f"{time.perf_counter() - t0:.1f}s")
    out["served"] = serve_family(f"{name} trained", art.bundle, art.params, dev, recurrent=True,
                                 hold_all=True)
    del art
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(adir)
    return out


def train_family_by_functions(name: str, dev, scratch: Path) -> dict:
    """(c) The enc-dec or vision-LM family trained through the functions
    the launcher refuses to drive without their inputs: FAMILY_STEPS dense
    steps on family batches (stub frames, or patch embeddings with grid
    positions), `convert.convert_dense_to_lut_train` (tape + k-means on
    sample batches of them; M-RoPE's streams built as the reference builds
    them), FAMILY_STEPS soft-PQ steps, `deploy_to_artifact` and load; then
    phase 9's forwards on the trained artifact, kernels against plain."""
    import gc

    from repro_torch import testing
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core import convert
    from repro_torch.core.amm import Mode
    from repro_torch.optim import SOFT_PQ_RULES, AdamW, lut_frozen_mask
    from repro_torch.optim.schedule import constant
    from repro_torch.serving.artifact import load_artifact
    from repro_torch.train.train_step import make_train_step

    os.environ["REPRO_AUTOTUNE_CACHE"] = str(scratch / f"autotune_{name}.json")
    base = get_arch(name)
    arch = dataclasses.replace(base, lut_use_kernel=True)
    if name == "qwen2_vl_7b":
        arch = dataclasses.replace(arch, n_layers=TRAIN_VLM_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)

    def batch_at(i: int, **kw) -> dict:
        b = testing.family_batch(arch, FAMILY_ROWS, FAMILY_SEQ, seed=SEED + 50 + i,
                                 grid=VLM_GRID, **kw)
        return {k: torch.from_numpy(v) for k, v in b.items()}

    t0 = time.perf_counter()
    dense = build_model(arch, Mode.DENSE)
    params = dense.init(torch.Generator(device=dev).manual_seed(SEED + 51), device=dev)
    opt = AdamW(lr=constant(3e-3))
    step = make_train_step(dense, opt, compute_dtype=torch.float32)
    state = opt.init(params)
    dense_loss = []
    for i in range(FAMILY_STEPS):
        params, state, m = step(params, state, batch_at(i))
        dense_loss.append(float(m["loss"]))
    del state, step
    t_dense = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples = [batch_at(100 + i) for i in range(2)]
    if arch.mrope_sections:
        samples = [{k: v for k, v in b.items() if k != "pos"} for b in samples]
    lut, lparams = convert.convert_dense_to_lut_train(dense, params,
                                                      samples, torch.Generator(device=dev)
                                                      .manual_seed(SEED + 52))
    t_init = time.perf_counter() - t0
    before = {s.path: convert.site_params(lparams, s)["centroids"].clone()
              for s in lut.lut_sites() if s.stack_index in (None, 0)}
    del params
    t0 = time.perf_counter()
    frozen = lut_frozen_mask(lparams)
    opt = AdamW(lr=constant(1e-3), rules=SOFT_PQ_RULES)
    step = make_train_step(lut, opt, frozen_mask=frozen, compute_dtype=torch.float32)
    state = opt.init(lparams, frozen)
    pq_loss, t_stats = [], {}
    for i in range(FAMILY_STEPS):
        lparams, state, m = step(lparams, state, batch_at(10 + i))
        pq_loss.append(float(m["loss"]))
        t_stats = {"t_mean": float(m["t_mean"]), "t_min": float(m["t_min"])}
    del state, step
    t_pq = time.perf_counter() - t0
    # a site whose soft assignment is saturated (distances far above t) takes
    # no gradient in fp32: count the sites whose centroids moved
    moved = sum(not torch.equal(before[s.path], convert.site_params(lparams, s)["centroids"])
                for s in lut.lut_sites() if s.stack_index in (None, 0))
    check(moved > 0, f"{name}: soft-PQ moved no site's centroids")
    t0 = time.perf_counter()
    adir = scratch / f"trained_{name}"
    convert.deploy_to_artifact(lut, lparams, adir)
    del lparams, lut
    gc.collect()
    torch.cuda.empty_cache()
    art = load_artifact(adir, device=dev)
    n_bytes = du(adir)
    t_art = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - mem0) / 2**30
    check(all(math.isfinite(x) for x in dense_loss + pq_loss), f"{name}: non-finite loss")
    cut = "" if arch.n_layers == base.n_layers else f" of {base.n_layers}"
    log(f"[train10] {name}: {arch.n_layers} layers{cut}, full width, {FAMILY_ROWS} x "
        f"{FAMILY_SEQ} rows a batch"
        + (f" + {arch.enc_frames} stub frames each" if arch.enc_frames else
           f", embeddings on a {VLM_GRID[0]} x {VLM_GRID[1]} patch grid") + f": dense "
        f"{FAMILY_STEPS} steps {t_dense:.1f}s (loss {dense_loss}), tape + k-means on 2 sample "
        f"batches {t_init:.1f}s, soft-PQ {FAMILY_STEPS} steps {t_pq:.1f}s (loss {pq_loss}, "
        f"{t_stats}), centroids moved at {moved} of {len(before)} sites (layer 0 of each "
        f"stack); deploy + artifact ({n_bytes / 1e9:.2f}"
        f" GB) + load {t_art:.1f}s; peak device memory {peak:.2f} GiB")
    fn = phase9_whisper if name == "whisper_tiny" else phase9_vlm
    served = fn(dev, scratch, model=(art.bundle, art.params, n_bytes))
    del art
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(adir)
    return {"dense_loss": dense_loss, "soft_pq_loss": pq_loss, "dense_s": t_dense,
            "init_s": t_init, "soft_pq_s": t_pq, "artifact_s": t_art, "peak_gib": peak,
            "layers": arch.n_layers, "served": served}


def family_launcher(scratch: Path) -> dict:
    """(d) `launch.train --arch mamba2_370m --lut --steps FAMILY_LAUNCHER_STEPS`
    at its default size on the card, its artifact served by `launch.serve`
    (beside (a), with autotune records of their own);
    `--arch whisper_tiny` exits non-zero with its refusal."""
    py = [sys.executable, "-m"]
    ck, art = scratch / "launch10_ck", scratch / "launch10_art"
    t0 = time.perf_counter()
    cache = scratch / "autotune10.json"
    text = run_logged(py + ["repro_torch.launch.train", "--arch", "mamba2_370m", "--lut",
                            "--steps", str(FAMILY_LAUNCHER_STEPS), "--ckpt-dir", str(ck),
                            "--artifact-dir", str(art)],
                      scratch / "train10.log", 600, autotune_cache=cache)
    check("wrote LUTArtifact" in text and "[eval] deployed INT8 LUT eval loss" in text,
          f"launch.train --arch mamba2_370m: {text[-2000:]}")
    t_train = time.perf_counter() - t0
    for line in text.splitlines():
        if line.startswith(("[eval]", "replacement plan", "recipe:")):
            log(f"  {line}")
    t0 = time.perf_counter()
    served = run_logged(py + ["repro_torch.launch.serve", "--artifact", str(art)],
                        scratch / "serve10.log", 600, autotune_cache=cache)
    check(f"artifact {art}" in served, f"serve did not name its artifact: {served[-2000:]}")
    log(f"[launcher10] launch.train --arch mamba2_370m --lut --steps {FAMILY_LAUNCHER_STEPS} (default "
        f"size) {t_train:.1f}s; "
        f"served in {time.perf_counter() - t0:.1f}s: "
        + " | ".join(l.strip() for l in served.splitlines()[:3]))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(py + ["repro_torch.launch.train", "--arch", "whisper_tiny", "--lut",
                                "--ckpt-dir", str(scratch / "launch10_w")],
                          capture_output=True, text=True, env=env, timeout=300)
    check(proc.returncode != 0 and "audio frames" in proc.stderr
          and not (scratch / "launch10_w").exists(),
          f"launch.train --arch whisper_tiny exited {proc.returncode}: {proc.stderr[-1500:]}")
    log(f"[launcher10] launch.train --arch whisper_tiny exits {proc.returncode}: "
        f"{proc.stderr.strip().splitlines()[-1]}")
    for d in (ck, art):
        shutil.rmtree(d, ignore_errors=True)
    return {"train_s": t_train, "refusal_rc": proc.returncode}


def phase_train_families(dev, scratch: Path) -> dict:
    """Phase 10: the families trained on the card, each trained artifact
    served through the LUT kernels; the kernels' launches summed over (b)
    and (c)'s kernel runs."""
    import gc

    from repro_torch.kernels import counters

    out: dict = {"step": {}}
    # (a') first: its full-width try fills the card
    out["arctic"] = arctic_step(dev)
    # (d) runs beside (a): processes of their own, small on the card, while
    # (a)'s time is mostly the CPU's side of the parity; (b) and (c) are
    # timed and tuned with nothing else on the card
    pool = ThreadPoolExecutor(max_workers=1)
    launcher = pool.submit(family_launcher, scratch)
    for name in PARITY_LAYERS:
        out["step"][name] = family_step_parity(name, dev)
        # reference cycles left by the harness's hooks can hold card tensors
        gc.collect()
        torch.cuda.empty_cache()
    out["launcher"] = launcher.result(timeout=900)
    pool.shutdown()
    launches = dict.fromkeys(counters.launches(), 0)
    for name in ("mamba2_370m", "zamba2_1p2b"):
        res = family_recipe(name, dev, scratch)
        for k in launches:
            launches[k] += res["eval_launches"][k] + res["served"]["launches"].get(k, 0)
        out[name] = res
    for name in ("whisper_tiny", "qwen2_vl_7b"):
        res = train_family_by_functions(name, dev, scratch)
        for k in launches:
            launches[k] += res["served"]["launches"].get(k, 0)
            launches[k] += res["served"].get("paged_launches", {}).get(k, 0)
        out[name] = res
    out["launches"] = launches
    log("[train10] kernel launches of phase 10's kernel runs (Eval, the served bursts and "
        "forwards): " + " ".join(f"{k}={v}" for k, v in launches.items()))
    return out


# ---------------------------------------------------------------------------
# phase 13: data-parallel training at dp 2 (ZeRO-1, the int8 compressed
# reduce, elastic rescale, the launcher's --grad-compression)
# ---------------------------------------------------------------------------

DP = 2
DP_LAYERS = 2            # qwen3_1p7b at full width: ~0.41 G params, 0.31 G of them the embedding
DP_STEPS = 2             # K: the steps of (a), and the steps after the rescale in (c) (4
                         # asked, cut to keep the whole run in its time limit)
DP_LR = 1e-3             # constant, so that the leaf rule's bound is 2 lr a step
DP_BATCH, DP_SEQ = 4, 256
DP_LOSS_RTOL = 1e-5      # the mean of the ranks' half-batch losses against the batch's
GC_GRAD_ERR = 0.05       # the reference test's max-abs error over max-abs of the int8 mean
GC_TIE_STEPS = 1 + 1e-5  # one final-scale step (a requantization tie), and its fp32 rounding
GC_LAUNCHER_STEPS = 10


def dp_setup(dev):
    """Phase 13's model and optimizer: qwen3_1p7b (DENSE) at full width and
    DP_LAYERS layers, params drawn on `dev` from SEED (each process draws
    the same), AdamW at a constant DP_LR with global-norm clipping."""
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.optim import AdamW

    bundle = build_model(dataclasses.replace(get_arch("qwen3_1p7b"), n_layers=DP_LAYERS),
                         Mode.DENSE)
    params = bundle.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    return bundle, params, AdamW(lr=DP_LR, clip_norm=1.0)


def dp_batch(vocab: int, step: int, dev) -> dict:
    """The global batch of `step`: MarkovLM over the full vocab."""
    from repro_torch.data import MarkovLM

    batch = MarkovLM(vocab=vocab, seq_len=DP_SEQ, batch=DP_BATCH).batch_at(step)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def timed_step(dev, fn, *args):
    """(fn's result, its wall seconds to the card's last op)."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = fn(*args)
    torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def dp_rank(rank: int, devices: list[str], init: str, ckdir: str, go, release, q) -> None:
    """One rank of phase 13, in its own process: join the data mesh, run
    `dp_rank_work`, hand its results (CUDA tensors as IPC handles) to the
    parent, and keep them alive until the parent releases it."""
    import traceback

    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(data=DP, rank=rank, devices=devices, init_method=init)
        try:
            res = dp_rank_work(mesh, Path(ckdir), go)
            q.put(("ok", res))
            release.wait(900)
            # the parent has dropped its views: free the shared blocks before exit
            del res
            import gc as pygc
            pygc.collect()
            torch.cuda.synchronize()
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
        finally:
            mesh.close()
    except BaseException:             # noqa: BLE001 — the parent reports it and fails
        q.put(("error", {"rank": rank, "trace": traceback.format_exc()}))


def dp_rank_work(mesh, ckdir: Path, go) -> dict:
    """(a) DP_STEPS data-parallel ZeRO-1 steps on the global batches, each
    step's wall time and collectives; (c) the state gathered and committed
    (rank 0 writes); (b) one compressed gradient step
    (`grad_compression.make_compressed_grad_fn`, the compressed train
    step's reduce; the launcher runs the whole step in (d)) with the
    module's reduce watched: the local vector it was given and the mean it
    returned, and the residual against what int8 drops."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.data_parallel import Zero1, make_data_parallel_step
    from repro_torch.kernels import counters
    from repro_torch.train import grad_compression as gc
    from repro_torch.train.train_step import make_loss_fn
    from repro_torch.weights import reference_leaves

    dev = mesh.device
    counters.reset()
    bundle, params, opt = dp_setup(dev)
    layout = Zero1.build(mesh, params)
    state = layout.init_state(opt, params)
    step = make_data_parallel_step(bundle, opt, layout, compute_dtype=torch.float32)
    batches = [dp_batch(bundle.arch.vocab, i, dev) for i in range(DP_STEPS + 1)]
    check(go.wait(600), "the parent's single-rank run did not finish")
    out: dict = {"rank": mesh.rank, "steps": []}
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(DP_STEPS):
        mesh.reset_counters()
        (params, state, met), wall = timed_step(dev, step, params, state, batches[i])
        out["steps"].append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                             "wall": wall, "coll": dict(mesh.counters)})
        if i == 0:
            out["params_1"] = params
    out["peak_a"] = torch.cuda.max_memory_allocated(dev)
    moments = reference_leaves(state.m)
    out["shards"] = {p: [tuple(t.shape) for t in leaves] for p, leaves in moments.items()}
    out["shard_bytes"] = 2 * sum(t.numel() * t.element_size()
                                 for leaves in moments.values() for t in leaves)
    # (c) every rank gathers the moments, rank 0 commits, all pass a barrier
    mesh.reset_counters()
    full, gather_s = timed_step(dev, layout.gather_state, {"params": params, "opt": state})
    t0 = time.perf_counter()
    if mesh.rank == 0:
        Checkpointer(ckdir).save(DP_STEPS, full, blocking=True)
    mesh.barrier()
    out["commit"] = {"gather_s": gather_s, "save_s": time.perf_counter() - t0,
                     "coll": dict(mesh.counters)}
    out["params"] = params
    if mesh.rank == 0:
        out["m"], out["v"] = full["opt"].m, full["opt"].v
    del state, full
    # (b) the compressed gradient step, its reduce and error feedback watched
    seen: dict = {}
    mean_1d, correct = gc.compressed_mean_1d, gc.residual_correct

    def watched_mean(vec, m):
        seen["local"] = vec
        seen["reduced"] = mean_1d(vec, m)
        return seen["reduced"]

    def watched_correct(grads, residual):
        seen["corrected"], seen["residual"] = correct(grads, residual)
        return seen["corrected"], seen["residual"]

    gc.compressed_mean_1d, gc.residual_correct = watched_mean, watched_correct
    try:
        grad_fn = gc.make_compressed_grad_fn(make_loss_fn(bundle, compute_dtype=torch.float32),
                                             mesh)
        mesh.reset_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        (loss, _, _), wall = timed_step(dev, grad_fn, params, gc.init_residual(params),
                                        batches[DP_STEPS])
    finally:
        gc.compressed_mean_1d, gc.residual_correct = mean_1d, correct
    # the new residual is exactly what int8 drops of each leaf of the
    # reference's (stacked) tree: one scale over its layers
    exact, dropped_max = True, 0.0
    residual = reference_leaves(seen.pop("residual"))
    for path, leaves in reference_leaves(seen.pop("corrected")).items():
        scale = gc._scale(torch.stack([gc._absmax(c) for c in leaves]).max())
        for c, r in zip(leaves, residual[path]):
            dropped = c - gc._to_int8(c, scale).float() * scale
            exact = exact and torch.equal(dropped, r)
            dropped_max = max(dropped_max, float(dropped.abs().max()))
            del dropped
    del residual
    out["compressed"] = {"loss": float(loss), "wall": wall, "coll": dict(mesh.counters),
                         "residual_exact": exact, "residual_max": dropped_max,
                         "peak": torch.cuda.max_memory_allocated(dev)}
    out["local"], out["reduced"] = seen["local"], seen["reduced"]
    out["launches"], out["plain"] = counters.launches(), counters.plain_calls()
    del seen, batches
    torch.cuda.empty_cache()          # only what the parent reads stays on the card
    return out


def coll_line(c: dict) -> str:
    from repro_torch.launch.mesh import COLLECTIVES

    return ", ".join(f"{name} {c[name]}x {c[name + '_bytes'] / 1e6:.1f} MB "
                     f"{1e3 * c[name + '_s']:.1f} ms" for name in COLLECTIVES if c[name])


def dp_expected_shards(params) -> list[dict]:
    """Each data rank's moment shard shapes by `opt_spec` (`Zero1` of a rank
    of a dp-DP mesh): {reference path: [per-layer shapes]}."""
    from repro_torch.distributed.data_parallel import Zero1
    from repro_torch.weights import reference_leaves

    out = []
    for r in range(DP):
        mesh = types.SimpleNamespace(data_rank=r, model=1, shape={"data": DP, "model": 1})
        shards = reference_leaves(Zero1.build(mesh, params).shard(params))
        out.append({p: [tuple(t.shape) for t in leaves] for p, leaves in shards.items()})
    return out


def dp_launcher(scratch: Path) -> dict:
    """(d) `launch.train --grad-compression` at its default size, run and
    re-run over its ckpt dir: the second restores the committed stage."""
    import hashlib
    import zipfile

    ck = scratch / "gc_ck"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--grad-compression", "--steps",
           str(GC_LAUNCHER_STEPS), "--ckpt-dir", str(ck)]
    t1 = time.perf_counter()
    text = run_logged(cmd, scratch / "gc_train.log", 600)
    first_s = time.perf_counter() - t1
    final = ck / "00_dense" / f"step_{GC_LAUNCHER_STEPS:08d}" / "arrays.npz"
    check(f"recipe: dense[{GC_LAUNCHER_STEPS}]+int8grads" in text
          and "[int8 compressed grads over 1 rank(s)]" in text and final.exists(),
          f"launch.train --grad-compression: {text[-2000:]}")
    digest = hashlib.sha256(final.read_bytes()).hexdigest()
    t1 = time.perf_counter()
    text2 = run_logged(cmd, scratch / "gc_train2.log", 600)
    check("[dense] already done — restored" in text2
          and hashlib.sha256(final.read_bytes()).hexdigest() == digest,
          f"the re-run did not restore the committed dense stage: {text2[-2000:]}")
    with zipfile.ZipFile(final) as zf:
        residual = [n for n in zf.namelist() if n.startswith("opt/residual/")]
    check(residual, "the launcher's checkpoint holds no compression residual")
    shutil.rmtree(ck, ignore_errors=True)
    return {"first_s": first_s, "second_s": time.perf_counter() - t1,
            "residual_leaves": len(residual),
            "lines": [ln for ln in text.splitlines() if ln.startswith(("step ", "[dense]"))]}


def trees_equal(a, b) -> bool:
    """Whether two trees of the same layout hold the same bytes."""
    from repro_torch.weights import reference_leaves

    al, bl = reference_leaves(a), reference_leaves(b)
    return al.keys() == bl.keys() and all(
        len(al[p]) == len(bl[p]) and all(torch.equal(x, y) for x, y in zip(al[p], bl[p]))
        for p in al)


def phase_dp(dev, scratch: Path) -> dict:
    """Data-parallel training at dp 2: two rank processes, over NCCL when the
    host has two cards, else both on the one card over gloo (all-to-all and
    all-gather then all-reduces of zero-padded buffers). (a) the ZeRO-1
    step against the single-rank step here on the same global batches; (b)
    the int8 compressed step against its plain version on the ranks' own
    local vectors; (c) the dp-2 checkpoint restored by a dp-1 context
    (`elastic.rescale`) and trained on; (d) the launcher's
    --grad-compression, run and resumed. Reads the kernel counts around the
    phase: a dense model launches no LUT kernel and calls no plain version."""
    import gc as pygc
    import multiprocessing as mp
    import queue
    import socket

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.lut_layer import ParamSpec
    from repro_torch.distributed.data_parallel import Zero1, make_data_parallel_step
    from repro_torch.distributed.elastic import ElasticContext, rescale
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import backend_for
    from repro_torch.optim import AdamWState
    from repro_torch.testing import (WITNESS, AdamLeafRule, float64_compute, one_step_off,
                                     witness_ratio)
    from repro_torch.train import grad_compression as gcomp
    from repro_torch.train.train_step import make_train_step
    from repro_torch.weights import reference_leaves, tree_map_ref

    counters.reset()
    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{r}" for r in range(DP)] if n_cards >= DP else ["cuda:0"] * DP
    backend = backend_for(devices)
    ckdir = scratch / "dp_ck"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    q, go, release = ctx.Queue(), ctx.Event(), ctx.Event()
    procs = [ctx.Process(target=dp_rank, args=(r, devices, init, str(ckdir), go, release, q),
                         daemon=True) for r in range(DP)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got: list = []
    try:
        # the single-rank step on the same global batches, and the same
        # steps in float64 (the witness), while the ranks start
        bundle, start, opt = dp_setup(dev)
        vocab = bundle.arch.vocab
        batches = [dp_batch(vocab, i, dev) for i in range(2 * DP_STEPS)]
        params, state = start, opt.init(start)
        step = make_train_step(bundle, opt, compute_dtype=torch.float32)
        # the leaf rule after one step and, for the record, over all K
        rule, rule_k, single = AdamLeafRule(opt), AdamLeafRule(opt), []
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(DP_STEPS):
            m_old = state.m
            (params, state, met), wall = timed_step(dev, step, params, state, batches[i])
            # the step's clipped gradient, up to a factor, from the first moment
            g = tree_map_ref(lambda _p, m, m0: m - opt.b1 * m0, state.m, m_old)
            rule_k.note(g, DP_LR)
            if i == 0:
                rule.note(g, DP_LR)
                single_1 = params
            single.append((float(met["loss"]), wall))
            del g
        peak_single = torch.cuda.max_memory_allocated(dev)
        opt64 = dataclasses.replace(opt, state_dtype=torch.float64)
        p64 = tree_map_ref(lambda _p, t: t.double(), start)
        s64 = opt64.init(p64)
        step64 = make_train_step(bundle, opt64, compute_dtype=torch.float64)
        t1 = time.perf_counter()
        with float64_compute():
            for i in range(DP_STEPS):
                p64, s64, _ = step64(p64, s64, batches[i])
        torch.cuda.synchronize(dev)
        f64_s = time.perf_counter() - t1
        del step64
        pygc.collect()
        torch.cuda.empty_cache()          # the ranks need what the float64 steps held
        log(f"[dp] single-rank steps here: {', '.join(f'{w:.3f}s' for _, w in single)}; the "
            f"same steps in float64 {f64_s:.1f}s; peak {peak_single / 2**30:.2f} GiB (fp32), "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (with float64)")
        # (d) while the ranks start (import, mesh, init): its processes are
        # gone before the ranks' timed steps, so (a)-(c) run alone
        out_d = dp_launcher(scratch)
        go.set()
        deadline = time.monotonic() + 600
        while len(got) < DP:            # a failed rank ends the wait: its peer would hang
            got.append(q.get(timeout=max(1.0, deadline - time.monotonic())))
            if got[-1][0] != "ok":
                break
    except queue.Empty:
        got.append(("error", {"trace": f"no result from {DP - len(got)} rank(s) in 600 s"}))
    errors = [val["trace"] for status, val in got if status != "ok"]
    if errors:
        for p in procs:
            p.kill()
    check(not errors, "a dp rank failed:\n" + "\n".join(errors))
    t_ranks = time.perf_counter() - t0
    # the ranks' tensors (IPC views of their memory) on this process's card
    r0, r1 = ({k: tree_map_ref(lambda _p, t: t.to(dev), v)
               if k in ("params_1", "params", "m", "v", "local", "reduced") else v
               for k, v in val.items()}
              for val in sorted((val for _, val in got), key=lambda v: v["rank"]))
    out: dict = {"backend": backend, "cards": n_cards}
    log(f"[dp] dp={DP} on {n_cards} card(s): ranks on {devices}, backend {backend}"
        + ("" if backend == "nccl" else " (both ranks share the card: NCCL is not measured; "
           "all-to-all and all-gather are all-reduces of zero-padded buffers)")
        + f"; qwen3_1p7b DENSE, full width, {DP_LAYERS} layers, "
        f"{sum(t.numel() for ls in reference_leaves(start).values() for t in ls) / 1e9:.3f} G "
        f"params, MarkovLM {DP_BATCH} x {DP_SEQ} over the {vocab}-token vocab")

    # (a) the ZeRO-1 step against the single-rank step
    for i, (loss, wall) in enumerate(single):
        for r in (r0, r1):
            s = r["steps"][i]
            check(abs(s["loss"] - loss) <= DP_LOSS_RTOL * abs(loss),
                  f"dp step {i} rank {r['rank']}: loss {s['loss']!r}, single-rank {loss!r}")
        log(f"[dp] (a) step {i}: loss {r0['steps'][i]['loss']:.7f} (single-rank {loss:.7f}), "
            f"grad norm {r0['steps'][i]['grad_norm']:.4f}; wall per rank "
            + " / ".join(f"{r['steps'][i]['wall']:.3f}s" for r in (r0, r1))
            + f" (single-rank {wall:.3f}s); rank 0's collectives: "
            + coll_line(r0["steps"][i]["coll"]))
    # after one step the leaf rule; after K the float64 witness: from the
    # second step on, each fp32 run's rounding moves the next step's forward
    worst, where = rule.check(r0["params_1"], single_1, start)
    check(worst <= 1.0, f"dp params after one step off the single-rank step's: {worst:.3g} of "
          f"the bound at {where}")
    w_params, w_where = witness_ratio(r0["params"], params, p64, start)
    w_m, w_m_where = witness_ratio(r0["m"], state.m, s64.m)
    w_v, w_v_where = witness_ratio(r0["v"], state.v, s64.v)
    check(max(w_params, w_m, w_v) <= WITNESS,
          f"dp after {DP_STEPS} steps further from float64 than the single-rank step: params "
          f"{w_params:.3g} ({w_where}), m {w_m:.3g} ({w_m_where}), v {w_v:.3g} ({w_v_where})")
    worst_k, where_k = rule_k.check(r0["params"], params, start)
    check(trees_equal(r0["params"], r1["params"]), "the two ranks' params differ")
    want_shards = dp_expected_shards(start)
    for r in (r0, r1):
        check(r["shards"] == want_shards[r["rank"]],
              f"rank {r['rank']}'s moment shards are not opt_spec's")
    full_bytes = 2 * 4 * sum(t.numel() for ls in reference_leaves(start).values() for t in ls)
    log(f"[dp] (a) after one step the params within {worst:.3f} of the leaf rule's bound "
        f"({where}); after {DP_STEPS} the dp run's L2 gap from float64 (single-rank steps, "
        f"{f64_s:.1f}s) within {w_params:.2f} (params, {w_where}), {w_m:.2f} (m) and {w_v:.2f} "
        f"(v) of the single-rank run's (bound {WITNESS}), the leaf rule held over "
        f"{DP_STEPS} steps at {worst_k:.3g} of its bound ({where_k}); both ranks' params "
        f"bytewise equal; each rank holds its ZeRO-1 shard of m and v (opt_spec's data dim): "
        f"{r0['shard_bytes'] / 2**30:.2f} and {r1['shard_bytes'] / 2**30:.2f} GiB of "
        f"{full_bytes / 2**30:.2f}; peak allocated {r0['peak_a'] / 2**30:.2f} / "
        f"{r1['peak_a'] / 2**30:.2f} GiB per rank, {peak_single / 2**30:.2f} GiB single-rank")
    del p64, s64, params, state, single_1
    pygc.collect()
    torch.cuda.empty_cache()
    c = r0["commit"]
    log(f"[dp] (c) commit at step {DP_STEPS}: moments gathered in {c['gather_s']:.2f}s "
        f"({coll_line(c['coll'])}), rank 0 wrote the checkpoint in {c['save_s']:.2f}s")

    # (b) the compressed step against its plain version on the ranks' own vectors
    # the vectors the reduce was given: every gradient, zero-padded to a multiple of DP
    n_el = r0["local"].numel()
    plain = gcomp.plain_compressed_mean(torch.stack([r0["local"], r1["local"]]))
    exact = (r0["local"] + r1["local"]) / DP
    ties = 0
    for r in (r0, r1):
        off, worst_b = one_step_off(r["reduced"], plain, DP)
        check(worst_b <= GC_TIE_STEPS,
              f"rank {r['rank']}'s int8 mean off its plain version by {worst_b:.3g} steps")
        ties += off
        cr = r["compressed"]
        check(cr["residual_exact"] and cr["residual_max"] > 0,
              f"rank {r['rank']}'s residual is not what int8 dropped "
              f"(exact {cr['residual_exact']}, max {cr['residual_max']})")
    err = float((r0["reduced"] - exact).abs().max() / exact.abs().max())
    check(err < GC_GRAD_ERR, f"int8 mean gradient off the exact mean by {err:.4f}")
    with torch.no_grad():
        exact_loss = float(bundle.loss(r0["params"], batches[DP_STEPS],
                                       compute_dtype=torch.float32))
    cl = r0["compressed"]["loss"]
    check(r1["compressed"]["loss"] == cl and abs(cl - exact_loss) <= DP_LOSS_RTOL * abs(exact_loss),
          f"compressed gradient step's mean loss {cl!r}, exact {exact_loss!r}")
    out["gc_ties"] = ties
    log(f"[dp] (b) compressed gradient step: mean loss {cl:.7f} (exact {exact_loss:.7f}); the int8 mean "
        f"{err:.4f} of the exact mean gradient's max off it (< {GC_GRAD_ERR}); each rank's bytewise "
        f"the plain compressed mean of the two local vectors ({n_el} elements) but {ties} "
        f"element(s) one final-scale step off at a requantization tie; residual exactly what int8 "
        f"dropped (max {r0['compressed']['residual_max']:.3g}); wall "
        f"{r0['compressed']['wall']:.3f}s, peak {r0['compressed']['peak'] / 2**30:.2f} GiB; "
        f"rank 0's collectives: {coll_line(r0['compressed']['coll'])}")

    # (c) a dp-1 context restores the dp-2 checkpoint and trains on
    made: dict = {}

    def make_step(mesh, rules):
        made["layout"] = Zero1.build(mesh, start, rules=rules)
        return make_data_parallel_step(bundle, opt, made["layout"], compute_dtype=torch.float32)

    ectx = ElasticContext.build([f"cuda:{torch.cuda.current_device()}"], make_step)
    try:
        layout = made["layout"]
        t1 = time.perf_counter()
        # the restore's `like`: shapes and dtypes (the leaves go to the card),
        # the step counter a host tensor
        spec = lambda _p, t: ParamSpec(tuple(t.shape), t.dtype)      # noqa: E731
        like = {"params": tree_map_ref(spec, start),
                "opt": AdamWState(step=torch.zeros((), dtype=torch.int32),
                                  m=tree_map_ref(spec, start), v=tree_map_ref(spec, start))}
        k, tree = rescale(Checkpointer(ckdir), like, ectx, layout.cuts(start))
        restore_s = time.perf_counter() - t1
        check(k == DP_STEPS and int(tree["opt"].step) == DP_STEPS,
              f"restored step {k}, opt step {int(tree['opt'].step)}")
        for name, want_t in (("params", r0["params"]), ("m", r0["m"]), ("v", r0["v"])):
            got_t = tree["params"] if name == "params" else getattr(tree["opt"], name)
            check(trees_equal(got_t, want_t),
                  f"the restored {name} are not the ranks' gathered ones bytewise")
        del want_t, got_t
        p2, s2, after = tree["params"], tree["opt"], []
        del tree
        for i in range(DP_STEPS, 2 * DP_STEPS):
            p2, s2, met = ectx.step_fn(p2, s2, batches[i])
            after.append(float(met["loss"]))
    finally:
        ectx.mesh.close()
    losses = [s["loss"] for s in r0["steps"]] + after
    check(all(math.isfinite(x) for x in losses) and sum(losses[-3:]) < sum(losses[:3]),
          f"losses across the rescale: {losses}")
    log(f"[dp] (c) rescale dp {DP} -> 1 (a new mesh of the surviving device): restored step {k} "
        f"in {restore_s:.2f}s, moments and params bytewise the ranks' gathered ones; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    used = gpu_used_mib()
    out["peaks"] = [r["peak_a"] for r in (r0, r1)]
    rank_counts = [(r["launches"], r["plain"]) for r in (r0, r1)]
    del r, r0, r1, got, plain, exact, p2, s2
    pygc.collect()
    torch.cuda.empty_cache()
    torch.cuda.ipc_collect()
    release.set()
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
            p.join(timeout=30)
    check(all(p.exitcode == 0 for p in procs),
          f"dp ranks exited {[p.exitcode for p in procs]}")
    log(f"[dp] the card's used memory with both ranks alive: {used} MiB; ranks' results "
        f"{t_ranks:.1f}s after spawn (spawn, import, mesh, init, the wait for the single-rank "
        f"and float64 steps and (d), then (a)-(b))")
    shutil.rmtree(ckdir, ignore_errors=True)
    out["launcher"] = d = out_d
    log(f"[dp] (d) launch.train --grad-compression --steps {GC_LAUNCHER_STEPS} (default size, "
        f"while the ranks started) {d['first_s']:.1f}s; the re-run restored the committed stage ('already "
        f"done') in {d['second_s']:.1f}s, its checkpoint ({d['residual_leaves']} residual "
        f"leaves) unchanged")
    for line in d["lines"]:
        log(f"  {line}")
    launches, plain_calls = counters.launches(), counters.plain_calls()
    check(all(sum(ln.values()) == 0 and pc == 0 for ln, pc in rank_counts + [(launches,
                                                                               plain_calls)]),
          f"phase 13 reached a LUT kernel or a plain version: {rank_counts}, {launches}, "
          f"{plain_calls}")
    log("[dp] no LUT kernel launched and no plain LUT version called, here or on a rank")
    return out


# ---------------------------------------------------------------------------
# phase 14: tensor-parallel training on a (data, model) = (2, 2) mesh (the
# dense decoder LMs; DENSE and soft-PQ steps; ZeRO-1 inside model shards)
# ---------------------------------------------------------------------------

TPT_MESH = (2, 2)
TPT_LAYERS = 2           # qwen3_1p7b at full width: layer 0 dense, layer 1 LUT under all_but_first
TPT_BATCH, TPT_SEQ = 4, 128
TPT_LR = 1e-3            # constant: the leaf rule's bound is 2 lr a step (100x for log_t)
TPT_LOSS_RTOL = 1e-5     # the mean of the data ranks' losses against the batch's
LOG_T_TERMS = 1e-6       # a log_t gradient against its terms' magnitudes (a cancelling sum)


def tpt_setup(mode: str, dev):
    """Phase 14's model: qwen3_1p7b at full width and TPT_LAYERS layers,
    params drawn on `dev` from SEED (each process draws the same), the
    LUT_TRAIN centroids at the activations' scale as in phase 7(a); AdamW
    at TPT_LR with global-norm clipping (SOFT_PQ_RULES for soft-PQ).
    Returns (bundle, params, opt, frozen mask or None)."""
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.optim import SOFT_PQ_RULES, AdamW, lut_frozen_mask

    bundle = build_model(dataclasses.replace(get_arch("qwen3_1p7b"), n_layers=TPT_LAYERS),
                         Mode(mode))
    params = bundle.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    if mode == "dense":
        return bundle, params, AdamW(lr=TPT_LR), None
    for layer in params["segments"][1]:
        for site in (*layer["attn"].values(), *layer["mlp"].values()):
            if "centroids" in site:
                site["centroids"].mul_(50.0)
    return bundle, params, AdamW(lr=TPT_LR, rules=SOFT_PQ_RULES), lut_frozen_mask(params)


def tpt_batch(vocab: int, step: int, dev) -> dict:
    from repro_torch.data import MarkovLM

    batch = MarkovLM(vocab=vocab, seq_len=TPT_SEQ, batch=TPT_BATCH).batch_at(step)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def tpt_cut_record(rec: dict, lay, mesh, n_rows: int) -> dict:
    """The single-rank step's `testing.table_hooks` record cut to a rank's
    part: its rows of every code, a row site's codebooks of them, and each
    table's M shard (column site) or C shard (row site)."""
    r, tp = mesh.model_rank, lay.tp
    per = n_rows // mesh.data
    lo = mesh.data_rank * per

    def part(site: str, t):
        role = lay.roles.get(site)
        if role is None:
            return t
        if role.startswith("col"):
            m = t.shape[-1] // tp
            return t[..., r * m:(r + 1) * m]
        c = t.shape[0] // tp
        return t[r * c:(r + 1) * c]

    codes = {}
    for (key, call), cds in rec["codes"].items():
        cds = cds[lo:lo + per]
        if lay.roles.get(key[0]) == "row":
            c = cds.shape[1] // tp
            cds = cds[:, r * c:(r + 1) * c]
        codes[(key, call)] = cds
    return {"codes": codes,
            "rounding": {k: (part(k[0], q), part(k[0], x)) for k, (q, x) in
                         rec["rounding"].items()}}


def tpt_devices(world: int) -> tuple[int, list[str]]:
    """(cards on the host, each rank's device): a card per rank where there
    are enough, else every rank on the first."""
    n = torch.cuda.device_count()
    return n, ([f"cuda:{r}" for r in range(world)] if n >= world else ["cuda:0"] * world)


def tpt_rank(rank: int, jobs, devices: list[str], init: str, q, pin_path: str, go) -> None:
    """One rank of phases 14 and 15, in its own process: join the (2, 2)
    mesh, run `tpt_rank_work` and hand its results (CUDA tensors as IPC
    handles) to the parent; then, on the same mesh, run each job of phase
    15 the parent sends (`tpf_rank_work`) and hand its results over. A
    rank keeps its last results alive until the next message arrives: a
    job, "free" (the parent is done with them, or a single-rank step on the
    card comes next: the rank answers once it let go) or None (the end)."""
    import gc as pygc
    import traceback

    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(data=TPT_MESH[0], model=TPT_MESH[1], rank=rank, devices=devices,
                              init_method=init)
        try:
            held = tpt_rank_work(mesh, pin_path, go)
            q.put(("ok", held))
            while True:
                job = jobs.get(timeout=900)
                del held
                held = None
                pygc.collect()
                torch.cuda.synchronize()
                torch.cuda.ipc_collect()
                torch.cuda.empty_cache()
                if job is None:
                    break
                if job == "free":
                    q.put(("freed", rank))
                    continue
                held = tpf_rank_work(mesh, job)
                del job
                q.put(("ok", held))
        finally:
            mesh.close()
    except BaseException:             # noqa: BLE001 — the parent reports it and fails
        q.put(("error", {"rank": rank, "trace": traceback.format_exc()}))


def tpt_rank_work(mesh, pin_path: str, go) -> dict:
    """(a) a DENSE step and (b) a soft-PQ step of the rank's shard
    (`tensor_parallel.place(train=True)`, ZeRO-1 inside it), then (c)-(d)
    the same under FSDP (`ShardingRules(fsdp=True)`), each step's
    wall time, peak memory and collectives per axis; the params after the
    first DENSE step and after the soft-PQ step (the rank's shards), the
    soft-PQ step taking the single-rank step's codes and table integers
    where its own differ at a tie (`testing.table_hooks`' pin), each
    difference checked; each rank's param and moment shapes against its
    spec cut."""
    from repro_torch import testing
    from repro_torch.distributed.data_parallel import Zero1, make_data_parallel_step
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import place
    from repro_torch.kernels import counters
    from repro_torch.optim import lut_frozen_mask
    from repro_torch.weights import reference_leaves

    dev = mesh.device
    counters.reset()
    rules = ShardingRules.for_mesh(mesh)
    out: dict = {"rank": (mesh.data_rank, mesh.model_rank)}

    def build(mode: str, rules=rules, tag: str = ""):
        bundle, params, opt, frozen = tpt_setup(mode, dev)
        local, lp, lay = place(bundle, params, rules, mesh, train=True)
        del params
        lfrozen = lut_frozen_mask(lp) if frozen is not None else None
        layout = Zero1.build(mesh, lp, lfrozen, rules, tp=lay)
        state = layout.init_state(opt, lp, lfrozen)
        frozen_paths = {p for p, ls in reference_leaves(lfrozen or {}).items() if ls[0]}
        want_p, want_m = testing.expected_rank_shapes(bundle, rules, mesh.data_rank,
                                                      frozen_paths)
        got_p = {p: [tuple(t.shape) for t in ls] for p, ls in reference_leaves(lp).items()}
        got_m = {p: [tuple(t.shape) for t in ls] for p, ls in reference_leaves(state.m).items()}
        out[f"shapes_{tag}{mode}"] = [p for p in want_p if got_p.get(p) != want_p[p]] + \
            [f"moment {p}" for p in want_m if got_m.get(p) != want_m[p]]
        out[f"bytes_{tag}{mode}"] = (sum(t.numel() * t.element_size() for t in _tensors(lp)),
                                     sum(t.numel() * t.element_size()
                                         for t in _tensors([state.m, state.v])))
        step = make_data_parallel_step(local, opt, layout, frozen_mask=lfrozen,
                                       compute_dtype=torch.float32)
        return bundle, lp, lay, state, step, layout

    def timed(label, step, params, state, batch):
        mesh.reset_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        # what the rank holds before the step: its params and moments, and
        # the earlier runs' results kept for the parent's holds
        held = torch.cuda.memory_allocated(dev)
        (params, state, met), wall = timed_step(dev, step, params, state, batch)
        out.setdefault("steps", []).append({
            "label": label, "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "wall": wall, "peak": torch.cuda.max_memory_allocated(dev), "held": held,
            "coll": {a: dict(c) for a, c in mesh.axis_counters.items()}})
        return params, state

    bundle, params, lay, state, step, _ = build("dense")
    batch = tpt_batch(bundle.arch.vocab, 0, dev)
    check(go.wait(600), "the parent's single-rank steps did not finish")
    params, state = timed("dense 1", step, params, state, batch)
    out["dense_1"] = params
    out["dense_roles"] = len(lay.roles)
    del state, step
    def soft_pq(tag: str, rules=rules):
        """The soft-PQ step, pinned to the single-rank step's codes and integers."""
        bundle, lparams, lay, state, step, layout = build("lut_train", rules, tag)
        rec_c = torch.load(pin_path, weights_only=False)
        pin = tpt_cut_record(rec_c, lay, mesh, TPT_BATCH * TPT_SEQ)
        del rec_c
        hooks = testing.table_hooks(lparams, pin=pin, tie_eps=TIE_EPS)
        with hooks as rec:
            lparams, state = timed(f"{tag}soft-PQ", step, lparams, state,
                                   tpt_batch(bundle.arch.vocab, 0, dev))
        failures = [f"rank {mesh.rank} {m}" for m in rec["off"]]
        out[f"{tag}lut_pinned"] = rec["pinned"]
        out[f"{tag}lut_flips"] = testing._rounding_flips(pin["rounding"], rec["rounding"],
                                                         f"rank {mesh.rank}", failures)
        out[f"{tag}lut_failures"] = failures
        out[f"{tag}lut_1"] = layout.model_shards(lparams)
        out[f"{tag}lut_m_log_t"] = {p: [float(t) for t in ls]
                                    for p, ls in reference_leaves(state.m).items()
                                    if p.endswith("log_t")}
        out["partial"] = sorted(lay.partial)

    # (b) the soft-PQ step
    soft_pq("")
    torch.cuda.empty_cache()
    zero1 = counters.launches(), counters.plain_calls()
    counters.reset()
    # (c) FSDP (ShardingRules(fsdp=True)): a DENSE step from the same start,
    # each rank its data part of every leaf the spec splits over "data" too
    fsdp = ShardingRules.for_mesh(mesh, fsdp=True)
    bundle, params, lay, state, step, layout = build("dense", fsdp, "fsdp ")
    params, state = timed("fsdp dense 1", step, params, state, batch)
    out["fsdp dense_1"] = layout.model_shards(params)
    out["fsdp_split"] = len(lay.fsdp)
    del params, state, step, batch
    torch.cuda.empty_cache()
    # (d) FSDP's soft-PQ step
    soft_pq("fsdp ", fsdp)
    out["fsdp_launches"], out["fsdp_plain"] = counters.launches(), counters.plain_calls()
    # the phase's counts: (a)-(b)'s and (c)-(d)'s
    out["launches"] = {k: zero1[0].get(k, 0) + out["fsdp_launches"].get(k, 0)
                       for k in zero1[0].keys() | out["fsdp_launches"].keys()}
    out["plain"] = zero1[1] + out["fsdp_plain"]
    torch.cuda.empty_cache()
    return out


def tpt_free(started: dict) -> None:
    """The (2, 2) ranks (`tpt_rank`) let go of their last results."""
    for jq in started["jobs"]:
        jq.put("free")
    freed = [started["q"].get(timeout=120) for _ in started["jobs"]]
    check(all(st == "freed" for st, _ in freed),
          f"a tp-train rank failed: {[v for st, v in freed if st != 'freed']}")


def tpt_assemble(ranks: dict, lay, data_rank: int = 0):
    """The whole params (port layout) from the shards of the ranks of one
    data row: each cut leaf concatenated over its model ranks, the others
    the first rank's."""
    from repro_torch.weights import tree_map_ref

    row = [ranks[(data_rank, m)] for m in range(lay.tp)]

    def whole(path, t, *others):
        if t is None or path not in lay.cuts:
            return t
        return torch.cat([t, *others], dim=lay.cuts[path][0])

    return tree_map_ref(whole, row[0], *row[1:])


def tpt_replicas(ranks: dict, lay) -> list[str]:
    """What breaks the replica rule: a rank's params differ from its data
    group's peer, or a replicated leaf from its model group's peer."""
    from repro_torch.weights import reference_leaves

    bad = []
    for (d, m), tree in ranks.items():
        mine = reference_leaves(tree)
        for peer, which in (((1 - d, m), "data"), ((d, 1 - m), "model")):
            theirs = reference_leaves(ranks[peer])
            for path, ls in mine.items():
                if which == "model" and path in lay.cuts:
                    continue
                if not all(torch.equal(a, b) for a, b in zip(ls, theirs[path])):
                    bad.append(f"{(d, m)} vs {peer} ({which} group): {path}")
    return bad


def tpt_coll_line(c: dict) -> str:
    return "; ".join(f"{axis}: {coll_line(c[axis]) or 'none'}" for axis in ("model", "data"))


def tpt_hold(results: list, dev, bundle, single, single_1, start, rule, lbundle, lstart,
             lsingle_1, lmet, lwall, lopt, lrule, single_m_log_t, terms) -> dict:
    """Phase 14's holds of the ranks' `results` (their params as IPC views)
    against the single-rank steps: the losses, the leaf rule after one
    step, log_t by AdamW of its own gradient, the replicas, the pins, the
    spec cuts; logs them and each rank's step lines. Returns the steps
    and the ranks' kernel counts."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import layout as tp_layout
    from repro_torch.weights import reference_leaves, tree_map_ref

    ranks = {tuple(val["rank"]): {k: tree_map_ref(lambda _p, t: t.to(dev), v)
                                  if k in ("dense_1", "lut_1", "fsdp dense_1", "fsdp lut_1")
                                  else v
                                  for k, v in val.items()} for val in results}
    rules = ShardingRules(data=TPT_MESH[0], model=TPT_MESH[1])
    out: dict = {"rank_counts": [(r["launches"], r["plain"]) for r in ranks.values()]}
    for r in ranks.values():
        check(not r["shapes_dense"] and not r["shapes_lut_train"],
              f"rank {r['rank']}'s shards are not its spec cut: "
              f"{(r['shapes_dense'] + r['shapes_lut_train'])[:5]}")

    # (a) DENSE: the step's loss, the params after it by the leaf rule
    lay = tp_layout(bundle, rules, train=True)
    for i, (loss, wall) in enumerate(single):
        for r in ranks.values():
            s = r["steps"][i]
            check(abs(s["loss"] - loss) <= TPT_LOSS_RTOL * abs(loss),
                  f"tp-train DENSE step {i} rank {r['rank']}: loss {s['loss']!r}, single-rank "
                  f"{loss!r}")
        log(f"[tpt] (a) DENSE step {i}: loss {ranks[(0, 0)]['steps'][i]['loss']:.7f} "
            f"(single-rank {loss:.7f}, {wall:.3f}s)")
    worst, where = rule.check(tpt_assemble({k: r["dense_1"] for k, r in ranks.items()}, lay),
                              single_1, start)
    check(worst <= 1.0, f"tp-train DENSE params after one step off the single-rank step's: "
          f"{worst:.3g} of the bound at {where}")
    bad = tpt_replicas({k: r["dense_1"] for k, r in ranks.items()}, lay)
    check(not bad, "tp-train DENSE replicas differ: " + "; ".join(bad[:5]))
    log(f"[tpt] (a) after one step every param leaf within {worst:.3f} of the leaf rule's bound "
        f"({where}); replicated leaves bytewise equal across each model group, params across "
        f"each data group; each rank's params and ZeRO-1 moments its "
        f"ShardingRules{TPT_MESH} cut ({len(lay.roles)} sites sharded)")
    # (b) soft-PQ: the loss, the pins, the leaf rule, log_t by its own gradient
    llay = tp_layout(lbundle, rules, train=True)
    lloss = float(lmet["loss"])

    def hold_lut(tag: str) -> tuple:
        failures = [f for r in ranks.values() for f in r[f"{tag}lut_failures"]]
        check(not failures, f"tp-train {tag}soft-PQ ties: " + "; ".join(failures[:5]))
        for r in ranks.values():
            s = next(st for st in r["steps"] if st["label"] == f"{tag}soft-PQ")
            check(abs(s["loss"] - lloss) <= TPT_LOSS_RTOL * abs(lloss),
                  f"tp-train {tag}soft-PQ rank {r['rank']}: loss {s['loss']!r}, single-rank "
                  f"{lloss!r}")
        got_1 = tpt_assemble({k: r[f"{tag}lut_1"] for k, r in ranks.items()}, llay)
        start_l = reference_leaves(lstart)
        n_log_t = 0
        for path, ls in reference_leaves(got_1).items():
            if not path.endswith("log_t"):
                continue
            for j, p1 in enumerate(ls):
                g_tp = ranks[(0, 0)][f"{tag}lut_m_log_t"][path][j] / (1 - lopt.b1)
                g_1 = single_m_log_t[path][j] / (1 - lopt.b1)
                check(abs(g_tp - g_1) <= LOG_T_TERMS * max(terms[path][j], 1e-30),
                      f"{tag}{path}[{j}]: log_t gradient {g_tp!r} against {g_1!r} (terms "
                      f"{terms[path][j]:.3g})")
                p0 = start_l[path][j]
                tree = {"site": {"log_t": p0}}
                want, _, _ = dataclasses.replace(lopt, clip_norm=None).update(
                    {"site": {"log_t": torch.full_like(p0, g_tp)}}, lopt.init(tree), tree)
                want = want["site"]["log_t"]
                ulp = torch.finfo(torch.float32).eps * float(want.abs())
                check(float((p1 - want).abs()) <= 1e-5 * float((want - p0).abs()) + 2 * ulp,
                      f"{tag}{path}[{j}]: log_t after the step {float(p1)!r}, AdamW of its own "
                      f"gradient {float(want)!r}")
                n_log_t += 1
        got_1 = tree_map_ref(lambda p, g, w: w if p.endswith("log_t") else g, got_1, lsingle_1)
        lworst, lwhere = lrule.check(got_1, lsingle_1, lstart)
        check(lworst <= 1.0, f"tp-train {tag}soft-PQ params after the step off the single-rank "
              f"step's: {lworst:.3g} of the bound at {lwhere}")
        bad = tpt_replicas({k: r[f"{tag}lut_1"] for k, r in ranks.items()}, llay)
        check(not bad, f"tp-train {tag}soft-PQ replicas differ: " + "; ".join(bad[:5]))
        return (sum(r[f"{tag}lut_pinned"] for r in ranks.values()),
                sum(r[f"{tag}lut_flips"] for r in ranks.values()), lworst, lwhere, n_log_t)

    pinned, flips, lworst, lwhere, n_log_t = hold_lut("")
    zl_loss = next(st for st in ranks[(0, 0)]["steps"] if st["label"] == "soft-PQ")["loss"]
    log(f"[tpt] (b) soft-PQ step (layer 1 LUT): loss {zl_loss:.7f} "
        f"(single-rank {lloss:.7f}, {lwall:.3f}s); codes taken from the single-rank step at a "
        f"near-tie: {pinned} over the 4 ranks; fake-quant entries one step off at a "
        f"half-integer: {flips}; every other param leaf within {lworst:.3f} of the leaf rule's "
        f"bound ({lwhere}); {n_log_t} log_t within {LOG_T_TERMS} of their terms and equal to "
        f"AdamW of their own gradient; replicas bytewise equal; partial leaves summed over "
        f"\"model\": {len(ranks[(0, 0)]['partial'])}")
    # (c) FSDP DENSE: the loss, the leaf rule after the step (the rank's
    # data parts gathered to its model shard on the rank), the spec cut
    for r in ranks.values():
        check(not r["shapes_fsdp dense"] and not r["shapes_fsdp lut_train"],
              f"rank {r['rank']}'s FSDP parts are not its spec cut: "
              f"{(r['shapes_fsdp dense'] + r['shapes_fsdp lut_train'])[:5]}")
        for i, (loss, _) in enumerate(single):
            s = next(st for st in r["steps"] if st["label"] == f"fsdp dense {i + 1}")
            check(abs(s["loss"] - loss) <= TPT_LOSS_RTOL * abs(loss),
                  f"FSDP DENSE step {i} rank {r['rank']}: loss {s['loss']!r}, single-rank "
                  f"{loss!r}")
    fworst, fwhere = rule.check(tpt_assemble({k: r["fsdp dense_1"] for k, r in ranks.items()},
                                             lay), single_1, start)
    check(fworst <= 1.0, f"FSDP DENSE params after one step off the single-rank step's: "
          f"{fworst:.3g} of the bound at {fwhere}")
    bad = tpt_replicas({k: r["fsdp dense_1"] for k, r in ranks.items()}, lay)
    check(not bad, "FSDP DENSE model shards differ: " + "; ".join(bad[:5]))
    flosses = [next(st for st in ranks[(0, 0)]["steps"] if st["label"] == f"fsdp dense {i}")
               ["loss"] for i in range(1, len(single) + 1)]
    log(f"[tpt] (c) FSDP DENSE step (ShardingRules{TPT_MESH}, fsdp=True: "
        f"{ranks[(0, 0)]['fsdp_split']} leaves over \"data\" too): loss "
        f"{', '.join(f'{x:.7f}' for x in flosses)} (single-rank "
        f"{', '.join(f'{x:.7f}' for x, _ in single)}); after the step every param leaf within "
        f"{fworst:.3f} of the leaf rule's bound ({fwhere}); each rank's parts and moments its "
        f"ShardingRules{TPT_MESH}(fsdp=True) cut, its model shards gathered bytewise equal "
        f"across each data group")
    pinned, flips, fl_worst, fl_where, n_log_t = hold_lut("fsdp ")
    fl_loss = next(st for st in ranks[(0, 0)]["steps"] if st["label"] == "fsdp soft-PQ")["loss"]
    log(f"[tpt] (d) FSDP soft-PQ step: loss {fl_loss:.7f} (single-rank {lloss:.7f}); codes "
        f"pinned at a near-tie {pinned}, entries one step off {flips}; every other param leaf "
        f"within {fl_worst:.3f} of the leaf rule's bound ({fl_where}); {n_log_t} log_t held")
    for (d, m), r in sorted(ranks.items()):
        zb, fb = r["bytes_dense"], r["bytes_fsdp dense"]
        log(f"[tpt] rank ({d}, {m}) bytes: ZeRO-1 params {zb[0] / 2**30:.3f} GiB + moments "
            f"{zb[1] / 2**30:.3f} GiB; FSDP params {fb[0] / 2**30:.3f} GiB + moments "
            f"{fb[1] / 2**30:.3f} GiB (DENSE); soft-PQ ZeRO-1 "
            f"{r['bytes_lut_train'][0] / 2**30:.3f} + {r['bytes_lut_train'][1] / 2**30:.3f}, "
            f"FSDP {r['bytes_fsdp lut_train'][0] / 2**30:.3f} + "
            f"{r['bytes_fsdp lut_train'][1] / 2**30:.3f} GiB")
        for st in r["steps"]:
            if st["label"].startswith("fsdp"):
                c = st["coll"]["data"]
                for name in ("all_gather", "reduce_scatter"):
                    log(f"[tpt] rank ({d}, {m}) {st['label']}: data {name} {c[name]}x "
                        f"{c[name + '_bytes'] / 1e6:.1f} MB {1e3 * c[name + '_s']:.1f} ms")
    fsdp_launches = {k: sum(r["fsdp_launches"].get(k, 0) for r in ranks.values())
                     for r0 in ranks.values() for k in r0["fsdp_launches"]}
    check(sum(fsdp_launches.values()) == 0 and all(r["fsdp_plain"] == 0
                                                   for r in ranks.values()),
          f"phase 14's FSDP runs reached a LUT kernel or a plain version: {fsdp_launches}")
    out["fsdp"] = {"launches": fsdp_launches, "worst": fworst, "lut_worst": fl_worst,
                   "losses": flosses,
                   "bytes": {str(k): (r["bytes_dense"], r["bytes_fsdp dense"])
                             for k, r in ranks.items()}}
    for (d, m), r in sorted(ranks.items()):
        log(f"[tpt] rank ({d}, {m}): " + "; ".join(
            f"{s['label']} {s['wall']:.3f}s, peak {s['peak'] / 2**30:.2f} GiB "
            f"({s['held'] / 2**30:.2f} held before the step), "
            + tpt_coll_line(s["coll"]) for s in r["steps"]))
    out["steps"] = {k: r["steps"] for k, r in ranks.items()}
    return out


def phase_tp_train(dev, scratch: Path) -> dict:
    """Tensor-parallel training at (data, model) = (2, 2): four rank
    processes on the one card over gloo (four cards would take NCCL, not
    measured here). (a) a DENSE step and (b) a soft-PQ step of qwen3_1p7b
    at full width and TPT_LAYERS layers, then (c)-(d) the same under FSDP,
    against the single-rank step here on the same global batch, run
    before the ranks' steps and freed: the loss within TPT_LOSS_RTOL,
    after the step every param leaf
    (gathered to whole leaves) within the leaf rule (a log_t by AdamW of
    its rank's own gradient, which is held against the single rank's by its
    terms), replicated leaves bytewise equal across each model group and
    params across each data group, each rank's shapes its spec cut; the
    soft-PQ step's ties pinned and checked. No float64 witness on the card
    (4 ranks leave it no room): multi-step holds are the CPU tests' work.
    Reads the kernel counts around the phase: LUT_TRAIN runs plain tensor
    ops, no LUT kernel. The ranks live on as phase 15's (`out["ranks"]`)."""
    import gc as pygc
    import multiprocessing as mp

    from repro_torch import testing
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import layout as tp_layout
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import backend_for
    from repro_torch.testing import AdamLeafRule
    from repro_torch.train.train_step import make_train_step
    from repro_torch.weights import reference_leaves, tree_map_ref

    counters.reset()
    world = TPT_MESH[0] * TPT_MESH[1]
    n_cards, devices = tpt_devices(world)
    backend = backend_for(devices)
    pin_path = scratch / "tpt_pin.pt"
    go = mp.get_context("spawn").Event()
    started = start_ranks(tpt_rank, devices, str(pin_path), go)
    procs, q, t0 = started["procs"], started["q"], started["t0"]
    # the single-rank steps on the same global batches, while the ranks start
    bundle, start, opt, _ = tpt_setup("dense", dev)
    vocab = bundle.arch.vocab
    batches = [tpt_batch(vocab, 0, dev)]
    step = make_train_step(bundle, opt, compute_dtype=torch.float32)
    rule = AdamLeafRule(opt)
    (single_1, state, met), wall = timed_step(dev, step, start, opt.init(start), batches[0])
    rule.note(state.m, TPT_LR)                     # m = (1 - b1) g after the first step
    single = [(float(met["loss"]), wall)]
    del state, step
    lbundle, lstart, lopt, lfrozen = tpt_setup("lut_train", dev)
    lstep = make_train_step(lbundle, lopt, frozen_mask=lfrozen, compute_dtype=torch.float32)
    with testing.table_hooks(lstart) as rec_c:
        (lsingle_1, lstate, lmet), lwall = timed_step(dev, lstep, lstart,
                                                      lopt.init(lstart, lfrozen), batches[0])
    lrule = AdamLeafRule(lopt)
    lrule.note(tree_map_ref(lambda _p, m: None if m.numel() == 0 else m, lstate.m), TPT_LR)
    single_m_log_t = {p: [float(t) for t in ls] for p, ls in
                      reference_leaves(lstate.m).items() if p.endswith("log_t")}
    del lstate, lstep
    torch.save({"codes": rec_c["codes"], "rounding": rec_c["rounding"]}, pin_path)
    n_codes = sum(int(c.numel()) for c in rec_c["codes"].values())
    n_entries = sum(int(x.numel()) for x, _ in rec_c["rounding"].values())
    del rec_c
    # the log_t terms' magnitudes (`testing.lut_train_grads`) of the same batch
    _, _, _, terms, _ = testing.lut_train_grads(lbundle, lstart, batches[0])
    pygc.collect()
    torch.cuda.empty_cache()          # the ranks' steps have the card to themselves
    log(f"[tpt] single-rank steps here: DENSE {', '.join(f'{w:.3f}s' for _, w in single)}, "
        f"soft-PQ {lwall:.3f}s; {n_codes} codes and {n_entries} table entries recorded "
        f"for the pins")
    go.set()
    got = wait_ranks(q, world, 600)
    errors = [val["trace"] for status, val in got if status != "ok"]
    if errors:
        for p in procs:
            p.kill()
    check(not errors, "a tp-train rank failed:\n" + "\n".join(errors))
    t_ranks = time.perf_counter() - t0
    log(f"[tpt] (data, model) = {TPT_MESH} on {n_cards} card(s): ranks on {devices}, backend "
        f"{backend}" + ("" if backend == "nccl" else " (four ranks share the card: NCCL is not "
                        "measured; gathers and the all-max are all-reduces of zero-padded "
                        "buffers)")
        + f"; qwen3_1p7b at full width, {TPT_LAYERS} layers, MarkovLM {TPT_BATCH} x {TPT_SEQ} "
        f"over the {vocab}-token vocab")
    # the ranks' tensors are IPC views of their memory: every reference to
    # them dies with `tpt_hold`'s frame, before the ranks are released
    out = tpt_hold([val for _, val in got], dev, bundle, single, single_1, start, rule,
                   lbundle, lstart, lsingle_1, lmet, lwall, lopt, lrule, single_m_log_t, terms)
    out.update(backend=backend, cards=n_cards)
    rank_counts = out.pop("rank_counts")
    del got, single_1, start, lsingle_1, lstart
    used = gpu_used_mib()
    pygc.collect()
    torch.cuda.empty_cache()
    torch.cuda.ipc_collect()
    tpt_free(started)
    pin_path.unlink(missing_ok=True)
    log(f"[tpt] the card's used memory with the four ranks alive: {used} MiB; ranks' results "
        f"{t_ranks:.1f}s after spawn (spawn, import, mesh, init, the wait for the single-rank "
        f"steps, then (a)-(b)); counts per axis read the recomputed blocks' forward reduces "
        f"twice (activation recomputation runs the forward's collectives again)")
    launches, plain_calls = counters.launches(), counters.plain_calls()
    check(all(sum(ln.values()) == 0 and pc == 0 for ln, pc in rank_counts + [(launches,
                                                                               plain_calls)]),
          f"phase 14 reached a LUT kernel or a plain version: {rank_counts}, {launches}, "
          f"{plain_calls}")
    out["launches"] = {name: 0 for name in launches} | launches
    log("[tpt] no LUT kernel launched and no plain LUT version called, here or on a rank")
    out["used_mib"] = used
    out["ranks"] = started         # phase 15's ranks
    return out


# ---------------------------------------------------------------------------
# phase 15: tensor-parallel training of the MoE, SSM and hybrid families on
# a (data, model) = (2, 2) mesh: experts over both axes with the token
# all-to-all, SSD heads, the shared block
# ---------------------------------------------------------------------------

TPF_MESH = TPT_MESH        # the jobs run in phase 14's ranks
# (arch, layers, mode, steps) at full width: mamba2_370m at 2 layers,
# zamba2_1p2b at 6 (one invocation of the shared block), arctic_480b at 1
# (every layer LUT; its DENSE step, ~107 GB of experts, gradients and AdamW
# moments, and llama4_maverick_400b are held by the CPU tests)
# (arch, layers, mode, steps, fsdp): the FSDP job (ShardingRules(fsdp=True))
# follows the ZeRO-1 job of the same model and is held against its single-rank steps.
# One step each: the leaf rule after it holds the update (multi-step holds,
# the float64 witness among them, are the CPU tests' work)
# Phase 16 (b) rides in the same ranks: whisper_tiny at full size (4 + 4
# layers, 1500 frames) and qwen2_vl_7b at full width and 2 layers, each a
# DENSE and a soft-PQ step under ZeRO-1 and a DENSE step under FSDP, on
# `testing.family_batch` batches (`tpf_batch`)
TPF_JOBS = (("mamba2_370m", 2, "dense", 1, False), ("mamba2_370m", 2, "dense", 1, True),
            ("mamba2_370m", 2, "lut_train", 1, False),
            ("zamba2_1p2b", 6, "dense", 1, False), ("zamba2_1p2b", 6, "lut_train", 1, False),
            ("arctic_480b", 1, "lut_train", 1, False),
            ("whisper_tiny", 4, "dense", 1, False), ("whisper_tiny", 4, "dense", 1, True),
            ("whisper_tiny", 4, "lut_train", 1, False),
            ("qwen2_vl_7b", 2, "dense", 1, False), ("qwen2_vl_7b", 2, "dense", 1, True),
            ("qwen2_vl_7b", 2, "lut_train", 1, False))
PHASE16_ARCHS = ("whisper_tiny", "qwen2_vl_7b")
# the (arch, mode, fsdp) jobs whose single-rank steps run again after the
# ranks' (the first run gives the soft-PQ pins, and is freed), once the
# parent holds copies of the ranks' results and the ranks let go of theirs:
# qwen2_vl_7b's single-rank state (1.48 G params before and after its step,
# the leaf rule's masks, ~12 GiB) beside ZeRO-1's and soft-PQ's peaks (15.6
# and 14.1 GiB a rank), or its step (~38 GiB) beside the ranks' IPC-shared
# results, left too little of the card (OOM); FSDP's (11.5 GiB) leave room,
# and the FSDP job reuses the DENSE job's
TPF_SINGLE_AFTER = (("qwen2_vl_7b", "dense", False), ("qwen2_vl_7b", "lut_train", False))
TPF_LR = 1e-3            # constant: the leaf rule's bound is 2 lr a step (100x for log_t)
# under bf16 weights (arctic_480b) a bf16 leaf's gradient is rounded to bf16,
# and a codebook's gradient through its bf16 table is a contraction rounded
# to bf16 (on a column site's rank over its half of the table's columns): the
# fp32-level differences of the model axis' reductions move them by bf16
# ulps, and a bf16 leaf's update lands on a bf16 value, far coarser than the
# fp32 rounding the leaf rule assumes. Those leaves are held by their
# gradient, max|d grad| <= BF16_GRAD max|grad| (two bf16 roundings), and by
# AdamW of the rank's own gradient (within one ulp of the leaf's dtype)
BF16_GRAD = 2.0 ** -7
# the soft-PQ steps run unclipped: at the activations' scale the
# temperatures' gradients (~1e8 at these sites) would clip every other
# leaf's far below Adam's eps, where its first update is proportional to its
# gradient and carries that gradient's rounding, which the leaf rule (Adam
# moves an element by about lr) does not describe. The DENSE steps clip at 1.0.


def tpf_bundle(name: str, layers: int, mode: str):
    """Phase 15's model of `name` at full width and `layers` layers (arctic
    with every layer LUT), and its AdamW (SOFT_PQ_RULES for soft-PQ)."""
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.optim import SOFT_PQ_RULES, AdamW

    arch = dataclasses.replace(get_arch(name), n_layers=layers)
    if name == "arctic_480b":
        arch = dataclasses.replace(arch, lut_policy="all")
    opt = (AdamW(lr=TPF_LR, rules=SOFT_PQ_RULES, clip_norm=None) if mode == "lut_train"
           else AdamW(lr=TPF_LR))
    return build_model(arch, Mode(mode)), opt


@contextlib.contextmanager
def tpf_routes():
    """Record the dispatch (routing decisions and kept slots) of every MoE
    routing call while active (a recomputed block routes again)."""
    from repro_torch.models import moe

    real, got = moe.route, []

    def route(cfg, p, x):
        out = real(cfg, p, x)
        got.append(out[2].clone())
        return out

    moe.route = route
    try:
        yield got
    finally:
        moe.route = real


@contextlib.contextmanager
def tpf_one_expert_chunks():
    """Expert tables built one expert at a time (`moe.CHUNK_BYTES`): the
    single rank and each rank then build every expert's table by the same
    call, so that its integers are the same on both sides."""
    from repro_torch.models import moe

    real = moe.CHUNK_BYTES
    moe.CHUNK_BYTES = 1
    try:
        yield
    finally:
        moe.CHUNK_BYTES = real


def tpf_batch(arch, step: int, dev) -> dict:
    """Phase 15's global batch `step` of `arch`: MarkovLM's tokens, or for the
    enc-dec and the vision-LM `testing.family_batch`'s (stub frames, or
    embeddings and their M-RoPE grid positions) from a seed, TPT_BATCH x
    TPT_SEQ."""
    if arch.family != "audio" and not arch.takes_embeds:
        return tpt_batch(arch.vocab, step, dev)
    from repro_torch.testing import family_batch

    batch = family_batch(arch, TPT_BATCH, TPT_SEQ, seed=SEED + 60 + step)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def tpf_cut_pin(rec: dict, lay, mesh, n_local: int) -> dict:
    """The single-rank step's `testing.table_hooks` record cut to a rank's
    part: its data rows of every code (a row site's codebooks of them), an
    expert site's codes and table digests of the rank's experts (renamed to
    its local ids), and each table's M part (a column site's, in_proj's by
    its blocks) or C shard (a row site)."""
    from repro_torch.distributed.tensor_parallel import cut

    r, tp, d = mesh.model_rank, lay.tp, mesh.data_rank
    first = (r * lay.data + (d if lay.data > 1 else 0)) * n_local

    def table(site: str, t):
        role = lay.roles.get(site)
        if role is None or role == "ep":
            return t
        if role.startswith("col"):
            return cut(t, (t.dim() - 1, lay.cuts.get(f"{site}/w", (None, None))[1]), r, tp)
        return cut(t, (0, None), r, tp)

    def local(key):
        """The rank's key of a record key, None where it is another rank's expert."""
        site, layer, experts = key
        if experts is None:
            return key
        if lay.roles.get(site) != "ep":
            return key
        (g,) = experts
        return (site, layer, (g - first,)) if first <= g < first + n_local else None

    codes, rounding = {}, {}
    for (key, call), cds in rec["codes"].items():
        k = local(key)
        if k is None:
            continue
        if key[2] is None:
            per = cds.shape[0] // mesh.data        # the encoder's sites: B x frames rows
            cds = cds[d * per:(d + 1) * per]
            if lay.roles.get(key[0]) == "row":
                c = cds.shape[1] // tp
                cds = cds[:, r * c:(r + 1) * c]
        codes[(k, call)] = cds
    for key, val in rec["rounding"].items():
        k = local(key)
        if k is not None:
            rounding[k] = val if isinstance(val[0], str) else tuple(table(key[0], t) for t in val)
    return {"codes": codes, "rounding": rounding}


def tpf_rank_work(mesh, job: dict) -> dict:
    """One job on a rank: its part of the model drawn from the seed the
    parent drew it from (`tensor_parallel.init_rank`: an expert stack keeps
    the rank's experts as it is drawn, no whole stack on a rank),
    `job["steps"]` steps of its ZeRO-1 step
    (a soft-PQ step pinned to the single-rank step's codes and integers at
    ties, each difference checked), each step's wall time, peak memory and
    collectives per axis; after the first step its params (the trainable
    leaves: its own, and rank (0, 0) the gathered whole ones), its routing
    decisions, its shapes against the expected cut and its log_t moments."""
    from repro_torch import testing
    from repro_torch.distributed.data_parallel import Zero1, make_data_parallel_step
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import init_rank
    from repro_torch.kernels import counters
    from repro_torch.optim import lut_frozen_mask
    from repro_torch.weights import reference_leaves, tree_map_ref

    dev = mesh.device
    counters.reset()
    rules = ShardingRules.for_mesh(mesh, fsdp=job["fsdp"])
    bundle, opt = tpf_bundle(job["name"], job["layers"], job["mode"])
    t0 = time.perf_counter()
    local, lp, lay = init_rank(bundle, rules, mesh,
                               torch.Generator(device=dev).manual_seed(SEED + 50))
    lut = job["mode"] == "lut_train"
    if lut:             # as the parent scaled them
        tree_map_ref(lambda p, t: t.mul_(50.0) if p.endswith("centroids") else None, lp)
    init_s = time.perf_counter() - t0
    lfrozen = lut_frozen_mask(lp) if lut else None
    layout = Zero1.build(mesh, lp, lfrozen, rules, tp=lay)
    state = layout.init_state(opt, lp, lfrozen)
    frozen_paths = {p for p, ls in reference_leaves(lfrozen or {}).items() if ls[0]}
    want_p, want_m = testing.expected_rank_shapes(bundle, rules, mesh.data_rank, frozen_paths,
                                                  lay.kept)
    got_p = {p: [tuple(t.shape) for t in ls] for p, ls in reference_leaves(lp).items()}
    got_m = {p: [tuple(t.shape) for t in ls] for p, ls in reference_leaves(state.m).items()}
    out: dict = {"rank": (mesh.data_rank, mesh.model_rank), "steps": [],
                 "shapes": [p for p in want_p if got_p.get(p) != want_p[p]]
                 + [f"moment {p}" for p in want_m if got_m.get(p) != want_m[p]],
                 "kept": lay.kept, "failures": [], "pinned": 0, "flips": 0, "init_s": init_s,
                 "param_bytes": sum(t.numel() * t.element_size() for t in _tensors(lp)),
                 "moment_bytes": sum(t.numel() * t.element_size()
                                     for t in _tensors([state.m, state.v])),
                 "fsdp_split": len(lay.fsdp)}
    step = make_data_parallel_step(local, opt, layout, frozen_mask=lfrozen,
                                   compute_dtype=torch.float32)
    pin = None
    if lut:
        n_local = next((b.moe.gate.n_experts for _, b in getattr(local.cfg, "segments", ())
                        if b.kind == "moe"), 1)
        rec_c = torch.load(job["pin"], weights_only=False)
        pin = tpf_cut_pin(rec_c, lay, mesh, n_local)
        del rec_c
    for i in range(job["steps"]):
        batch = tpf_batch(bundle.arch, i, dev)
        mesh.reset_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        with contextlib.ExitStack() as stack:
            routes = stack.enter_context(tpf_routes())
            if lut:
                stack.enter_context(tpf_one_expert_chunks())
                rec = stack.enter_context(testing.table_hooks(lp, pin=pin, tie_eps=TIE_EPS,
                                                              digest_experts=True))
            (lp, state, met), wall = timed_step(dev, step, lp, state, batch)
        out["steps"].append({
            "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]), "wall": wall,
            "peak": torch.cuda.max_memory_allocated(dev),
            "coll": {a: dict(c) for a, c in mesh.axis_counters.items()}})
        if i == 0:
            n_moe = len(routes) // 2         # each MoE layer routes again in its recomputation
            out["routes"] = routes[:n_moe]
            # the model shards (an FSDP rank's data parts gathered over "data")
            trainable = layout.model_shards(
                tree_map_ref(lambda p, t: None if p in frozen_paths else t, lp))
            out["local_1"] = trainable
            # the whole leaves for rank (0, 0): its model group gathers them
            # (every rank, where experts are split over "data" too)
            if mesh.data_rank == 0 or lay.over_data:
                whole = layout.gather_model(trainable)
                if mesh.rank == 0:
                    out["whole_1"] = whole
                del whole
        if lut:
            out["failures"] += [f"rank {mesh.rank} {m}" for m in rec["off"]]
            out["pinned"] += rec["pinned"]
            out["flips"] += testing._rounding_flips(pin["rounding"], rec["rounding"],
                                                    f"rank {mesh.rank}", out["failures"])
            del rec
    if lut:     # whole moments: a stacked leaf's may be held in whole layers by their
        # data rank, a row site's codebooks are split over "model"; of a float32
        # model only the log_t's (the rest hold bf16 leaves, `tpf_hold`)
        bf16 = bundle.arch.param_dtype == "bfloat16"
        m = layout.gather_model(layout.gather(
            tree_map_ref(lambda p, t: t if bf16 or p.endswith("log_t") else None, state.m),
            lp))
        out["m_log_t"] = {p: [float(t) for t in ls] for p, ls in reference_leaves(m).items()
                          if p.endswith("log_t")}
        if mesh.rank == 0 and bf16:
            out["m_trainable"] = {p: ls for p, ls in reference_leaves(m).items()
                                  if ls[0].numel()}
        del m
    out["partial"] = len(lay.partial)
    out["launches"], out["plain"] = counters.launches(), counters.plain_calls()
    del state, step, pin
    torch.cuda.empty_cache()
    return out


def tpf_single(name: str, layers: int, mode: str, steps: int, dev) -> dict:
    """The single-rank steps of a job here, on the global batches: the
    params before them, the losses and
    times, the params after the first step, the leaf rule noted from its
    gradient, the routing decisions of the first step's forward; for
    soft-PQ the pin record and the log_t moments and terms."""
    from repro_torch import testing
    from repro_torch.optim import lut_frozen_mask
    from repro_torch.testing import AdamLeafRule
    from repro_torch.train.train_step import make_train_step
    from repro_torch.weights import reference_leaves, tree_map_ref

    bundle, opt = tpf_bundle(name, layers, mode)
    t0 = time.perf_counter()
    start = bundle.init(torch.Generator(device=dev).manual_seed(SEED + 50), device=dev)
    lut = mode == "lut_train"
    if lut:             # at the activations' scale, as k-means puts them
        tree_map_ref(lambda p, t: t.mul_(50.0) if p.endswith("centroids") else None, start)
    frozen = lut_frozen_mask(start) if lut else None
    init_s = time.perf_counter() - t0
    step = make_train_step(bundle, opt, frozen_mask=frozen, compute_dtype=torch.float32)
    out: dict = {"bundle": bundle, "opt": opt, "start": start, "frozen": frozen, "single": [],
                 "rule": AdamLeafRule(opt), "init_s": init_s}
    params, state = start, opt.init(start, frozen)
    for i in range(steps):
        batch = tpf_batch(bundle.arch, i, dev)
        m_old = state.m
        with contextlib.ExitStack() as stack:
            routes = stack.enter_context(tpf_routes())
            if lut:
                stack.enter_context(tpf_one_expert_chunks())
                rec = stack.enter_context(testing.table_hooks(start, digest_experts=True))
            (params, state, met), wall = timed_step(dev, step, params, state, batch)
        out["single"].append((float(met["loss"]), wall))
        out.setdefault("norm", float(met["grad_norm"]))
        if i == 0:
            out["rule"].note(tree_map_ref(lambda _p, m, m0: None if m.numel() == 0
                                          else m - opt.b1 * m0, state.m, m_old), TPF_LR)
            out["single_1"] = params
            out["routes"] = routes[:len(routes) // 2]
            if lut:
                out["pin"] = {"codes": rec["codes"],
                              "rounding": {k: v if isinstance(v[0], str)
                                           else tuple(t.detach() for t in v)
                                           for k, v in rec["rounding"].items()}}
                del rec
        del m_old
    if lut:
        out["m_log_t"] = {p: [float(t) for t in ls] for p, ls in
                          reference_leaves(state.m).items() if p.endswith("log_t")}
        if bundle.arch.param_dtype == "bfloat16":     # the bf16 leaves' holds
            out["m_trainable"] = {p: ls for p, ls in reference_leaves(state.m).items()
                                  if ls[0].numel()}
        with tpf_one_expert_chunks():
            out["terms"] = testing.lut_train_grads(bundle, start, tpf_batch(bundle.arch, 0, dev),
                                                   digest_experts=True)[3]
    del state, step, params
    return out


def tpf_free_frozen(s: dict, dev) -> None:
    """Free the job's frozen leaves here (a soft-PQ model's weights,
    arctic's ~27 GB of experts) before the ranks draw theirs: the steps
    leave them as they are, and the holds compare the trainable leaves."""
    import gc as pygc

    from repro_torch.weights import tree_map_ref

    if s["frozen"] is None:
        return
    before = torch.cuda.memory_allocated(dev)
    none = torch.zeros((), device=dev)
    for key in ("start", "single_1"):
        s[key] = tree_map_ref(lambda _p, t, fz: none if fz else t, s[key], s["frozen"])
    pygc.collect()
    torch.cuda.empty_cache()
    torch.cuda.ipc_collect()
    log(f"[tpf] the single rank's frozen leaves freed before the ranks draw theirs: "
        f"{(before - torch.cuda.memory_allocated(dev)) / 2**30:.2f} GiB; "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB left allocated, "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} reserved; the card {gpu_used_mib()} MiB "
        f"used")


def tpf_hold(label: str, s: dict, results: list, steps: int, dev) -> dict:
    """Phase 15's holds of one job's rank `results` against its single-rank
    steps `s`: the losses, the pins, the leaf rule after one step (a log_t
    by AdamW of its own gradient, that gradient by its terms), the
    replicas, the shapes, the routing; logs them and each rank's step
    lines."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import layout as tp_layout
    from repro_torch.weights import reference_leaves, tree_map_ref

    ranks = {tuple(r["rank"]): r for r in results}
    rules = ShardingRules(data=TPF_MESH[0], model=TPF_MESH[1])
    lay = tp_layout(s["bundle"], rules, train=True)
    opt = s["opt"]
    for r in ranks.values():
        check(not r["shapes"], f"{label}: rank {r['rank']}'s shards are not its cut: "
              f"{r['shapes'][:5]}")
        check(not r["failures"], f"{label}: " + "; ".join(r["failures"][:5]))
        check(len(r["steps"]) == steps, f"{label}: rank {r['rank']} ran {len(r['steps'])} "
              f"step(s), not {steps}")
        for i, ((loss, _), st) in enumerate(zip(s["single"][:steps], r["steps"])):
            got = st["loss"]
            check(abs(got - loss) <= TPT_LOSS_RTOL * abs(loss),
                  f"{label} step {i} rank {r['rank']}: loss {got!r}, single-rank {loss!r}")
        for j, (got, want) in enumerate(zip(r["routes"], s["routes"])):
            g = want.shape[0] // TPF_MESH[0]
            d = r["rank"][0]
            check(torch.equal(got.to(dev), want[d * g:(d + 1) * g]),
                  f"{label}: rank {r['rank']}'s routing of MoE layer {j} is not the single "
                  f"rank's")
        check(len(r["routes"]) == len(s["routes"]), f"{label}: MoE layers routed")
    # after one step: the trainable leaves gathered whole (the frozen, left
    # as they were and freed here, as the single rank's placeholders)
    got_1 = tree_map_ref(lambda _p, g, w: w if g is None else g.to(dev),
                         ranks[(0, 0)]["whole_1"], s["single_1"])
    n_log_t = 0
    if "terms" in s:
        start_l = reference_leaves(s["start"])
        for path, ls in reference_leaves(got_1).items():
            if not path.endswith("log_t"):
                continue
            for j, p1 in enumerate(ls):
                g_tp = ranks[(0, 0)]["m_log_t"][path][j] / (1 - opt.b1)
                g_1 = s["m_log_t"][path][j] / (1 - opt.b1)
                check(abs(g_tp - g_1) <= LOG_T_TERMS * max(s["terms"][path][j], 1e-30),
                      f"{label} {path}[{j}]: log_t gradient {g_tp!r} against {g_1!r} (terms "
                      f"{s['terms'][path][j]:.3g})")
                p0 = start_l[path][j]
                tree = {"site": {"log_t": p0}}
                want, _, _ = opt.update({"site": {"log_t": torch.full_like(p0, g_tp)}},
                                        opt.init(tree), tree)
                want = want["site"]["log_t"]
                ulp = torch.finfo(torch.float32).eps * float(want.abs())
                check(float((p1 - want).abs()) <= 1e-5 * float((want - p0).abs()) + 2 * ulp,
                      f"{label} {path}[{j}]: log_t after the step {float(p1)!r}, AdamW of its "
                      f"own gradient {float(want)!r}")
                n_log_t += 1
        got_1 = tree_map_ref(lambda p, g, w: w if p.endswith("log_t") else g, got_1,
                             s["single_1"])
    start_l = reference_leaves(s["start"])
    split16 = ({p for p in s.get("m_trainable", {})
                if p.endswith("centroids") or start_l[p][0].dtype == torch.bfloat16}
               if s["bundle"].arch.param_dtype == "bfloat16" else set())
    worst16, where16 = 0.0, ""
    for path, ls in reference_leaves(got_1).items():
        if path not in split16 or path.endswith("log_t"):
            continue
        for j, p1 in enumerate(ls):
            g_tp = ranks[(0, 0)]["m_trainable"][path][j].to(dev) / (1 - opt.b1)
            g_1 = s["m_trainable"][path][j] / (1 - opt.b1)
            gap = float((g_tp - g_1).abs().max() / g_1.abs().max().clamp_min(1e-30))
            if gap > worst16:
                worst16, where16 = gap, f"{path}[{j}]"
            check(gap <= BF16_GRAD, f"{label} {path}[{j}]: the gradient {gap:.3g} of its "
                  f"largest entry off the single rank's (bound {BF16_GRAD})")
            p0 = start_l[path][j]
            name = path.rsplit("/", 1)[1]
            tree = {"site": {name: p0}}
            want, _, _ = opt.update({"site": {name: g_tp}}, opt.init(tree), tree)
            want = want["site"][name].float()
            ulp = torch.finfo(p0.dtype).eps * want.abs()
            check(bool(((p1.float() - want).abs()
                        <= 1e-5 * (want - p0.float()).abs() + 2 * ulp).all()),
                  f"{label} {path}[{j}]: the leaf after the step is not AdamW of its own "
                  f"gradient")
    got_1 = tree_map_ref(lambda p, g, w: w if p in split16 else g, got_1, s["single_1"])
    worst, where = s["rule"].check(got_1, s["single_1"], s["start"])
    check(worst <= 1.0, f"{label}: params after one step off the single-rank step's: "
          f"{worst:.3g} of the bound at {where}")
    # replicas: the trainable leaves of each data row's model ranks, and of
    # each model column's data ranks but for the experts, which differ
    bad = []
    for (d, m), r in ranks.items():
        mine = reference_leaves(r["local_1"])
        for peer, which in (((1 - d, m), "data"), ((d, 1 - m), "model")):
            theirs = reference_leaves(ranks[peer]["local_1"])
            for path, ls in mine.items():
                if ls[0] is None or (which == "model" and path in lay.cuts) or \
                        (which == "data" and path in lay.over_data):
                    continue
                if not all(torch.equal(a, b) for a, b in zip(ls, theirs[path])):
                    bad.append(f"{(d, m)} vs {peer} ({which} group): {path}")
    check(not bad, f"{label} replicas differ: " + "; ".join(bad[:5]))
    pinned = sum(r["pinned"] for r in ranks.values())
    flips = sum(r["flips"] for r in ranks.values())
    r0 = ranks[(0, 0)]
    log(f"[tpf] {label}: losses {', '.join(f'{st['loss']:.7f}' for st in r0['steps'])} "
        f"(single-rank {', '.join(f'{l:.7f} ({w:.3f}s)' for l, w in s['single'])})"
        + (f", first grad norm {r0['steps'][0]['grad_norm']:.7g} (single-rank {s['norm']:.7g})"
           if opt.clip_norm is not None else ", unclipped") + "; after one "
        f"step every param leaf within {worst:.3f} of the leaf rule's bound ({where})"
        + (f", {n_log_t} log_t within {LOG_T_TERMS} of their terms and equal to AdamW of their "
           f"own gradient; codes taken from the single-rank step at a near-tie: {pinned} over "
           f"the 4 ranks; fake-quant entries one step off at a half-integer: {flips}"
           if "terms" in s else "")
        + (f"; under bf16 weights {len(split16)} leaves (the bf16 ones and the codebooks) "
           f"held by their gradient, within {worst16:.3g} of its largest entry (bound "
           f"{BF16_GRAD}; {where16}), and by AdamW of it" if split16 else "")
        + f"; replicas bytewise equal; shapes the cut (kept: {', '.join(r0['kept'])}); "
        f"{len(s['routes'])} MoE layer(s) routed as the single rank; {r0['partial']} partial "
        f"leaves or blocks summed over \"model\"")
    for (d, m), r in sorted(ranks.items()):
        log(f"[tpf] {label} rank ({d}, {m}): its part drawn in {r['init_s']:.2f}s "
            f"({r['param_bytes'] / 1e9:.2f} GB of params, {r['moment_bytes'] / 1e9:.2f} GB of "
            f"moments; {r['fsdp_split']} leaves over \"data\" too); " + "; ".join(
            f"step {i} {st['wall']:.3f}s, peak {st['peak'] / 2**30:.2f} GiB, "
            + tpt_coll_line(st["coll"]) for i, st in enumerate(r["steps"])))
        for i, st in enumerate(r["steps"]) if r["fsdp_split"] else ():
            c = st["coll"]["data"]
            for name in ("all_gather", "reduce_scatter"):
                log(f"[tpf] {label} rank ({d}, {m}) step {i}: data {name} {c[name]}x "
                    f"{c[name + '_bytes'] / 1e6:.1f} MB {1e3 * c[name + '_s']:.1f} ms")
    return {"steps": {k: r["steps"] for k, r in ranks.items()}, "worst": worst,
            "counts": [(r["launches"], r["plain"]) for r in ranks.values()]}


def phase_tp_train_families(dev, scratch: Path, started: dict) -> dict:
    """Tensor-parallel training of the MoE, SSM and hybrid families at
    (data, model) = (2, 2) in phase 14's four rank processes (`started`)
    on the one card over gloo (a card each over NCCL where the host has
    four). Each job of TPF_JOBS
    runs its single-rank steps here first on the same global batches and
    frees its frozen leaves; each rank then draws its part of the same
    init (`tensor_parallel.init_rank`: no rank holds a whole expert stack)
    and its steps are held against the single rank's (`tpf_hold`); the
    job's tensors are freed before the next. The soft-PQ pins go through a
    file, so that no large tensor is shared from here over CUDA IPC (whose
    memory phase 12 found still allocated after the ranks let go).
    Reads the kernel counts around the phase: no LUT kernel, no plain LUT
    version."""
    import gc as pygc

    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import backend_for

    counters.reset()
    world = TPF_MESH[0] * TPF_MESH[1]
    procs, q, jobs, devices, n_cards, t0 = (started[k] for k in ("procs", "q", "jobs", "devices",
                                                                 "cards", "t0"))
    backend = backend_for(devices)
    pin_path = scratch / "tpf_pin.pt"
    out: dict = {"jobs": {}, "fsdp_launches": {}}
    counts: list = []
    try:
        s, s_key = None, None
        for name, layers, mode, steps, fsdp in TPF_JOBS:
            label = (("phase 16 (b): " if name in PHASE16_ARCHS else "")
                     + f"{name} {mode} ({layers} layer{'s' if layers > 1 else ''}"
                     + (", FSDP)" if fsdp else ")"))
            t_job = time.perf_counter()
            after = (name, mode, fsdp) in TPF_SINGLE_AFTER

            def single():
                s = tpf_single(name, layers, mode, steps, dev)
                pygc.collect()
                torch.cuda.empty_cache()
                tpf_free_frozen(s, dev)
                return s

            if s_key != (name, layers, mode):     # an FSDP job reuses its model's single rank
                s = None
                if s_key is not None:
                    tpt_free(started)
                pygc.collect()
                s_key = (name, layers, mode)
                s = single()
            t_single = time.perf_counter() - t_job
            job = {"name": name, "layers": layers, "mode": mode, "steps": steps, "pin": None,
                   "fsdp": fsdp}
            if "pin" in s:
                job["pin"] = str(pin_path)
                torch.save(s.pop("pin"), pin_path)
            if after:          # run again once the ranks are done: the card is theirs
                s = None
                pygc.collect()
                torch.cuda.empty_cache()
            for jq in jobs:
                jq.put(job)
            got = wait_ranks(q, world, 600)
            errors = [val["trace"] for status, val in got if status != "ok"]
            check(not errors, f"a tp-train rank failed on {label}:\n" + "\n".join(errors))
            t_ranks = time.perf_counter() - t_job - t_single
            out["used_mib"] = max(out.get("used_mib", 0), gpu_used_mib())
            if s is None:                  # the single rank's steps, now the ranks' are done:
                # copies of their results here, and the ranks let go of theirs
                t0_single = time.perf_counter()
                got = [(st, map_tensors(val, torch.clone)) for st, val in got]
                pygc.collect()
                tpt_free(started)
                s = single()
                s.pop("pin", None)
                t_single += time.perf_counter() - t0_single
            # the ranks' tensors are IPC views of their memory: every reference
            # to them dies with `tpf_hold`'s frame, before the next job
            held = tpf_hold(label, s, [val for _, val in got], steps, dev)
            job_counts = held.pop("counts")
            counts += job_counts
            if fsdp:
                for ln, _ in job_counts:
                    for k, v in ln.items():
                        out["fsdp_launches"][k] = out["fsdp_launches"].get(k, 0) + v
                check(all(sum(ln.values()) == 0 and pc == 0 for ln, pc in job_counts),
                      f"phase 15's FSDP run reached a LUT kernel or a plain version: "
                      f"{job_counts}")
            held.update(single_s=t_single, ranks_s=t_ranks, init_s=s["init_s"])
            out["jobs"][label] = held
            log(f"[tpf] {label}: single-rank here {t_single:.1f}s (params built in "
                f"{s['init_s']:.1f}s), the ranks' parts, steps and results {t_ranks:.1f}s")
            if name in PHASE16_ARCHS:
                out["phase16_s"] = out.get("phase16_s", 0.0) + time.perf_counter() - t_job
            del got
            pygc.collect()
            torch.cuda.empty_cache()
            torch.cuda.ipc_collect()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    for jq in jobs:
        jq.put(None)
    stop_ranks(procs, True)
    check(all(p.exitcode == 0 for p in procs), f"tp-train ranks exited {[p.exitcode for p in procs]}")
    pin_path.unlink(missing_ok=True)
    log(f"[tpf] (data, model) = {TPF_MESH} on {n_cards} card(s): ranks on {devices}, backend "
        f"{backend}" + ("" if backend == "nccl" else " (four ranks share the card: NCCL is not "
                        "measured; the data all-to-all, the gathers and the all-max are "
                        "all-reduces of zero-padded buffers)")
        + f"; MarkovLM {TPT_BATCH} x {TPT_SEQ}; the card's used memory at most "
        f"{out['used_mib']} MiB with the ranks' results alive; {time.perf_counter() - t0:.1f}s "
        f"from the ranks' spawn in phase 14 to their exit")
    launches, plain_calls = counters.launches(), counters.plain_calls()
    check(all(sum(ln.values()) == 0 and pc == 0 for ln, pc in counts + [(launches, plain_calls)]),
          f"phase 15 reached a LUT kernel or a plain version: {counts}, {launches}, {plain_calls}")
    out["launches"] = {name: 0 for name in launches} | launches
    log("[tpf] no LUT kernel launched and no plain LUT version called, here or on a rank")
    log(f"[time] phase 16 (b): {out['phase16_s']:.1f}s of phase 15's (its jobs in the same "
        f"ranks)")
    out.update(backend=backend, cards=n_cards)
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets the fp32 matmul policy)

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    # a fresh autotune cache inside the scratch directory, and the measured warm-up
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(scratch / "autotune.json")
    os.environ["REPRO_AUTOTUNE_MEASURE"] = "1"
    def timed(n: int, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        log(f"[time] phase {n}: {time.perf_counter() - t0:.1f}s")
        return res

    try:
        card = timed(1, phase_card)
        kern = timed(2, phase_kernels, dev)
        timed(3, phase_slice_parity, dev, scratch)
        served = timed(4, phase_serve, dev, scratch)
        launches = served["launches"]
        timed(17, phase_dryrun, dev, served)
        refs = timed(5, phase_paged_spec, dev, scratch, served["art"], served["engine"])
        timed(6, phase_process, scratch, served["engine"], refs)
        tp = timed(11, phase_tp, dev, scratch)
        # phase 7 needs the card's memory and the scratch disk to itself
        del served, refs
        shutil.rmtree(scratch / "main", ignore_errors=True)
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        timed(7, phase_train, dev, scratch)
        gc.collect()
        torch.cuda.empty_cache()
        # phase 16 (a)'s ranks start beside phase 9, phase 12's beside phase
        # 8 (their interpreter, torch, CUDA context and mesh): those phases'
        # wall times are taken beside the ranks' start
        tpe_ranks = start_ranks(tpe_rank, tp_devices()[1])
        p9 = timed(9, phase_encdec_vlm, dev, scratch)
        gc.collect()
        torch.cuda.empty_cache()
        tpe = timed("16 (a)", phase_tp_encdec_vlm, dev, scratch, p9, tpe_ranks)
        del p9
        gc.collect()
        torch.cuda.empty_cache()
        trained = timed(10, phase_train_families, dev, scratch)
        gc.collect()
        torch.cuda.empty_cache()
        # phase 13 before 8 and 12: its three processes hold up to ~60 GB
        # at once, which arctic's params left by phase 12 would not leave free
        timed(13, phase_dp, dev, scratch)
        gc.collect()
        torch.cuda.empty_cache()
        tpt = timed(14, phase_tp_train, dev, scratch)
        gc.collect()
        torch.cuda.empty_cache()
        tpf = timed(15, phase_tp_train_families, dev, scratch, tpt.pop("ranks"))
        gc.collect()
        torch.cuda.empty_cache()
        # phases 8 and 12 last: arctic's params, shared with phase 12's rank
        # processes over CUDA IPC, stayed allocated here after the phase
        # (deleted, collected, `ipc_collect()`: 32.59 GiB before and after),
        # which phase 10's arctic step cannot spare
        tp12_ranks = start_ranks(tp_family_rank, tp_devices()[1])
        fam = timed(8, phase_families, dev, scratch)
        torch.cuda.empty_cache()
        tp12 = timed(12, phase_tp_families, scratch, fam, tp12_ranks)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    rows = []
    for name, src, replaces in (
        ("fused_decode", "src/repro_torch/kernels/csrc/fused_decode.cu",
         "src/repro/kernels/fused_decode.py:156"),
        ("lut_amm_v2", "src/repro_torch/kernels/csrc/lut_amm_v2.cu",
         "src/repro/kernels/lut_amm.py:183"),
        ("lut_amm_v1", "src/repro_torch/kernels/csrc/lut_amm_v1.cu",
         "src/repro/kernels/lut_amm.py:316"),
        ("encode", "src/repro_torch/kernels/csrc/encode.cu",
         "src/repro/kernels/dist_argmin.py:40"),
    ):
        k = kern[name]
        # no single PyTorch call computes a LUT-AMM or the encode's argmin over
        # expansion distances: library_ms is null
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name],
                     "phase_launches": {"4": launches[name],
                                        "10": trained["launches"][name],
                                        "11": tp["launches"][name],
                                        "12": tp12["launches"][name],
                                        "14": tpt["launches"].get(name, 0),
                                        "14_fsdp": tpt["fsdp"]["launches"].get(name, 0),
                                        "15": tpf["launches"].get(name, 0),
                                        "16": tpe["launches"].get(name, 0),
                                        "15_fsdp": tpf["fsdp_launches"].get(name, 0)},
                     "max_abs_err": k["err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None})
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
