#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase is skipped):
  1. the card: name and power limit, and a build of every CUDA kernel from
     the sources in this checkout, all nvcc processes at once;
  2. each kernel against its plain PyTorch version on the card: at the main
     path's shapes (qwen3_1p7b's LUT sites at N = 4 and N = 128), then every
     kernel under every launch the tuner can choose there (rows per N tile
     and M tile, v1's chunk of the sum, the encode's rows and codebooks per
     block; fused == v2 == plain and v1 == plain bytewise), then on ragged
     shapes x 4 scale layouts (x every activation x bias for the fused and
     v2 kernels, and x every N tile on shapes whose C take every cluster
     size, v1 with 3 chunks of the sum and the encode under its launches),
     in float32 and bfloat16; with CUDA-event times of the kernel and its
     plain version, the event floor (a 1-element kernel timed the same way),
     the host's enqueue time, the dense matmul the site replaces (context
     only) and the least time the card could take;
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
     choices timed against the measured records.
Prints a JSON line of per-kernel results, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
TIE_EPS = 1e-6          # relative fp32 distance gap: rounding order may flip a code
KERNEL_ATOL = 1e-4      # fp32 per-codebook / per-column sums in another order
LOGIT_ATOL = 1e-3       # full-model logits, card vs CPU, at positions without a tie
HBM_BYTES_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
INT8_OPS = 1979e12      # H100 SXM int8
# qwen3_1p7b LUT sites at lut_v = 32: (name, C, M)
SITES = [("q/o", 64, 2048), ("k/v", 64, 1024), ("gate/up", 64, 6144), ("down", 192, 2048)]


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
    once over HBM, against the operations at the card's peaks. LUT-AMM: the
    encode's fp32 FMAs plus the lookup's N*C*M integer adds (v1: an fp32
    multiply and add per gathered entry instead); encode: the fp32 FMAs
    and N*C int32 codes out."""
    if kernel == "encode":
        nbytes = n * c * v * x_bytes + c * k * v * 4 + n * c * 4
        t_ops = 2 * n * c * k * v / FP32_FLOPS
    else:
        nbytes = n * c * v * x_bytes + c * k * v * 4 + c * k * m + m * 4 + n * m * x_bytes
        lookup = (2 * n * c * m / FP32_FLOPS if kernel == "lut_amm_v1"
                  else n * c * m / INT8_OPS)
        t_ops = 2 * n * c * k * v / FP32_FLOPS + lookup
    t_bytes = nbytes / HBM_BYTES_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


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
    for n in (4, 128):
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
    for n in (4, 128):
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


def serve_burst(eng, vocab: int) -> tuple[list, dict]:
    """8 requests (prompts 8-60 tokens, 16 new tokens each), the same on
    every call; requests SAMPLED draw at temperature 0.8, top-k 50, top-p 0.9."""
    from repro_torch.serving.sampling import SamplingParams

    gen = torch.Generator().manual_seed(SEED + 1)
    eng.finished.clear()
    eng.reset_stats()
    rids = []
    t0 = time.perf_counter()
    for i in range(8):
        plen = int(torch.randint(8, 61, (1,), generator=gen))
        prompt = torch.randint(0, vocab, (plen,), generator=gen).tolist()
        sampling = (SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=SEED + i)
                    if i in SAMPLED else None)
        rids.append(eng.submit(prompt, max_tokens=16, sampling=sampling))
    done = {r.rid: r for r in eng.run_until_done()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(sorted(done) == sorted(rids), "not every request finished")
    reqs = [done[rid] for rid in rids]
    check(all(r.status == "ok" for r in reqs), f"statuses {[r.status for r in reqs]}")
    check(all(len(r.out_tokens) == 16 and all(0 <= t < vocab for t in r.out_tokens)
              for r in reqs), "every request must return 16 tokens in the vocab")
    return [r.out_tokens for r in reqs], dict(eng.stats(), wall=wall)


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
    runs = [serve_burst(eng, arch.vocab) for _ in range(2)]
    total = counters.launches()
    served = {k: total[k] - before[k] for k in total}
    for i, (_, st) in enumerate(runs):
        n_tok = sum(len(t) for t in runs[i][0])
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
    (tok1, _), (tok2, _) = runs
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
    profile_decode(eng, arch.vocab, torch.Generator().manual_seed(SEED + 2))
    shutil.rmtree(scratch / "main")
    return {"launches": total, "served": served}


def profile_decode(eng, vocab: int, gen: torch.Generator, n_steps: int = 8) -> None:
    """Where a decode forward's time goes: torch.profiler's device kernel time
    over a few decode steps of full slots, against their wall time."""
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
    by_kernel: dict[str, float] = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0:
            key = next((k for k in ("fused_decode", "lut_amm_v2", "lut_amm_v1", "encode")
                        if f"{k}_kernel" in e.key), "other")
            by_kernel[key] = by_kernel.get(key, 0.0) + t
    busy = sum(by_kernel.values())
    log(f"[profile] {n_steps} decode steps (n_slots={eng.n_slots}): wall {wall_us / n_steps:.0f} us "
        f"per step (profiler on), device busy {busy / n_steps:.0f} us per step "
        f"({100 * busy / wall_us:.1f}% of wall); device time: "
        + ", ".join(f"{k} {v / n_steps:.0f} us" for k, v in sorted(by_kernel.items())))


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
    try:
        card = phase_card()
        kern = phase_kernels(dev)
        phase_slice_parity(dev, scratch)
        launches = phase_serve(dev, scratch)["launches"]
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
                     "launches": launches[name], "max_abs_err": k["err"], "ms": k["ms"],
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
