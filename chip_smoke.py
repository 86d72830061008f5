#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase is skipped):
  1. the card: name and power limit, and a build of every CUDA kernel from
     the sources in this checkout, all nvcc processes at once;
  2. each kernel against its plain PyTorch version on the card: at the main
     path's shapes (qwen3_1p7b's LUT sites at N = 4 and N = 128), then on
     ragged shapes x 4 scale layouts x every activation x bias, in float32
     and bfloat16; with CUDA-event times of the kernel, its plain version,
     the dense matmul the site replaces (context only) and the byte bound;
  3. the slice at full width and reduced depth (2 layers): a prefill chunk
     and greedy decode steps on the card (kernels) and on the CPU (plain
     versions) from the same params; logits and tokens must agree except
     at and after a code the card picked otherwise or a near-tie;
  4. the main path: full-width 28-layer qwen3_1p7b in LUT_INFER mode served
     by ServingEngine on the card, with every kernel's launch count read
     around the run.
Prints a JSON line of per-kernel results, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
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
    host_us)."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)          # ~0.5 ms of device time
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


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


def bound_ms(n: int, c: int, k: int, v: int, m: int, x_bytes: int) -> tuple[float, str]:
    """Least time for one LUT-AMM call: each input read once and the output
    written once over HBM, against the encode's fp32 FMAs plus the lookup's
    N*C*M integer adds at the card's peaks."""
    nbytes = n * c * v * x_bytes + c * k * v * 4 + c * k * m + m * 4 + n * m * x_bytes
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 2 * n * c * k * v / FP32_FLOPS + n * c * m / INT8_OPS
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


def make_site(n, c, m, gen, dev, dtype=torch.float32, k=16, v=32):
    from repro_torch.core import quant

    x = torch.randn(n, c * v, generator=gen).to(dev, dtype)
    p = torch.randn(c, k, v, generator=gen).to(dev)
    qt = quant.quantize_table(torch.randn(c, k, m, generator=gen), m_shared=True)
    return x, p, qt.q.to(dev), qt.scale.to(dev)


def phase_kernels(dev) -> dict:
    from repro_torch.kernels import fused_decode as fused_mod
    from repro_torch.kernels import lut_amm as v2_mod
    from repro_torch.kernels import ref
    from repro_torch.testing import LAYOUTS, RAGGED, make_amm_inputs, quantize_np

    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)      # > 50 MB of L2
    results = {"fused_decode": {"err": 0.0}, "lut_amm_v2": {"err": 0.0}}
    log("[kernels] path shapes, m-shared scale, float32: median ms (L2 flushed)")
    log("  site     N    kernel        ms       plain_ms  bound_ms  dense_matmul_ms (context)  host_us")
    for n in (4, 128):
        for site, c, m in SITES:
            x, p, q, s = make_site(n, c, m, gen, dev)
            want = ref.fused_decode_plain(x, p, q, s)
            out2 = v2_mod.lut_amm_v2(x, p, q, s)
            torch.cuda.synchronize()
            err = compare(f"lut_amm_v2 {site} N={n}", out2, want, x, p, exact=True, rtol=0)
            results["lut_amm_v2"]["err"] = max(results["lut_amm_v2"]["err"], err)
            kernels = [("lut_amm_v2", v2_mod.lut_amm_v2)]
            if fused_mod.fits(c, 16, 32):
                out3 = fused_mod.fused_decode(x, p, q, s)
                torch.cuda.synchronize()
                err = compare(f"fused_decode {site} N={n}", out3, want, x, p, exact=True, rtol=0)
                results["fused_decode"]["err"] = max(results["fused_decode"]["err"], err)
                # both kernels run the same device encode: equal without exception
                check(torch.equal(out3, out2), f"fused != v2 bytewise at {site} N={n}")
                kernels.insert(0, ("fused_decode", fused_mod.fused_decode))
            w_dense = torch.randn(c * 32, m, generator=gen).to(dev)
            mm_ms = time_ms(lambda: x @ w_dense, flush)
            plain_ms = time_ms(lambda: ref.fused_decode_plain(x, p, q, s), flush)
            bms, by = bound_ms(n, c, 16, 32, m, 4)
            for name, fn in kernels:
                kms = time_ms(lambda: fn(x, p, q, s), flush)
                hus = host_us(lambda: fn(x, p, q, s))
                log(f"  {site:8s} {n:<4d} {name:12s} {kms:.5f}  {plain_ms:.5f}  {bms:.5f}  "
                    f"{mm_ms:.5f}                    {hus:.1f}")
                # the JSON row: each kernel at its main site, decode (N = 4)
                main_site = "down" if name == "lut_amm_v2" else "q/o"
                if n == 4 and site == main_site:
                    results[name].update(ms=kms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
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
                                         ("lut_amm_v2", v2_mod.lut_amm_v2)):
                            got = fn(x, p, q, s, bias=bias, act=act)
                            torch.cuda.synchronize()
                            # m-shared/scalar with exact epilogue math: bytewise;
                            # else fp32 sums reordered (and exp/tanh, bf16 ulps)
                            exact = s.shape[0] == 1 and act in ("none", "relu", "relu2")
                            rtol = 8e-3 if dtype == torch.bfloat16 else KERNEL_ATOL
                            compare(f"{name} {shape} {layout} {act} {dtype}", got, want, x, p,
                                    exact=exact, rtol=rtol)
                            ragged += 1
    log(f"[kernels] ragged sweep: {ragged} kernel calls agree with the plain versions")
    del flush
    return results


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


def phase_slice_parity(dev) -> dict:
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode

    arch = dataclasses.replace(get_arch("qwen3_1p7b"), n_layers=2, lut_use_kernel=True)
    bundle = build_model(arch, Mode.LUT_INFER)
    gen = torch.Generator().manual_seed(SEED)
    params_cpu = bundle.init(gen, device="cpu")
    for layer in params_cpu["segments"][1]:
        for site in (*layer["attn"].values(), *layer["mlp"].values()):
            if "centroids" in site:
                # centroids at the activations' scale, where k-means puts them
                site["centroids"].mul_(50.0)
    params_gpu = tree_to(params_cpu, dev)
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
                    check(err <= LOGIT_ATOL, f"logits differ by {err:.3g} at row {bi} "
                                             f"position {pos} without a near-tie")
                    max_err = max(max_err, err)
                    checked += 1
                    top2 = torch.topk(lc[bi, si], 2).values
                    if int(lg[bi, si].argmax()) == int(lc[bi, si].argmax()):
                        tok_equal += 1
                    else:
                        check((top2[0] - top2[1]).item() <= 2 * LOGIT_ATOL,
                              f"greedy token differs at row {bi} position {pos}")
                        tok_tie += 1
            cache_len += tokens.shape[1]
            tokens = lc[:, -1].argmax(-1).to(torch.int32)[:, None]   # teacher-forced greedy
    total = checked + excused
    log(f"[slice] 2-layer full-width qwen3_1p7b, card vs CPU over {1 + n_decode} forwards: "
        f"{checked}/{total} positions compared (max logit err {max_err:.3g}, tol {LOGIT_ATOL}), "
        f"{excused} at or after a code flip or near-tie; greedy tokens equal {tok_equal}, logit near-ties {tok_tie}")
    check(checked >= total // 2, "too few positions free of near-ties to show parity")
    return {"positions_checked": checked, "max_logit_err": max_err}


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def phase_serve(dev) -> dict:
    from repro_torch.configs import build_model, get_arch
    from repro_torch.core.amm import Mode
    from repro_torch.kernels import fused_decode as fused_mod
    from repro_torch.kernels import lut_amm as v2_mod
    from repro_torch.kernels import ref
    from repro_torch.serving.engine import ServingEngine

    arch = dataclasses.replace(get_arch("qwen3_1p7b"), lut_use_kernel=True)
    bundle = build_model(arch, Mode.LUT_INFER)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    log(f"[serve] {arch.name}: {arch.n_layers} layers, d_model {arch.d_model}, vocab {arch.vocab}, "
        f"{len(bundle.lut_sites())} LUT sites; init {time.perf_counter() - t0:.1f}s")
    eng = ServingEngine(bundle, params, n_slots=4, max_seq=256, prefill_chunk=32, device=dev)
    eng.warmup()
    gen = torch.Generator().manual_seed(SEED + 1)
    torch.cuda.reset_peak_memory_stats(dev)

    fused_mod.launches = v2_mod.launches = 0
    ref.calls.update(fused_decode_plain=0, lut_amm_v2_plain=0)
    t0 = time.perf_counter()
    rids = []
    for _ in range(8):
        plen = int(torch.randint(8, 61, (1,), generator=gen))
        prompt = torch.randint(0, arch.vocab, (plen,), generator=gen).tolist()
        rids.append(eng.submit(prompt, max_tokens=16))
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"fused_decode": fused_mod.launches, "lut_amm_v2": v2_mod.launches}
    plain_calls = sum(ref.calls.values())

    st = eng.stats()
    fwd = st["prefill_forwards"] + st["decode_forwards"]
    n_tok = sum(len(r.out_tokens) for r in done)
    log(f"[serve] {len(done)} requests, {n_tok} tokens in {wall:.3f}s ({n_tok / wall:.2f} tok/s); "
        f"prefill {st['prefill_tokens']} tok / {st['prefill_forwards']} fwd "
        f"({st['prefill_tok_s']:.2f} tok/s), decode {st['decode_tokens']} tok / "
        f"{st['decode_forwards']} fwd ({st['decode_tok_s']:.2f} tok/s); "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"[serve] launches over {fwd} forwards: fused_decode {counts['fused_decode']}, "
        f"lut_amm_v2 {counts['lut_amm_v2']}; plain-version calls {plain_calls}")
    check(sorted(r.rid for r in done) == sorted(rids), "not every request finished")
    check(all(r.status == "ok" for r in done), f"statuses {[r.status for r in done]}")
    check(all(len(r.out_tokens) == 16 and all(0 <= t < arch.vocab for t in r.out_tokens)
              for r in done), "every request must return 16 tokens in the vocab")
    check(counts["fused_decode"] >= 162 * fwd, "fused kernel launched fewer than 162 per forward")
    check(counts["lut_amm_v2"] >= 27 * fwd, "v2 kernel launched fewer than 27 per forward")
    check(plain_calls == 0, "the main path reached a plain version")
    profile_decode(eng, arch.vocab, gen)
    return counts


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
            key = ("fused_decode" if "fused_decode_kernel" in e.key
                   else "lut_amm_v2" if "lut_amm_v2_kernel" in e.key else "other")
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
    try:
        card = phase_card()
        kern = phase_kernels(dev)
        phase_slice_parity(dev)
        launches = phase_serve(dev)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    rows = []
    for name, src, replaces in (
        ("fused_decode", "src/repro_torch/kernels/csrc/fused_decode.cu",
         "src/repro/kernels/fused_decode.py:156"),
        ("lut_amm_v2", "src/repro_torch/kernels/csrc/lut_amm_v2.cu",
         "src/repro/kernels/lut_amm.py:183"),
    ):
        k = kern[name]
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
