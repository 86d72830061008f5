"""Helpers for holding the port against the reference: shared inputs made
with numpy from a seed, and the near-tie test that explains a differing code.

Used by tests/test_torch_*.py (which also import the JAX package) and by
chip_smoke.py; this module itself imports torch and numpy only.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core import pq, quant
from repro_torch.core.convert import site_params  # noqa: F401  (the tests' site lookup)

# (N, D, M, K, V): N and M ragged against the kernels' tiles, C ragged against
# their codebook chunks (the shapes of tests/test_fused_decode.py)
RAGGED = [
    (33, 64, 70, 16, 8),
    (100, 64, 130, 16, 32),
    (7, 96, 130, 8, 16),
    (65, 160, 48, 16, 32),
    (17, 96, 384, 16, 16),
]
# RAGGED and two shapes whose C (1 and 20) take the cluster sizes the ragged
# C (2..8) do not: the fused and v2 launches use clusters of min(16, C)
# rounded down to a power of two, so C = 5, 6 and 20 do not divide by theirs
CLUSTER_SHAPES = RAGGED + [(9, 32, 70, 16, 32), (33, 640, 144, 16, 32)]
LAYOUTS = ("per_codebook", "per_column", "m_shared", "scalar")
# (C, K, V, M): LUT sites past the kernels' first envelope (V = 64; K = 512,
# codes in two bytes; C = 128 at V = 8), and two K between 256 and 512 whose
# codebook's TMA ring stage splits into two equal boxes of 192 and 150 rows
# (at K = 300 only where a box's bytes stay 128-byte aligned, else the
# lookup gathers from global memory)
WIDE_SITES = [(32, 16, 64, 2048), (64, 512, 32, 2048), (128, 16, 8, 2048),
              (64, 384, 32, 2048), (64, 300, 32, 2048)]


def make_amm_inputs(n: int, d: int, m: int, k: int, v: int, seed: int):
    """x (N, D), centroids (C, K, V), real table (C, K, M), bias (M,): float32
    numpy arrays from one seed."""
    rng = np.random.default_rng(seed)
    c = d // v
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((c, k, v), dtype=np.float32),
            rng.standard_normal((c, k, m), dtype=np.float32),
            rng.standard_normal((m,), dtype=np.float32))


def quantize_np(table: np.ndarray, layout: str) -> tuple[np.ndarray, np.ndarray]:
    """(int8 table, fp32 scale) in one of LAYOUTS. "scalar" is one (1, 1, 1)
    scale over the whole table, the layout the kernels accept beside m-shared."""
    t = torch.from_numpy(table)
    if layout == "scalar":
        scale = torch.clamp(t.abs().amax().float(), min=1e-8).reshape(1, 1, 1) / 127.0
        q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
        return q.numpy(), scale.numpy()
    qt = quant.quantize_table(t, per_column=layout == "per_column",
                              m_shared=layout == "m_shared")
    return qt.q.numpy(), qt.scale.numpy()


def tie_gaps(x: torch.Tensor, centroids: torch.Tensor, codes_a: torch.Tensor,
             codes_b: torch.Tensor) -> torch.Tensor:
    """For every (n, c) where two encodings disagree, |d(a) - d(b)| / (1 + |d(a)|)
    with d the fp32 distances: how close the two choices were to a tie.
    Empty when the codes agree."""
    dists = pq.pairwise_sq_dists(pq.split_subvectors(x.float(), centroids.shape[-1]),
                                 centroids.float())
    codes_a = codes_a.long().to(dists.device)
    codes_b = codes_b.long().to(dists.device)
    diff = codes_a != codes_b
    da = dists.gather(-1, codes_a[..., None])[..., 0][diff]
    db = dists.gather(-1, codes_b[..., None])[..., 0][diff]
    return (da - db).abs() / (1.0 + da.abs())


def hold_lut_sites(bundle, params, records: dict, reference, *, tie_eps: float) -> dict:
    """Each LUT site of `bundle` held against the reference's on the inputs
    an activation tape recorded in one forward (`tape_capture().records`):
    the port's site (`common.linear`, the plain versions on the CPU) and
    `reference(spec, x)` -> (output, codes), numpy, the reference's site on
    the same input x (N, d_in). Where the two encoders' codes agree the
    outputs must be byte-equal (m-shared scales: exact int32 sums, one
    rounding); a code that differs must sit on a near-tie (`tie_gaps` <=
    tie_eps). Returns the counts {"sites", "rows", "codes_off"}."""
    from repro_torch.models.common import SiteCfg, linear

    out = {"sites": 0, "rows": 0, "codes_off": 0}
    for spec in bundle.lut_sites():
        x = torch.cat(records[spec.tape_key])
        p = site_params(params, spec)
        site = SiteCfg(d_in=spec.d_in, d_out=spec.d_out, mode=spec.mode, lut=spec.lut,
                       bias=spec.bias, name=spec.kind)
        got = linear(site, p, x).numpy()
        want, codes_ref = reference(spec, x.numpy())
        codes = pq.encode_indices(x, p["centroids"])
        codes_ref = torch.from_numpy(np.array(codes_ref)).to(codes.dtype)
        gaps = tie_gaps(x, p["centroids"], codes, codes_ref)
        if not bool((gaps <= tie_eps).all()):
            raise AssertionError(f"{spec.tape_key}: codes differ off a near-tie: {gaps}")
        same = (codes == codes_ref).all(dim=1).numpy()
        if got.shape != want.shape or got[same].tobytes() != np.asarray(want)[same].tobytes():
            raise AssertionError(f"{spec.tape_key}: outputs differ where the codes agree")
        out["sites"] += 1
        out["rows"] += x.shape[0]
        out["codes_off"] += int((codes != codes_ref).sum())
    return out


def grid_positions(b: int, n_text: int, rows: int, cols: int) -> np.ndarray:
    """(3, b, rows * cols + n_text) M-RoPE streams of an image of rows x cols
    patches followed by text, as Qwen2-VL numbers them: a patch at (r, c)
    has (t, h, w) = (0, r, c); text continues all three streams from the
    largest image position plus one."""
    r, c = np.divmod(np.arange(rows * cols), cols)
    start = max(rows, cols)
    text = np.arange(start, start + n_text)
    pos = np.stack([np.concatenate([np.zeros_like(r), text]),
                    np.concatenate([r, text]), np.concatenate([c, text])]).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, pos.shape[1])))


def family_batch(arch, b: int, s: int, *, seed: int, grid: tuple[int, int] = (2, 4),
                 scale: float = 1.0) -> dict[str, np.ndarray]:
    """A training batch of the arch's family, numpy, from one seed: "labels"
    (B, S) and "tokens" (B, S) int32; for the enc-dec also stub "frames"
    (B, enc_frames, D); for a model that takes embeddings "embeds" (B, S, D)
    instead of tokens (a grid of patch rows, then text rows) and "pos", the
    grid's (t, h, w) M-RoPE streams (`grid_positions`). Frames and
    embeddings are N(0, scale^2)."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, arch.vocab, (b, s)).astype(np.int32)}
    if arch.takes_embeds:
        out["embeds"] = rng.standard_normal((b, s, arch.d_model), dtype=np.float32) * scale
        out["pos"] = grid_positions(b, s - grid[0] * grid[1], *grid)
    else:
        out["tokens"] = rng.integers(0, arch.vocab, (b, s)).astype(np.int32)
    if arch.family == "audio":
        out["frames"] = rng.standard_normal((b, arch.enc_frames, arch.d_model),
                                            dtype=np.float32) * scale
    return out


def rows_near_tie(x: torch.Tensor, centroids: torch.Tensor, eps: float) -> torch.Tensor:
    """(N,) bool: rows whose best and second-best fp32 distance in some
    codebook are within eps * (1 + |best|): rows where an fp32 summation
    order other than the plain version's may pick another code."""
    dists = pq.pairwise_sq_dists(pq.split_subvectors(x.float(), centroids.shape[-1]),
                                 centroids.float())
    two = torch.topk(dists, 2, dim=-1, largest=False).values
    gap = (two[..., 1] - two[..., 0]) / (1.0 + two[..., 0].abs())
    return (gap <= eps).any(dim=-1)


# ---------------------------------------------------------------------------
# one LUT_TRAIN step on two devices
# ---------------------------------------------------------------------------

HALF_EPS = 1e-4     # |T/scale| this close to a half-integer may round either way
# One soft-PQ step's gradients, per leaf (`lut_train_step_parity`). Card
# against CPU: about WITNESS times the CPU fp32's largest gap from float64
# on qwen3_1p7b at full width, 2 layers, on an H100's host (1.34e-5 of a
# leaf's L2 norm, 7.86e-5 of its largest entry, both at LUT centroids,
# whose fp32 distance expansion cancels).
GRAD_L2 = 5e-5      # ||card - CPU||_2 / ||CPU||_2
GRAD_MAX = 3e-4     # max|card - CPU| / max|CPU|
WITNESS = 4.0       # the card's gap from float64 over the CPU fp32's
FLOOR_L2 = 1e-6     # the CPU's gap counted as at least this (L2) ...
FLOOR_MAX = 1e-5    # ... and this (largest entry)

@contextlib.contextmanager
def float64_compute():
    """While active, `Tensor.float()` leaves a float64 tensor in float64.

    The port's forward casts to fp32 where the reference computes in fp32
    (distances, norms, attention, the table, the loss). A float64 model run
    under this computes all of those in float64: the witness that a
    device's fp32 gradients are measured against. Rope's angle table stays
    fp32 (it is built from an fp32 frequency table), the same table the
    fp32 run on the CPU uses."""
    real = torch.Tensor.float

    def keep64(self, *args, **kw):
        return self if self.dtype == torch.float64 else real(self, *args, **kw)

    torch.Tensor.float = keep64
    try:
        yield
    finally:
        torch.Tensor.float = real


@contextlib.contextmanager
def table_hooks(params, *, pin: dict | None = None, terms: dict | None = None,
                tie_eps: float = 1e-6):
    """While active, every LUT_TRAIN forward over `params` (the tensors the
    model reads, or views of them) records, and yields in a dict:

    * "rounding", {(site path, layer, experts): (q, T / scale)}: the
      integers each fake-quantized table is rounded to and the quotients
      rounded; an expert site's tables are built per chunk of routed experts
      (`experts` the chunk's expert ids, None at the other sites);
    * "codes", {((site path, layer, experts), call): hard codes}: the codes
      of each straight-through encoding, `call` counting a site's encodings
      in this run (a recomputed block or chunk encodes again).

    `pin` (another run's record, the same model and batch) makes this run
    take that run's integers and codes where its own differ; "pinned"
    counts the codes taken and "off" lists each differing code that does
    not sit on a near-tie of this run's distances (relative gap > tie_eps).
    A quotient at a half-integer, or two distances within rounding, may go
    either way under another fp32 order; an entry or code taken the other
    way moves the forward by a whole table entry at every row that reads
    it, a difference of rounding far larger than the rounding of a sum.
    `terms`, when given, gathers per log_t (by id) the sum over (row,
    codebook, centroid) of |d loss / d dists * dists| in a backward."""
    from repro_torch.core import amm
    from repro_torch.models import moe
    from repro_torch.weights import tree_map_ref

    # a site's temperature leaf names it (its storage: a trainable view of
    # the leaf shares it)
    site_of: dict[int, tuple[str, int]] = {}
    layer_of: dict[str, int] = {}

    def name(path, t):
        if path.endswith("/log_t"):
            site = path[: -len("/log_t")]
            layer_of[site] = layer_of.get(site, -1) + 1
            site_of[t.data_ptr()] = (site, layer_of[site])

    tree_map_ref(name, params)
    rec: dict = {"rounding": {}, "codes": {}, "pinned": 0, "off": []}
    calls: dict[tuple, int] = {}
    current: list[torch.Tensor] = []
    chunk: list = [None]                 # the expert ids whose tables are being built
    real_temp, real_ste, real_fq = amm.temperature, pq.ste_encode, quant.fake_quant
    real_tables = moe._expert_tables_train

    def tables(p, s, experts):
        chunk[0] = tuple(experts.tolist())
        try:
            return real_tables(p, s, experts)
        finally:
            chunk[0] = None

    def temp(log_t, **kw):
        current.append(log_t)
        return real_temp(log_t, **kw)

    def key_now() -> tuple:
        return (*site_of[current[-1].data_ptr()], chunk[0])

    def ste(dists, t):
        if terms is not None and dists.requires_grad:
            tkey = id(current[-1])

            def hook(g):
                terms[tkey] = terms.get(tkey, 0.0) + float((g * dists).abs().sum())

            dists.register_hook(hook)
        out = real_ste(dists, t)
        site = key_now()
        n = calls.get(site, 0)
        calls[site] = n + 1
        own = torch.argmin(dists.detach(), dim=-1)
        rec["codes"][(site, n)] = own.to(torch.int16).cpu()
        if pin is not None:
            want = pin["codes"][(site, n)].to(own.device).long()
            diff = want != own
            if bool(diff.any()):
                d = dists.detach()
                d_own = d.gather(-1, own[..., None])[..., 0][diff]
                d_want = d.gather(-1, want[..., None])[..., 0][diff]
                gap = float(((d_want - d_own).abs() / (1.0 + d_own.abs())).max())
                if gap > tie_eps:
                    rec["off"].append(f"{site[0]}[{site[1]}]: a code differs off a near-tie "
                                      f"(relative gap {gap:.3g})")
                rec["pinned"] += int(diff.sum())
                k = dists.shape[-1]
                swap = (torch.nn.functional.one_hot(want, k) - torch.nn.functional.one_hot(own, k))
                out = out + swap.to(out.dtype)
        return out

    def fq(t, *, bits=8, per_column=False, m_shared=False):
        out = real_fq(t, bits=bits, per_column=per_column, m_shared=m_shared)
        key = key_now()                  # a recomputed block or expert chunk repeats a key
        scale = quant.table_scale(t, bits=bits, per_column=per_column, m_shared=m_shared)
        r = t.detach().float() / scale
        q = torch.clamp(torch.round(r), -quant._qmax(bits), quant._qmax(bits))
        rec["rounding"].setdefault(key, (q.to(torch.int16).cpu(), r.float().cpu()))
        if pin is not None:
            want = pin["rounding"][key][0].to(q.device, q.dtype)
            out = out + ((want - q) * scale).to(out.dtype)     # 0 where they agree
        return out

    amm.temperature, pq.ste_encode, quant.fake_quant = temp, ste, fq
    moe._expert_tables_train = tables
    try:
        yield rec
    finally:
        amm.temperature, pq.ste_encode, quant.fake_quant = real_temp, real_ste, real_fq
        moe._expert_tables_train = real_tables


def lut_train_grads(bundle, params, batch, *, compute_dtype=torch.float32, pin=None,
                    tie_eps: float = 1e-6):
    """One forward and backward of a LUT_TRAIN model: (loss, aux (the MoE
    load-balance value, in the loss at LM_AUX_WEIGHT), gradients in the
    params' layout with None at frozen leaves, log_t terms, record).

    * log_t terms, {reference path: [per-layer sum over (row, codebook,
      centroid) of |d loss / d dists * dists|]}: d loss / d log_t = -sum
      (d loss / d dists) * dists, whose terms cancel, so its fp32 rounding
      error scales with their magnitudes, not with itself;
    * record and `pin`: `table_hooks`'."""
    from repro_torch.optim import lut_frozen_mask
    from repro_torch.train.train_step import grads_tree, trainable_view
    from repro_torch.weights import tree_map_ref

    frozen = lut_frozen_mask(params)
    live, leaves = trainable_view(params, frozen)
    terms: dict[int, float] = {}
    with table_hooks(live, pin=pin, terms=terms, tie_eps=tie_eps) as rec:
        logits, aux = bundle.train_logits(live, batch, compute_dtype=compute_dtype)
        loss = bundle.loss_from_logits(logits, aux, batch["labels"])
        del logits
        grads = grads_tree(loss, leaves, params, frozen)

    log_t_terms: dict[str, list[float]] = {}
    tree_map_ref(lambda path, t: log_t_terms.setdefault(path, []).append(terms.get(id(t), 0.0))
                 if path.endswith("log_t") else None, live)
    return loss.detach(), aux.detach(), grads, log_t_terms, rec


def _rounding_flips(base: dict, other: dict, label: str, failures: list[str]) -> int:
    """Count the table entries `other` rounded to another integer than
    `base`; each must be one step off, at a quotient within HALF_EPS of a
    half-integer."""
    n = 0
    for key, (qb, r) in base.items():
        qo = other[key][0]
        off = qb != qo
        if not off.any():
            continue
        a = r.double().abs()
        frac = (a - a.floor() - 0.5).abs()
        step = (qb.int() - qo.int()).abs()
        if not ((step[off] == 1).all() and (frac[off] <= HALF_EPS).all()):
            failures.append(f"{label} {key[0]}[{key[1]}]: table entries rounded otherwise off a "
                            f"half-integer (worst {float(frac[off].max()):.3g})")
        n += int(off.sum())
    return n


def _rel(a: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """||a - ref||_2 / ||ref||_2 and max|a - ref| / max|ref|, in float64."""
    diff = a.double() - ref.double()
    return (float(diff.norm()) / max(float(ref.double().norm()), 1e-300),
            float(diff.abs().max()) / max(float(ref.double().abs().max()), 1e-300))


def batch_w(batch: dict) -> dict:
    """The batch of the float64 witness: its float inputs (frames,
    embeddings) in float64."""
    return {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}


def lut_train_step_parity(bundle, params, batch, dev, opt, *, tie_eps: float = 1e-6,
                          witness=None) -> dict:
    """One soft-PQ step of `bundle` (LUT_TRAIN, any family) from the same
    params and batch (CPU tensors, as `family_batch` gives them) on the CPU
    and on `dev`, held against each other and against the same step in
    float64 on `witness` (default the CPU; the card takes the float64 run,
    the gradients' comparisons and the update's off the host, whose memory
    traffic sets this harness's time at full width; the few fp32 constants
    the witness keeps, rope's frequencies and angles, are then the card's).
    Returns the counts and errors, with `failures` listing every check that
    failed.

    * codes: a hard code the card or float64 picks otherwise than the CPU
      must sit on a near-tie of that run's own distances (relative gap <=
      tie_eps); the run then takes the CPU's code (`table_hooks`' pin), as
      both choices are right and one flipped code moves every later value
      of its sequence by a table entry;
    * fake-quant: a table entry rounded to another integer must be one step
      off at a quotient within HALF_EPS of a half-integer; the card and
      float64 take the CPU's integers, as both roundings are right;
    * loss within 1e-4 relative, the MoE aux value within 1e-5;
    * gradients, per leaf: the card's and the CPU's fp32 gaps from float64
      are of one size (card <= WITNESS x CPU, each at least FLOOR_L2 /
      FLOOR_MAX), and card against CPU ||d||_2 <= GRAD_L2 ||CPU||_2 and
      max|d| <= GRAD_MAX max|CPU|. log_t: within 1e-6 of its terms'
      magnitudes;
    * the step (`train_step.make_train_step` with `opt`, the card's taking
      the CPU step's codes and integers): its loss metric and t_mean/t_min against the CPU's step
      (1e-5 relative), and its updated params against AdamW applied on the
      CPU to the card's own first moment (the card's update rule; its
      gradients are held above): within 1e-5 of each element's move and 2
      ulps of its value."""
    from repro_torch.optim import lut_frozen_mask
    from repro_torch.train.train_step import make_train_step
    from repro_torch.weights import reference_leaves, tree_map_ref

    wdev = torch.device("cpu" if witness is None else witness)
    params_d = tree_map_ref(lambda _p, t: t.to(dev), params)
    # moved, then widened on the witness's device
    params_w = tree_map_ref(lambda _p, t: t.to(wdev).double() if t.is_floating_point()
                            else t.to(wdev), params)
    batch_d = {k: v.to(dev) for k, v in batch.items()}
    failures: list[str] = []
    out = {"tokens": int(batch["labels"].numel())}

    loss_c, aux_c, g_c, terms, rec_c = lut_train_grads(bundle, params, batch)
    loss_d, aux_d, g_d, _, rec_d = lut_train_grads(bundle, params_d, batch_d, pin=rec_c,
                                                   tie_eps=tie_eps)
    with float64_compute():
        loss_w, aux_w, g_w, _, rec_w = lut_train_grads(bundle, params_w,
                                                       {k: v.to(wdev) for k, v in
                                                        batch_w(batch).items()},
                                                       compute_dtype=torch.float64, pin=rec_c,
                                                       tie_eps=tie_eps)
    for label, rec in (("card", rec_d), ("float64", rec_w)):
        failures += [f"{label} {msg}" for msg in rec["off"]]
    out["pinned_codes"] = {"card": rec_d["pinned"], "float64": rec_w["pinned"]}
    out["codes"] = sum(int(c.numel()) for c in rec_c["codes"].values())
    round_c, round_d, round_w = rec_c["rounding"], rec_d["rounding"], rec_w["rounding"]
    out["rounding_flips"] = {"card": _rounding_flips(round_c, round_d, "card", failures),
                             "float64": _rounding_flips(round_c, round_w, "float64", failures)}
    out["rounded_entries"] = sum(int(q.numel()) for q, _ in round_c.values())
    del rec_c, rec_d, rec_w, round_c, round_d, round_w
    out["loss_cpu"], out["loss_dev"], out["loss_f64"] = float(loss_c), float(loss_d), float(loss_w)
    out["aux_cpu"], out["aux_dev"], out["aux_f64"] = float(aux_c), float(aux_d), float(aux_w)
    if abs(float(loss_d) - float(loss_c)) > 1e-4 * abs(float(loss_c)):
        failures.append(f"loss {float(loss_d)} on the card, {float(loss_c)} on the CPU")
    # the MoE routing (its capacity drops included) is the same on both
    if abs(float(aux_d) - float(aux_c)) > 1e-5 * abs(float(aux_c)) + 1e-7:
        failures.append(f"aux {float(aux_d)} on the card, {float(aux_c)} on the CPU")
    errs: dict[str, dict[str, tuple[float, float]]] = {}
    log_t_errs = {"card_cpu": 0.0, "card_f64": 0.0, "cpu_f64": 0.0}
    n = 0
    dev_leaves, w_leaves = reference_leaves(g_d), reference_leaves(g_w)
    for path, leaves in reference_leaves(g_c).items():
        for j, (gc, gd, gw) in enumerate(zip(leaves, dev_leaves[path], w_leaves[path])):
            if gc is None:
                continue
            n += 1
            gc, gd = gc.to(wdev), gd.to(wdev)
            if path.endswith("log_t"):
                unit = max(terms[path][j], 1e-30)
                for key, (a, ref) in (("card_cpu", (gd, gc)), ("card_f64", (gd, gw)),
                                      ("cpu_f64", (gc, gw))):
                    log_t_errs[key] = max(log_t_errs[key],
                                          float((a.double() - ref.double()).abs()) / unit)
                if float((gd - gc).abs()) > 1e-6 * unit:
                    failures.append(f"{path}[{j}]: |delta| {float((gd - gc).abs()):.3g}, terms "
                                    f"{terms[path][j]:.3g}")
                continue
            e = {"card_cpu": _rel(gd, gc), "card_f64": _rel(gd, gw), "cpu_f64": _rel(gc, gw)}
            errs[f"{path}[{j}]"] = e
            (l2, mx), (wl2, wmx), (cl2, cmx) = e["card_cpu"], e["card_f64"], e["cpu_f64"]
            if l2 > GRAD_L2 or mx > GRAD_MAX:
                failures.append(f"{path}[{j}]: gradient differs from the CPU's by {l2:.3g} (L2) "
                                f"and {mx:.3g} (largest) of its own")
            if wl2 > WITNESS * max(cl2, FLOOR_L2) or wmx > WITNESS * max(cmx, FLOOR_MAX):
                failures.append(f"{path}[{j}]: the card's gap from float64 {wl2:.3g}/{wmx:.3g} "
                                f"(L2/largest) against the CPU's {cl2:.3g}/{cmx:.3g}")
    out.update(grad_leaves=n, grad_errs=errs, log_t_errs=log_t_errs)
    # the leaf lists hold the gradients too: the step below needs their room
    del g_c, g_d, g_w, params_w, dev_leaves, w_leaves, leaves, gc, gd, gw

    frozen = lut_frozen_mask(params)
    step = make_train_step(bundle, opt, frozen_mask=frozen, compute_dtype=torch.float32)
    with table_hooks(params) as rec_c:
        _, _, m_c = step(params, opt.init(params, frozen), batch)
    frozen_d = lut_frozen_mask(params_d)
    with table_hooks(params_d, pin=rec_c, tie_eps=tie_eps) as rec_d:
        new_d, st_d, m_d = step(params_d, opt.init(params_d, frozen_d), batch_d)
    failures += [f"card step {msg}" for msg in rec_d["off"]]
    del rec_c, rec_d
    for key in ("loss", "t_mean", "t_min"):
        if abs(float(m_d[key]) - float(m_c[key])) > 1e-5 * abs(float(m_c[key])) + 1e-6:
            failures.append(f"step metric {key}: {float(m_d[key])} vs {float(m_c[key])}")
    # the card's own (clipped) gradient, from its first moment m = (1 - b1) g
    g_eff = tree_map_ref(lambda _p, m, fz: None if fz else m.cpu() / (1 - opt.b1),
                         st_d.m, frozen)
    want, _, _ = dataclasses.replace(opt, clip_norm=None).update(
        g_eff, opt.init(params, frozen), params, frozen)
    old, exp_leaves = reference_leaves(params), reference_leaves(want)
    moved = 0
    for path, leaves in reference_leaves(new_d).items():
        for j, pd in enumerate(leaves):
            pe, po = exp_leaves[path][j].to(wdev), old[path][j].to(wdev)
            move = (pe - po).abs()
            ulp = torch.finfo(torch.float32).eps * pe.abs()       # p - lr * delta rounds
            if not ((pd.to(wdev) - pe).abs() <= 1e-5 * move + 2 * ulp + 1e-12).all():
                failures.append(f"{path}[{j}]: the card's AdamW update differs")
            moved += int((move > 0).sum())
    out.update(loss_step=float(m_d["loss"]), t_mean=float(m_d["t_mean"]),
               t_min=float(m_d["t_min"]), grad_norm=(float(m_d["grad_norm"]),
                                                     float(m_c["grad_norm"])),
               updated=moved, failures=failures)
    return out


# ---------------------------------------------------------------------------
# data-parallel training (tests/test_torch_dp.py, chip_smoke phase 13)
# ---------------------------------------------------------------------------

class AdamLeafRule:
    """tests/test_torch_train.py's rule for params that Adam moved from
    gradients known only to fp32 rounding, over several steps: Adam moves an
    element by about lr per step whatever its gradient, so an element whose
    gradient was below 1e-3 of its leaf's largest at some step (its
    direction not settled by the rounding) is held to 2 lr (times its
    group's lr scale) per step so far; every other element to 1e-5 of the
    leaf's largest entry or 1e-4 of its own move from `start` (the larger:
    a temperature at 100x lr moves by ~1 a step, and its gradient's fp32
    rounding with it); a frozen leaf (no gradient) exactly. `note` each
    step's reference gradients and learning rate, then `check`."""

    def __init__(self, opt):
        self.opt = opt
        self.ill: dict[tuple[str, int], torch.Tensor] = {}
        self.moves: dict[tuple[str, int], float] = {}

    def note(self, grads, lr: float) -> None:
        from repro_torch.weights import reference_leaves

        for path, leaves in reference_leaves(grads).items():
            for j, g in enumerate(leaves):
                if g is None:
                    continue
                a = g.detach().float().abs()
                ill = a < 1e-3 * a.max()
                key = (path, j)
                self.ill[key] = ill if key not in self.ill else self.ill[key] | ill
                self.moves[key] = (self.moves.get(key, 0.0)
                                   + 2 * lr * self.opt._rule(path).lr_scale)

    def check(self, got, want, start) -> tuple[float, str]:
        """(the worst error over its bound across every param leaf, that
        leaf): at most 1 holds the rule. `start`: the params before the
        first step."""
        from repro_torch.weights import reference_leaves

        worst, where = 0.0, ""
        wants, starts = reference_leaves(want), reference_leaves(start)
        for path, leaves in reference_leaves(got).items():
            for j, g in enumerate(leaves):
                w = wants[path][j].float()
                err = (g.float() - w).abs()
                key = (path, j)
                if key not in self.ill:                   # frozen: exact
                    r = float("inf") if bool((err > 0).any()) else 0.0
                else:
                    ill = self.ill[key]
                    well_bound = torch.maximum(
                        1e-4 * (w - starts[path][j].float()).abs(),
                        torch.full_like(w, 1e-5 * float(w.abs().max()))).clamp_min(1e-30)
                    r = float((err / well_bound)[~ill].max()) if bool((~ill).any()) else 0.0
                    if bool(ill.any()):
                        r = max(r, float(err[ill].max()) / self.moves[key])
                if r > worst:
                    worst, where = r, f"{path}[{j}]"
        return worst, where


def one_step_off(got: torch.Tensor, want: torch.Tensor, n: int) -> tuple[int, float]:
    """A compressed mean `got` against `want` (its plain version, or the
    reference's): (the elements that differ, the worst of their differences
    over one step of their chunk's final scale, max|chunk| / 127). A
    requantization tie that a 1-ulp difference of the chunk's fp32 sum
    flips moves an element by one step; at most 1 is that. A vector whose
    length does not divide by `n` is taken zero-padded, as the reduce pads it."""
    pad = (-got.numel()) % n                 # the zeros the reduce padded with
    g, w = (torch.nn.functional.pad(t.reshape(-1).float(), (0, pad)).reshape(n, -1)
            for t in (got, want))
    step = w.abs().amax(1, keepdim=True) / 127
    off = g != w
    if not bool(off.any()):
        return 0, 0.0
    ratio = ((g - w).abs() / step.clamp_min(1e-30)).expand_as(g)[off]
    return int(off.sum()), float(ratio.max())


def witness_ratio(got, ref32, exact, start=None) -> tuple[float, str]:
    """Two fp32 runs against a float64 one: the worst, over the leaves of
    `exact`, of `got`'s L2 gap from it over `ref32`'s (counted as at least
    FLOOR_L2), both as a fraction of the leaf's L2 move from `start` (else
    of the leaf): at most WITNESS says that `got` is no further from exact
    than `ref32`'s rounding explains. Not the largest entry: an element
    whose exact gradient is ~0 takes Adam's step by the sign of its fp32
    rounding, in either run, so two runs' single worst elements differ
    several-fold where their L2 gaps agree (the leaf rule of one step,
    `AdamLeafRule`, exempts such elements likewise). Returns (that ratio,
    its leaf with both runs' gaps, L2 / largest entry, as fractions of the
    move)."""
    from repro_torch.weights import reference_leaves

    gl, rl, el = reference_leaves(got), reference_leaves(ref32), reference_leaves(exact)
    sl = reference_leaves(start) if start is not None else None
    worst, where = 0.0, ""
    for path, leaves in el.items():
        for j, e in enumerate(leaves):
            if e.numel() == 0:
                continue
            e = e.double()
            base = e - sl[path][j].double() if sl is not None else e
            scale = (max(float(base.norm()), 1e-300), max(float(base.abs().max()), 1e-300))

            def gap(a):
                d = a.double() - e
                return float(d.norm()) / scale[0], float(d.abs().max()) / scale[1]

            (g2, gm), (r2, rm) = gap(gl[path][j]), gap(rl[path][j])
            r = g2 / max(r2, FLOOR_L2)
            if r > worst:
                worst, where = r, (f"{path}[{j}]: gap {g2:.3g} / {gm:.3g}, the fp32 "
                                   f"reference's {r2:.3g} / {rm:.3g}")
    return worst, where
