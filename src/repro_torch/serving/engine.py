"""Slot-based continuous-batching serving engine, in PyTorch.

Counterpart of `repro.serving.engine.ServingEngine` for a dense KV cache: a
fixed pool of `n_slots` slots backed by batched caches, and the same
scheduler (DESIGN.md §6):

    queue --admit--> PREFILL --(prompt consumed)--> DECODE --(done)--> retired

* All admitted and still-prefilling slots share ONE padded
  `(n_slots, prefill_chunk)` forward per step; prompts longer than a chunk
  take one chunk per step, interleaved with the decode forward of the active
  slots. Every forward therefore has one of exactly two token shapes:
  N = n_slots * prefill_chunk and N = n_slots rows at each LUT site.
* The reference merges the new caches row by row with a select
  (`engine.py:415-424`). Here the forward writes the cache in place, and only
  the rows of the slots in that forward (`write_rows`): an idle or padded row
  never reaches another slot's cache. That holds for per-slot recurrent state
  too (the mamba "conv"/"ssm" leaves of the ssm and hybrid families), at
  prefill and at decode; each row's state stops at its last valid token
  (`write_len`), so mamba prompts need not be chunk-aligned, unlike the
  reference's (its engine.py:40-42; ROADMAP, known reference faults).
* Every request ends in a terminal status in {ok, timeout, cancelled, shed,
  error}; `run_until_done` raises rather than strand live work.

* Sampled requests (temperature > 0) draw as the reference does, with JAX's
  threefry bits reproduced in torch (serving/sampling.py): the same request
  samples the same tokens here and there, under any slot placement.
* With `autotune_lut` (the default), construction warms the kernel autotuner
  for every LUT kernel site at the engine's token shapes
  (`warm_lut_autotune`): on the card it times v1, v2 and the fused kernel when
  REPRO_AUTOTUNE_MEASURE=1, else the analytic model picks the version.
* Paged KV cache (DESIGN.md §12): with `paged=True` the caches become one
  pool of (n_pages, page_size) pages per segment shared by all slots; the
  scheduler owns the block tables, a refcounted page pool with prefix sharing
  (`serving/kv_pool.py`) and copy-on-write. Prompt prefixes already resident
  skip their prefill chunks; pool exhaustion sheds a request (status "shed"),
  never raises. Tokens equal the dense engine's. `kv_dtype` stores K/V in
  another dtype (by name, `KV_DTYPES`, fp8 included); attention upcasts at use.
* Speculative decoding (DESIGN.md §14): with `spec_decode=True` the width-1
  decode step becomes a draft/verify round (`serving/spec_decode.py`): up to
  gamma draft forwards, then one target forward of fixed shape
  (n_slots, gamma+1), a third token shape N = n_slots * (gamma+1). Tokens
  equal plain decode's, greedy and sampled; prefix sharing is turned off.

* Fault injection: a `faults.FaultInjector` passed as `faults=` is called at
  the top of every `step()` (latency spikes, transient errors, a simulated
  kill). `SPEC_KEYS`, `validate_spec`, `submit_from_spec` and `TokenTap` are
  the front ends' request format and token observer (serving/server.py,
  supervisor.py, router.py), as in the reference.

The engine feeds token ids only, as the reference's does, so it refuses
the two families that need other inputs (`engine_refusal`): the enc-dec
(whisper_tiny), whose encoder needs per-request frames, and the vision-LM
backbone (qwen2_vl_7b), which takes embeddings. Both are served through
`ModelBundle.forward_step`, which takes them.

Tensor parallelism (DESIGN.md §6.4): with `mesh=` (`launch/mesh.py`, one
process per rank, every rank building the engine with the same arguments)
each rank holds its shards of the params, placed by
`distributed.sharding.ShardingRules` (`distributed/tensor_parallel.py`), and
its KV heads of the cache. Rank 0 runs the scheduler: before each forward it
broadcasts the forward's token rows, positions, write lengths and page
table (and the step's copy-on-write page copies), and every other rank runs
the same forward from them (`follow`) until rank 0's `close()`. No other
rank makes a scheduling decision, so the ranks' collectives never diverge.
The logits are whole and identical on every rank; rank 0 samples. The
autotune warm-up covers the rank's site shapes: rank 0 tunes, then
broadcasts its records, so every rank launches the same kernels.
Speculative decoding does not compose with a mesh, as in the reference;
the families `tensor_parallel.tp_refusal` names wait for ROADMAP Queue A
item 5.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.configs import ModelBundle, cache_leaves
from repro_torch.core.amm import Mode
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune, measure
from repro_torch.models.attention import PagedSpec
from repro_torch.serving.kv_pool import KVPagePool
from repro_torch.serving.sampling import GREEDY, SamplingParams, batch_arrays, sample_tokens
from repro_torch.serving.spec_decode import SpecDecoder

STATUSES = ("ok", "timeout", "cancelled", "shed", "error")

# tensor-parallel control messages from rank 0: a header of _HEADER int64s
# (op, payload length, then the op's fields), then the payload
_HEADER = 6
_FORWARD, _COPY, _MARK, _STOP = 1, 2, 3, 4

# KV-cache storage dtypes by name; 1-byte entries store K/V in 8 bits and
# attention upcasts them at use (models/attention.py)
KV_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
POOL_LEAVES = ("k_pool", "v_pool")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _all_pool_leaves(specs) -> bool:
    """True when every cache tensor is a page-pool leaf: the whole cache
    state is position-indexed, which prefix sharing and speculative rollback
    need (per-slot recurrent state cannot be skipped or rewound)."""
    return all(name in POOL_LEAVES for name, _ in cache_leaves(specs))


def engine_refusal(arch) -> str | None:
    """Why the serving engine cannot serve `arch` (an ArchSpec), or None. Its
    requests are token ids and its batches carry nothing else, as the
    reference's (`repro/serving/engine.py`, whose step builds {"tokens",
    "cache_len"}): there an enc-dec model never runs its encoder and decodes
    against all-zero cross K/V, and a model that takes embeddings fails at
    its first forward. The port refuses both rather than copy either fault;
    per-request frames or embeddings would be a feature the reference
    lacks."""
    why = None
    if arch.family == "audio":
        why = ("the engine feeds token ids only, so it could not run the encoder on a "
               "request's audio frames (the reference engine decodes against all-zero cross "
               "K/V)")
    elif arch.takes_embeds:
        why = ("the engine feeds token ids only, so it could not give this model the "
               "embeddings it takes (the reference engine fails at its first forward)")
    if why is None:
        return None
    return (f"{arch.name} ({arch.family}) is not served by ServingEngine: {why}; drive it "
            f"through ModelBundle.forward_step with frames or embeds")


def lut_kernel_signatures(bundle: ModelBundle) -> list[tuple[int, int, int, int]]:
    """The distinct (M, C, K, V) of the bundle's LUT kernel sites, in site order."""
    sigs: dict[tuple[int, int, int, int], None] = {}
    for site in bundle.sites():
        if site.mode != Mode.LUT_INFER or site.lut is None or not site.lut.use_kernel:
            continue
        lut = site.lut
        sigs[(site.d_out, site.d_in // lut.v, lut.k, lut.v)] = None
    return list(sigs)


def warm_lut_autotune(bundle: ModelBundle, token_counts: list[int], dtype: str = "float32",
                      device: str | torch.device = "cuda",
                      signatures: list[tuple[int, int, int, int, str]] | None = None) -> int:
    """Tune the kernel version and launch of every (LUT site signature x
    token count); returns the number of lut_amm shapes tuned.

    `dtype` is the compute dtype the sites see (records are keyed on it) and
    `device` the engine's (it sets the key's backend). With
    REPRO_AUTOTUNE_MEASURE=1 every candidate of v1, v2 and the fused kernel
    is timed on the card (kernels/measure.py); without it the analytic model
    picks the version, at the wrappers' default launch. Measurement needs the
    card: on a CPU engine it raises.

    Precedence as in the reference: a measured record (from an earlier
    warm-up or an artifact's snapshot) is never re-derived; an analytic one
    is kept in analytic mode and re-tuned when measuring. `signatures`
    (M, C, K, V, dtype) replace the bundle's sites at `dtype` (a
    tensor-parallel rank's, `tensor_parallel.kernel_signatures`)."""
    backend = autotune.backend_for(device)
    measure_live = measure.measure_enabled()
    cache = autotune.get_cache()
    tuned = 0
    if signatures is None:
        signatures = [(*sig, dtype) for sig in lut_kernel_signatures(bundle)]
    for m, c, k, v, dtype in signatures:
        for n in token_counts:
            rec = cache.get(autotune.shape_key("lut_amm", n, m, c, k, v, dtype, backend))
            if rec is not None and (not measure_live or rec.get("measured")):
                continue
            fn = (measure.measure_lut_amm(n, m, c, k, v, dtype=dtype, device=device)
                  if measure_live else None)
            autotune.tune("lut_amm", n, m, c, k, v, dtype=dtype, backend=backend, cache=cache,
                          measure=fn, save=False)
            tuned += 1
    if tuned:
        try:
            cache.save()
        except OSError:
            pass          # the records stay in the process cache; serving goes on
    return tuned


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_tokens: int = 16
    eos_id: int | None = None
    sampling: SamplingParams = GREEDY
    priority: int = 0                  # higher = evicted later under overload
    deadline: float | None = None      # absolute time.monotonic() deadline
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "ok"
    n_prefilled: int = 0
    submit_t: float = 0.0
    finish_t: float = 0.0
    cancel_requested: bool = False
    spec_decode: bool | None = None   # per-request override; None = the engine's default

    @property
    def prefill_done(self) -> bool:
        return self.n_prefilled >= len(self.prompt)

    @property
    def ok(self) -> bool:
        return self.done and self.status == "ok"

    @property
    def latency_s(self) -> float:
        return max(self.finish_t - self.submit_t, 0.0) if self.done else 0.0

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class ServingEngine:
    def __init__(
        self,
        bundle: ModelBundle,
        params: Any,
        *,
        n_slots: int = 4,
        max_seq: int = 256,
        prefill_chunk: int = 32,
        compute_dtype: torch.dtype | str = torch.float32,
        kv_dtype: torch.dtype | str | None = None,
        max_queue: int | None = None,
        device: str | torch.device | None = None,
        autotune_lut: bool = True,
        paged: bool = False,
        page_size: int = 16,
        n_pages: int | None = None,
        prefix_sharing: bool = True,
        spec_decode: bool = False,
        draft_bundle: ModelBundle | None = None,
        draft_params: Any | None = None,
        spec_gamma: int = 4,
        mesh: Any | None = None,
        faults: Any | None = None,
    ):
        refusal = engine_refusal(bundle.arch)
        if refusal is not None:
            raise ValueError(refusal)
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1 (or None)")
        if not 1 <= prefill_chunk <= max_seq:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be in [1, max_seq={max_seq}]")
        self.mesh = mesh
        self._closed = False
        if mesh is not None:
            device = mesh.device if device is None else device
            if torch.device(device) != mesh.device:
                raise ValueError(f"device={device} but this rank's mesh device is {mesh.device}")
        self.device = resolve_device(device)
        if isinstance(compute_dtype, str):
            # by name, as kv_dtype: the front ends ship engine kwargs as JSON
            if compute_dtype not in COMPUTE_DTYPES:
                raise ValueError(f"compute_dtype={compute_dtype!r}: pick one of "
                                 f"{sorted(COMPUTE_DTYPES)}")
            compute_dtype = COMPUTE_DTYPES[compute_dtype]
        self.faults = faults
        self.bundle = bundle
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self._compute_dtype = compute_dtype
        # speculative decoding is resolved before the warm-up (its verify
        # shape is tuned too) and before the pool (it turns prefix sharing
        # off: a skipped chunk would leave the draft's cache without it)
        self.spec: SpecDecoder | None = None
        if (draft_bundle is None) != (draft_params is None):
            raise ValueError("draft_bundle and draft_params come together")
        self.rules = self.layout = None
        if mesh is not None:
            from repro_torch.distributed import tensor_parallel
            from repro_torch.distributed.sharding import ShardingRules

            if spec_decode:
                raise ValueError("spec_decode does not compose with mesh-sharded construction "
                                 "yet — the draft caches are host-managed")
            if mesh.data != 1:
                raise ValueError(f"a mesh of shape {mesh.shape}: only data=1 (tensor "
                                 f"parallelism) is served")
            self.rules = ShardingRules.for_mesh(mesh)
            bundle, params, self.layout = tensor_parallel.place(bundle, params, self.rules, mesh)
            self.bundle, self.params = bundle, params
        if spec_decode:
            if not _all_pool_leaves(bundle.cache_specs(n_slots, max_seq,
                                                       paged=PagedSpec(n_pages=2, page_size=16))):
                warnings.warn("spec_decode disabled: the bundle carries per-slot recurrent "
                              "state that cannot roll back rejected tokens; serving continues "
                              "non-speculatively")
                spec_decode = False
            else:
                prefix_sharing = False
        # the token shapes the engine issues: decode, a prefill chunk and,
        # speculating, the verify forward; the draft runs decode and prefill
        if autotune_lut and mesh is not None:
            self.n_lut_shapes_tuned = self._tp_warm_autotune(
                [n_slots, n_slots * prefill_chunk], autotune.dtype_name(compute_dtype))
        elif autotune_lut:
            dtype = autotune.dtype_name(compute_dtype)
            counts = [n_slots, n_slots * prefill_chunk]
            self.n_lut_shapes_tuned = warm_lut_autotune(
                bundle, counts + ([n_slots * (spec_gamma + 1)] if spec_decode else []),
                dtype=dtype, device=self.device)
            if spec_decode and draft_bundle is not None:
                self.n_lut_shapes_tuned += warm_lut_autotune(draft_bundle, counts, dtype=dtype,
                                                             device=self.device)
        else:
            self.n_lut_shapes_tuned = 0
        if isinstance(kv_dtype, str):
            if kv_dtype not in KV_DTYPES:
                raise ValueError(f"kv_dtype={kv_dtype!r}: pick one of {sorted(KV_DTYPES)}")
            kv_dtype = KV_DTYPES[kv_dtype]
        self.kv_dtype = compute_dtype if kv_dtype is None else kv_dtype

        # paged KV pool: the cache tensors become pools shared by all slots,
        # and the scheduler owns the block tables
        self.paged = bool(paged)
        paged_spec = None
        if self.paged:
            if max_seq % page_size:
                raise ValueError(f"page_size={page_size} must divide max_seq={max_seq} (the "
                                 f"block table covers exactly max_seq positions)")
            self.n_tables = max_seq // page_size
            if n_pages is None:
                # the dense engine's capacity, plus the garbage page
                n_pages = n_slots * self.n_tables + 1
            paged_spec = PagedSpec(n_pages=n_pages, page_size=page_size)
            # prefix sharing skips prefill chunks, sound only when the whole
            # cache state lives in the pool
            if prefix_sharing and not _all_pool_leaves(
                    bundle.cache_specs(n_slots, max_seq, dtype=self.kv_dtype, paged=paged_spec)):
                warnings.warn("prefix sharing disabled: the bundle carries per-slot recurrent "
                              "state that a skipped prefill chunk would leave uncomputed; paging "
                              "itself (block tables, copy-on-write, shedding) goes on")
                prefix_sharing = False
            self.pool = KVPagePool(n_pages, page_size, prefix_sharing=prefix_sharing)
            self.block_tables = np.zeros((n_slots, self.n_tables), np.int32)
            self.slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
            self._pending_copies: list[tuple[int, int]] = []
        self.caches = bundle.init_caches(n_slots, max_seq, dtype=self.kv_dtype, device=self.device,
                                         paged=paged_spec)
        if self.paged:
            # bytes of one page over all layers: the kv_bytes_* gauges
            self._page_bytes = sum(t.numel() * t.element_size()
                                   for name, t in cache_leaves(self.caches)
                                   if name in POOL_LEAVES) // n_pages
        self.cache_len = np.zeros((n_slots,), np.int32)
        self.slots: list[Request | None] = [None] * n_slots
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.max_queue = max_queue
        self._next_rid = 0
        self.reset_stats()
        if spec_decode:
            # no draft given: the target drafts for itself (acceptance ~1)
            self.spec = SpecDecoder(self, bundle if draft_bundle is None else draft_bundle,
                                    params if draft_params is None else draft_params,
                                    gamma=spec_gamma, kv_dtype=self.kv_dtype)

    # ------------------------------------------------------------------
    def reset_stats(self) -> None:
        self._counters = {
            "steps": 0,
            "prefill_forwards": 0,
            "prefill_tokens": 0,          # valid prompt tokens (padding excluded)
            "prefill_s": 0.0,
            "decode_forwards": 0,
            "decode_tokens": 0,
            "decode_s": 0.0,
            "shape_cache_hits": 0,        # forwards that reused a seen token shape
            "completed": 0,
            "timeout": 0,
            "cancelled": 0,
            "shed": 0,
            "error": 0,
            # prompt tokens served from the prefix cache (never forwarded)
            "prefill_tokens_skipped": 0,
        }
        self._shapes_seen: set[tuple[Any, ...]] = set()
        if self.paged:
            self.pool.reset_counters()
        if self.spec is not None:
            self.spec.reset_counters()

    def stats(self) -> dict[str, Any]:
        """Scheduler counters since construction / the last reset_stats()."""
        c = dict(self._counters)
        c["queue_depth"] = len(self.queue)
        c["active_slots"] = sum(s is not None for s in self.slots)
        dec_f = c["decode_forwards"]
        c["decode_occupancy"] = c["decode_tokens"] / (dec_f * self.n_slots) if dec_f else 0.0
        c["prefill_tok_s"] = c["prefill_tokens"] / c["prefill_s"] if c["prefill_s"] else 0.0
        c["decode_tok_s"] = c["decode_tokens"] / c["decode_s"] if c["decode_s"] else 0.0
        c["lut_shapes_tuned"] = self.n_lut_shapes_tuned
        if self.paged:
            pool = self.pool
            c["kv_pages_total"] = pool.n_allocatable
            c["kv_pages_free"] = pool.n_free
            c["kv_pages_cached"] = pool.n_cached
            c["kv_pages_shared"] = pool.n_shared
            c["kv_pages_resident"] = pool.n_resident
            c["kv_pages_peak"] = pool.peak_resident
            c.update(pool.counters)       # prefix_hits/lookups, cow_copies, ...
            c["kv_bytes_resident"] = pool.n_resident * self._page_bytes
            c["kv_bytes_peak"] = pool.peak_resident * self._page_bytes
            # what the dense per-slot layout would hold for the same tensors
            c["kv_bytes_dense_equiv"] = self._page_bytes * self.n_slots * self.n_tables
            c["pool_utilization"] = (pool.n_resident / pool.n_allocatable
                                     if pool.n_allocatable else 0.0)
        if self.spec is not None:
            c.update(self.spec.counters())
        return c

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run and discard one request that exercises the token shapes (a
        multi-chunk prefill and a decode forward; speculating, gamma + 2
        tokens make the first round draft at full depth and verify), then
        re-arm the counters."""
        wlen = (self.prefill_chunk + 1 if 2 * self.prefill_chunk <= self.max_seq
                else min(self.prefill_chunk, self.max_seq - 1))
        max_tok = 2 if self.spec is None else self.spec.gamma + 2
        self.submit(list(range(1, wlen + 1)), max_tokens=max_tok)
        self.run_until_done()
        self.finished.clear()
        self.reset_stats()

    def submit(self, prompt: list[int], *, max_tokens: int = 16, eos_id: int | None = None,
               sampling: SamplingParams | None = None, priority: int = 0,
               deadline_s: float | None = None, spec_decode: bool | None = None) -> int:
        """Queue a request; returns its rid. `deadline_s` is relative;
        `spec_decode=False` opts a request out of speculation (it rides the
        verify forward at depth 0), True needs a speculating engine."""
        prompt = list(prompt) or [0]
        padded = -(-len(prompt) // self.prefill_chunk) * self.prefill_chunk
        if padded > self.max_seq:
            raise ValueError(f"prompt of {len(prompt)} tokens (chunk-padded to {padded}) "
                             f"exceeds max_seq={self.max_seq}")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        if spec_decode and self.spec is None:
            raise ValueError("spec_decode=True requested but the engine was built without "
                             "speculative decoding (spec_decode=False or auto-disabled)")
        if self.paged:
            # capacity in pool pages: a prompt that could never hold its
            # pages, even alone, is refused here rather than shed forever
            ps = self.pool.page_size
            need = -(-len(prompt) // ps)
            if need > self.pool.n_allocatable:
                raise ValueError(f"prompt of {len(prompt)} tokens needs {need} pages; the pool "
                                 f"only has {self.pool.n_allocatable} allocatable pages of {ps} "
                                 f"(n_pages={self.pool.n_pages} incl. the reserved garbage page)")
            # decode writes positions len(prompt) .. len(prompt)+max_tokens-2
            cap = min(self.max_seq, self.pool.n_allocatable * ps)
            max_tokens = min(max_tokens, cap - len(prompt) + 1)
        else:
            max_tokens = min(max_tokens, self.max_seq - len(prompt) + 1)
        now = time.monotonic()
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_tokens, eos_id, sampling or GREEDY, priority=priority,
                      deadline=None if deadline_s is None else now + deadline_s,
                      spec_decode=spec_decode)
        req.submit_t = now
        # bounded queue: past the high-water mark shed the lowest priority,
        # the newest among ties (arrivals lose ties)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._sweep_queue(now)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            victim = min(reversed(self.queue), key=lambda r: r.priority)
            if victim.priority >= req.priority:
                self._finish(req, "shed")
                return rid
            self.queue.remove(victim)
            self._finish(victim, "shed")
        self.queue.append(req)
        return rid

    def cancel(self, rid: int) -> bool:
        """Retire a live request with status "cancelled"; False if unknown or done."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._finish(req, "cancelled")
                return True
        for i, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                req.cancel_requested = True
                self._retire(i, req, "cancelled")
                return True
        return False

    def _finish(self, req: Request, status: str) -> None:
        req.done = True
        req.status = status
        req.finish_t = time.monotonic()
        self._counters[status if status != "ok" else "completed"] += 1
        self.finished.append(req)

    def _sweep_queue(self, now: float) -> None:
        for req in [r for r in self.queue if r.expired(now)]:
            self.queue.remove(req)
            self._finish(req, "timeout")

    def _sweep(self) -> None:
        """Retire expired and cancelled requests before any forward this step."""
        now = time.monotonic()
        self._sweep_queue(now)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req.cancel_requested:
                self._retire(i, req, "cancelled")
            elif req.expired(now):
                self._retire(i, req, "timeout")

    def _admit(self) -> None:
        """Fill free slots from the queue, highest priority first (FIFO within
        a priority). Paged, the prompt's longest chain of cached full-page
        prefixes maps straight into the slot's block table and its tokens
        skip prefill; a fully cached prompt keeps its last token to forward
        (its logits give the first output token), whose write into the shared
        last page is a copy-on-write."""
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = max(self.queue, key=lambda r: (r.priority, -r.rid))
                self.queue.remove(req)
                self.slots[i] = req
                self.cache_len[i] = 0
                if self.spec is not None:
                    self.spec.reset_slot(i)
                if self.paged:
                    pages = self.pool.lookup_prefix(req.prompt)
                    shared = min(len(pages) * self.pool.page_size, len(req.prompt) - 1)
                    self.slot_pages[i] = pages
                    self.block_tables[i, :] = 0
                    self.block_tables[i, : len(pages)] = pages
                    req.n_prefilled = shared
                    self.cache_len[i] = shared
                    self._counters["prefill_tokens_skipped"] += shared

    def _retire(self, slot: int, req: Request, status: str = "ok") -> None:
        self._finish(req, status)
        self.slots[slot] = None
        self.cache_len[slot] = 0
        if self.spec is not None:
            self.spec.reset_slot(slot)
        if self.paged:
            for page in self.slot_pages[slot]:
                self.pool.unref(page)     # registered pages stay resident, evictable
            self.slot_pages[slot] = []
            self.block_tables[slot, :] = 0

    # ---------------- paged allocation (DESIGN.md §12.3) ----------------
    def _shed_for_pages(self, needy_slot: int) -> bool:
        """Free pages by retiring the lowest-priority active request (the
        newest among ties) as "shed". False when the victim was the needy
        request itself: the caller stops allocating for it."""
        live = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        vi, vr = min(live, key=lambda ir: (ir[1].priority, -ir[1].rid))
        self._retire(vi, vr, "shed")
        return vi != needy_slot

    def _alloc_page_for(self, slot: int) -> int | None:
        """One page for `slot`, shedding requests until one frees (`alloc`
        reclaims evictable prefix pages first). None only when the slot's
        own request was shed."""
        while True:
            page = self.pool.alloc()
            if page is not None:
                return page
            if not self._shed_for_pages(slot):
                return None

    def _prepare_slot_writes(self, slot: int, n_new: int) -> bool:
        """Make the slot's next `n_new` positions writable: extend its block
        table with fresh pages and copy-on-write every page in the range that
        another request or the prefix cache can see. False when the slot's
        request was shed while allocating."""
        ps = self.pool.page_size
        start = int(self.cache_len[slot])
        need = -(-(start + n_new) // ps)              # pages covering the write
        pages = self.slot_pages[slot]
        while len(pages) < need:
            page = self._alloc_page_for(slot)
            if page is None:
                return False
            self.block_tables[slot, len(pages)] = page
            pages.append(page)
        for pi in range(start // ps, need):
            if not self.pool.needs_cow(pages[pi]):
                continue
            dst = self._alloc_page_for(slot)
            if dst is None:
                return False
            # the device copy waits for _flush_copies; the bookkeeping moves now
            self._pending_copies.append((pages[pi], dst))
            self.pool.unref(pages[pi])
            pages[pi] = dst
            self.block_tables[slot, pi] = dst
            self.pool.counters["cow_copies"] += 1
        return True

    def _flush_copies(self) -> None:
        """Apply the step's pending copy-on-write page copies: one indexed
        copy per pool tensor, after one host-to-device copy of the ids."""
        if not self._pending_copies:
            return
        pairs, self._pending_copies = self._pending_copies, []
        if self.mesh is not None:
            self._tp_send(_COPY, (), np.asarray(pairs, np.int64).ravel())
        self._apply_copies(pairs)

    def _apply_copies(self, pairs: list[tuple[int, int]]) -> None:
        ids = torch.tensor(pairs, dtype=torch.long).to(self.device)
        src, dst = ids[:, 0], ids[:, 1]
        for name, t in cache_leaves(self.caches):
            if name in POOL_LEAVES:
                t[:, dst] = t[:, src]                     # (L, n_pages, page_size, KV, Dh)

    def _prepare_pages(self, rows: list[tuple[int, Request]], n_new) -> list[tuple[int, Request]]:
        """Pages for every row's next write (`n_new(slot, req)` positions),
        then the pending copies; preparing one slot can shed another, so the
        rows still owned by their request are returned."""
        for i, r in rows:
            if self.slots[i] is r:
                self._prepare_slot_writes(i, n_new(i, r))
        rows = [(i, r) for i, r in rows if self.slots[i] is r]
        self._flush_copies()
        return rows

    def _register_prefixes(self, slot: int, req: Request) -> None:
        """Publish the request's fully prefilled prompt pages to the prefix
        cache: K/V at a position depends only on the tokens up to it, so a
        page wholly covered by prompt tokens is fixed by the prefix that
        keys it."""
        ps = self.pool.page_size
        for pi in range(req.n_prefilled // ps):
            if (pi + 1) * ps > len(req.prompt):
                break
            self.pool.register_prefix(tuple(req.prompt[: (pi + 1) * ps]),
                                      self.slot_pages[slot][pi])

    def _record(self, tokens: np.ndarray, tag: str = "target") -> None:
        # keyed per model: the draft's first forward at a shape is its own
        shape = (tag, *tokens.shape)
        if shape in self._shapes_seen:
            self._counters["shape_cache_hits"] += 1
        self._shapes_seen.add(shape)

    def _sample(self, logits_rows: torch.Tensor) -> np.ndarray:
        """One token per slot row of (n_slots, V) logits; callers read only
        the rows of the slots they own. Greedy batches skip the sampler (it
        gives argmax for greedy rows anyway); a sampled row's counter is the
        number of tokens its request has already produced."""
        params = [r.sampling if r is not None else GREEDY for r in self.slots]
        if all(p.greedy for p in params):
            return torch.argmax(logits_rows, dim=-1).cpu().numpy()   # ties: lowest index
        counters = [len(r.out_tokens) if r is not None else 0 for r in self.slots]
        return sample_tokens(logits_rows, *batch_arrays(params, counters,
                                                        logits_rows.device)).cpu().numpy()

    def _check_done_after_token(self, slot: int, req: Request, tok: int) -> None:
        hit_eos = req.eos_id is not None and tok == req.eos_id
        out_of_cache = self.cache_len[slot] >= self.max_seq
        if hit_eos or len(req.out_tokens) >= req.max_tokens or out_of_cache:
            self._retire(slot, req)

    def _forward(self, toks: np.ndarray, cache_len: np.ndarray, write_len: np.ndarray,
                 model: tuple | None = None) -> torch.Tensor:
        """One row-masked forward of the target, or of `model` = (bundle,
        params, dense caches); returns its logits. Only rows with
        write_len > 0 may change the caches: a dense cache takes their whole
        slab (`write_rows`), the paged pool their first write_len positions
        (the rest land in the garbage page), recurrent state their first
        write_len positions."""
        paged = self.paged and model is None
        if self.mesh is not None and self.mesh.rank == 0:
            parts = [toks.ravel(), cache_len, write_len]
            self._tp_send(_FORWARD, (*toks.shape, int(paged)),
                          np.concatenate(parts + ([self.block_tables.ravel()] if paged else [])))
        bundle, params, caches = model or (self.bundle, self.params, self.caches)
        batch = {
            "tokens": torch.from_numpy(toks).to(self.device),
            # host tensors: the model plans its cache writes on the host
            "cache_len": torch.from_numpy(cache_len.astype(np.int64)),
        }
        batch["write_len"] = torch.from_numpy(write_len)
        if paged:
            batch["block_tables"] = torch.from_numpy(self.block_tables)
        else:
            batch["write_rows"] = torch.from_numpy(np.flatnonzero(write_len))
        with torch.inference_mode():
            logits, _ = bundle.forward_step(params, batch, caches,
                                            compute_dtype=self._compute_dtype,
                                            mesh=self.mesh if model is None else None)
        return logits

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _prefill_step(self) -> None:
        """One shared (n_slots, prefill_chunk) forward over the next chunk of
        every prefilling slot's prompt."""
        chunk = self.prefill_chunk
        pre = [(i, r) for i, r in enumerate(self.slots) if r is not None and not r.prefill_done]
        if self.paged and pre:
            pre = self._prepare_pages(pre, lambda i, r: min(chunk, len(r.prompt) - r.n_prefilled))
        if not pre:
            return
        toks = np.zeros((self.n_slots, chunk), np.int32)
        cache_len = np.zeros((self.n_slots,), np.int32)
        write_len = np.zeros((self.n_slots,), np.int32)
        for i, r in pre:
            part = r.prompt[r.n_prefilled: r.n_prefilled + chunk]
            toks[i, : len(part)] = part
            cache_len[i] = r.n_prefilled
            write_len[i] = len(part)
        t0 = time.perf_counter()
        logits = self._forward(toks, cache_len, write_len)
        self._sync()
        self._record(toks)
        self._counters["prefill_forwards"] += 1
        self._counters["prefill_tokens"] += int(write_len.sum())
        self._counters["prefill_s"] += time.perf_counter() - t0
        if self.spec is not None:
            # the draft's cache sees every prompt token: the same chunk, cursors and rows
            self.spec.mirror_prefill(toks, cache_len, write_len)

        # first output token of every slot whose prompt just completed, from
        # that slot's last valid position in this chunk
        last_idx = np.zeros((self.n_slots,), np.int64)
        finishing = []
        for i, r in pre:
            r.n_prefilled += int(write_len[i])
            self.cache_len[i] = r.n_prefilled
            if self.paged:
                self._register_prefixes(i, r)
            if r.prefill_done:
                last_idx[i] = write_len[i] - 1
                finishing.append((i, r))
        if not finishing:
            return
        rows = logits[torch.arange(self.n_slots, device=logits.device),
                      torch.from_numpy(last_idx).to(logits.device)]
        nxt = self._sample(rows)
        for i, r in finishing:
            tok = int(nxt[i])
            r.out_tokens.append(tok)
            self._check_done_after_token(i, r, tok)

    def _decode_step(self) -> None:
        """One (n_slots, 1) forward advancing every decode-phase slot."""
        dec = [(i, r) for i, r in enumerate(self.slots) if r is not None and r.prefill_done]
        if self.paged and dec:
            dec = self._prepare_pages(dec, lambda i, r: 1)
        if not dec:
            return
        toks = np.zeros((self.n_slots, 1), np.int32)
        write_len = np.zeros((self.n_slots,), np.int32)
        for i, r in dec:
            toks[i, 0] = r.out_tokens[-1] if r.out_tokens else r.prompt[-1]
            write_len[i] = 1
        t0 = time.perf_counter()
        logits = self._forward(toks, self.cache_len, write_len)
        self._sync()
        self._record(toks)
        self._counters["decode_forwards"] += 1
        self._counters["decode_tokens"] += len(dec)
        self._counters["decode_s"] += time.perf_counter() - t0

        nxt = self._sample(logits[:, 0, :])
        for i, r in dec:
            self.cache_len[i] += 1
            tok = int(nxt[i])
            r.out_tokens.append(tok)
            self._check_done_after_token(i, r, tok)

    def step(self) -> None:
        """One engine step: fault hook, lifecycle sweep, admit, one prefill
        chunk, one decode forward (speculating: one draft/verify round)."""
        if self.faults is not None:
            self.faults.on_step()        # may sleep, or raise Injected{Fault,Kill}
        self._counters["steps"] += 1
        self._sweep()
        self._admit()
        self._prefill_step()
        if self.spec is not None:
            self.spec.decode_round()
        else:
            self._decode_step()

    # ---------------- tensor parallelism: rank 0 leads, the others follow ----------------
    def _tp_send(self, op: int, fields: tuple[int, ...], payload: np.ndarray) -> None:
        head = np.zeros(_HEADER, np.int64)
        head[0], head[1] = op, payload.size
        head[2: 2 + len(fields)] = fields
        self.mesh.broadcast_ints(head, _HEADER)
        if payload.size:
            self.mesh.broadcast_ints(payload, payload.size)

    def _tp_warm_autotune(self, counts: list[int], dtype: str) -> int:
        """Rank 0 tunes every (rank site signature x token count) and
        broadcasts its records; every rank then holds them. Returns the
        number of shapes rank 0 tuned."""
        import json

        from repro_torch.distributed import tensor_parallel

        sigs = tensor_parallel.kernel_signatures(self.bundle, self.layout, dtype)
        cache = autotune.get_cache()
        tuned, payload = 0, None
        if self.mesh.rank == 0:
            tuned = warm_lut_autotune(self.bundle, counts, device=self.device, signatures=sigs)
            backend = autotune.backend_for(self.device)
            keys = [autotune.shape_key(kind, n, mm, c, k, v, dt, backend)
                    for m, c, k, v, dt in sigs for n in counts
                    for kind, mm in (("lut_amm", m), ("encode", 0))]
            payload = json.dumps({key: cache.get(key) for key in keys
                                  if cache.get(key) is not None}).encode()
        records = json.loads(self.mesh.broadcast_bytes(payload))
        if self.mesh.rank != 0:
            for key, rec in records.items():
                cache.put(key, rec)
        return tuned

    def tp_mark(self, code: int) -> None:
        """Rank 0: pass `code` to every follower's `on_mark` between forwards
        (e.g. to bracket a profiled window on every rank)."""
        if self.mesh is not None and self.mesh.rank == 0:
            self._tp_send(_MARK, (code,), np.zeros(0, np.int64))

    def follow(self, on_mark=None) -> dict[str, Any]:
        """A follower rank's loop: run every forward (and page copy) rank 0
        announces, until rank 0's `close()`. Returns the rank's counters:
        forwards by phase and their wall time (host, to the device's end)."""
        if self.mesh is None or self.mesh.rank == 0:
            raise RuntimeError("follow() runs on a tensor-parallel rank other than 0")
        st = {"prefill_forwards": 0, "prefill_s": 0.0, "decode_forwards": 0, "decode_s": 0.0,
              "copies": 0}
        while True:
            head = self.mesh.broadcast_ints(None, _HEADER)
            op, n = int(head[0]), int(head[1])
            body = self.mesh.broadcast_ints(None, n) if n else np.zeros(0, np.int64)
            if op == _STOP:
                return st
            if op == _MARK:
                if on_mark is not None:
                    on_mark(int(head[2]))
            elif op == _COPY:
                self._apply_copies([tuple(p) for p in body.reshape(-1, 2).tolist()])
                st["copies"] += 1
            elif op == _FORWARD:
                b, s, paged = (int(x) for x in head[2:5])
                toks = body[: b * s].reshape(b, s).astype(np.int32)
                cache_len = body[b * s: b * s + b].astype(np.int32)
                write_len = body[b * s + b: b * s + 2 * b].astype(np.int32)
                if paged:
                    self.block_tables[...] = body[b * s + 2 * b:].reshape(
                        self.block_tables.shape)
                t0 = time.perf_counter()
                self._forward(toks, cache_len, write_len)
                self._sync()
                phase = "decode" if s == 1 else "prefill"
                st[f"{phase}_forwards"] += 1
                st[f"{phase}_s"] += time.perf_counter() - t0
            else:
                raise RuntimeError(f"unknown tensor-parallel message {op}")

    def close(self) -> None:
        """Rank 0 of a tensor-parallel engine: release the followers (their
        `follow()` returns). A no-op elsewhere and when called again."""
        if self.mesh is not None and self.mesh.rank == 0 and not self._closed:
            self._closed = True
            self._tp_send(_STOP, (), np.zeros(0, np.int64))

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def run_until_done(self, max_steps: int = 1000, *,
                       on_exhausted: str = "raise") -> list[Request]:
        """Step until every request is terminal. Exhausting `max_steps` with
        live requests raises ("raise") or retires them as "error" ("strand")."""
        if on_exhausted not in ("raise", "strand"):
            raise ValueError(f"on_exhausted={on_exhausted!r}")
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        if self.has_work():
            stranded = [r.rid for r in self.queue] + [r.rid for r in self.slots if r is not None]
            if on_exhausted == "raise":
                raise RuntimeError(f"run_until_done exhausted max_steps={max_steps} with "
                                   f"{len(stranded)} request(s) still live: rids {stranded}")
            self.abort_all("error")
        return self.finished

    def abort_all(self, status: str = "error") -> list[Request]:
        """Retire every live request with `status`, without a forward."""
        aborted = []
        while self.queue:
            req = self.queue.popleft()
            self._finish(req, status)
            aborted.append(req)
        for i, req in enumerate(self.slots):
            if req is not None:
                self._retire(i, req, status)
                aborted.append(req)
        return aborted


# keys a front-end request spec may carry (HTTP body / supervisor wire format)
SPEC_KEYS = frozenset({
    "prompt", "max_tokens", "eos_id", "priority", "deadline_s",
    "temperature", "top_k", "top_p", "seed", "spec_decode",
})


def validate_spec(spec: dict[str, Any]) -> None:
    """Type-check a front-end request spec (SPEC_KEYS) without an engine, as
    the reference does: a malformed field is a ValueError at the door (HTTP
    400), never a worker crash after the pipe hop."""
    if not isinstance(spec, dict):
        raise ValueError("request spec must be a JSON object")
    unknown = set(spec) - SPEC_KEYS
    if unknown:
        raise ValueError(f"unknown request fields: {sorted(unknown)}")
    prompt = spec.get("prompt")
    if not isinstance(prompt, (list, tuple)) or not all(
            isinstance(t, int) and not isinstance(t, bool) for t in prompt):
        raise ValueError("prompt must be a list of ints")
    spec_decode = spec.get("spec_decode")
    if spec_decode is not None and not isinstance(spec_decode, bool):
        raise ValueError("spec_decode must be a bool")
    priority = spec.get("priority")
    if priority is not None and (isinstance(priority, bool) or not isinstance(priority, int)):
        raise ValueError(f"priority must be an int, got {priority!r}")
    deadline_s = spec.get("deadline_s")
    if deadline_s is not None and (isinstance(deadline_s, bool)
                                   or not isinstance(deadline_s, (int, float))):
        raise ValueError(f"deadline_s must be a number, got {deadline_s!r}")


def submit_from_spec(engine: ServingEngine, spec: dict[str, Any]) -> int:
    """Submit a front-end request spec (a JSON-safe dict, SPEC_KEYS) to an
    engine: the one format of the HTTP pump and the supervised worker."""
    validate_spec(spec)
    sampling = None
    if any(k in spec for k in ("temperature", "top_k", "top_p", "seed")):
        sampling = SamplingParams(
            temperature=float(spec.get("temperature", 0.0)),
            top_k=int(spec.get("top_k", 0)),
            top_p=float(spec.get("top_p", 1.0)),
            seed=int(spec.get("seed", 0)),
        )
    return engine.submit(
        list(spec["prompt"]),
        max_tokens=int(spec.get("max_tokens", 16)),
        eos_id=spec.get("eos_id"),
        sampling=sampling,
        priority=spec.get("priority") or 0,
        deadline_s=spec.get("deadline_s"),
        spec_decode=spec.get("spec_decode"),
    )


class TokenTap:
    """Incremental observer of an engine's token output. `poll()`, called
    after each `step()`, returns `(token_events, finished_requests)`:
    `token_events` lists `(rid, new_tokens)`, the last tokens of a request
    that retired this step included, before its entry in
    `finished_requests`. With `consume=True` reported entries leave
    `engine.finished`, so a long-running server's memory stays bounded."""

    def __init__(self, engine: ServingEngine, *, consume: bool = False):
        self.engine = engine
        self.consume = consume
        self._emitted: dict[int, int] = {}
        self._drained = 0                 # index into engine.finished

    def _new_tokens(self, req: Request) -> list[int]:
        seen = self._emitted.get(req.rid, 0)
        fresh = req.out_tokens[seen:]
        if fresh:
            self._emitted[req.rid] = seen + len(fresh)
        return fresh

    def poll(self) -> tuple[list[tuple[int, list[int]]], list[Request]]:
        tokens: list[tuple[int, list[int]]] = []
        fin = self.engine.finished
        done = fin[self._drained:]
        for req in done:
            fresh = self._new_tokens(req)
            if fresh:
                tokens.append((req.rid, fresh))
            self._emitted.pop(req.rid, None)
        if self.consume:
            del fin[self._drained:]
        else:
            self._drained = len(fin)
        for req in self.engine.slots:
            if req is None:
                continue
            fresh = self._new_tokens(req)
            if fresh:
                tokens.append((req.rid, fresh))
        return tokens, done
