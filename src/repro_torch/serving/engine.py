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
  never reaches another slot's cache.
* Every request ends in a terminal status in {ok, timeout, cancelled, shed,
  error}; `run_until_done` raises rather than strand live work.

* Sampled requests (temperature > 0) draw as the reference does, with JAX's
  threefry bits reproduced in torch (serving/sampling.py): the same request
  samples the same tokens here and there, under any slot placement.
* With `autotune_lut` (the default), construction warms the kernel autotuner
  for every LUT kernel site at the engine's two token shapes
  (`warm_lut_autotune`): on the card it times v1, v2 and the fused kernel when
  REPRO_AUTOTUNE_MEASURE=1, else the analytic model picks the version.

Paged caches, speculative decoding, mesh sharding and fault injection are not
ported yet (ROADMAP Queue A items 7-9).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.configs import ModelBundle
from repro_torch.core.amm import Mode
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune, measure
from repro_torch.serving.sampling import GREEDY, SamplingParams, batch_arrays, sample_tokens

STATUSES = ("ok", "timeout", "cancelled", "shed", "error")


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
                      device: str | torch.device = "cuda") -> int:
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
    is kept in analytic mode and re-tuned when measuring."""
    backend = autotune.backend_for(device)
    measure_live = measure.measure_enabled()
    cache = autotune.get_cache()
    tuned = 0
    for m, c, k, v in lut_kernel_signatures(bundle):
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
        compute_dtype: torch.dtype = torch.float32,
        kv_dtype: torch.dtype | None = None,
        max_queue: int | None = None,
        device: str | torch.device | None = None,
        autotune_lut: bool = True,
        paged: bool = False,
        spec_decode: bool = False,
        mesh: Any | None = None,
        faults: Any | None = None,
    ):
        if paged or spec_decode or mesh is not None or faults is not None:
            raise NotImplementedError("paged KV, speculative decoding, mesh sharding and fault "
                                      "injection are not ported yet: ROADMAP Queue A items 7-9")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1 (or None)")
        if not 1 <= prefill_chunk <= max_seq:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be in [1, max_seq={max_seq}]")
        self.device = resolve_device(device)
        self.bundle = bundle
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self._compute_dtype = compute_dtype
        self.kv_dtype = compute_dtype if kv_dtype is None else kv_dtype
        # the engine issues exactly two token shapes: decode and a prefill chunk
        self.n_lut_shapes_tuned = (
            warm_lut_autotune(bundle, [n_slots, n_slots * prefill_chunk],
                              dtype=autotune.dtype_name(compute_dtype),
                              device=self.device)
            if autotune_lut else 0)
        self.caches = bundle.init_caches(n_slots, max_seq, dtype=self.kv_dtype, device=self.device)
        self.cache_len = np.zeros((n_slots,), np.int32)
        self.slots: list[Request | None] = [None] * n_slots
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.max_queue = max_queue
        self._next_rid = 0
        self.reset_stats()

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
        }
        self._shapes_seen: set[tuple[int, ...]] = set()

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
        return c

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run and discard one request that exercises both token shapes (a
        multi-chunk prefill and a decode forward), then re-arm the counters."""
        wlen = (self.prefill_chunk + 1 if 2 * self.prefill_chunk <= self.max_seq
                else min(self.prefill_chunk, self.max_seq - 1))
        self.submit(list(range(1, wlen + 1)), max_tokens=2)
        self.run_until_done()
        self.finished.clear()
        self.reset_stats()

    def submit(self, prompt: list[int], *, max_tokens: int = 16, eos_id: int | None = None,
               sampling: SamplingParams | None = None, priority: int = 0,
               deadline_s: float | None = None) -> int:
        """Queue a request; returns its rid. `deadline_s` is relative."""
        prompt = list(prompt) or [0]
        padded = -(-len(prompt) // self.prefill_chunk) * self.prefill_chunk
        if padded > self.max_seq:
            raise ValueError(f"prompt of {len(prompt)} tokens (chunk-padded to {padded}) "
                             f"exceeds max_seq={self.max_seq}")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        max_tokens = min(max_tokens, self.max_seq - len(prompt) + 1)
        now = time.monotonic()
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_tokens, eos_id, sampling or GREEDY, priority=priority,
                      deadline=None if deadline_s is None else now + deadline_s)
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
        a priority)."""
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = max(self.queue, key=lambda r: (r.priority, -r.rid))
                self.queue.remove(req)
                self.slots[i] = req
                self.cache_len[i] = 0

    def _retire(self, slot: int, req: Request, status: str = "ok") -> None:
        self._finish(req, status)
        self.slots[slot] = None
        self.cache_len[slot] = 0

    def _record(self, tokens: np.ndarray) -> None:
        shape = tuple(tokens.shape)
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

    def _forward(self, toks: np.ndarray, cache_len: np.ndarray,
                 rows: list[int]) -> torch.Tensor:
        """One row-masked forward; only `rows` may change the caches."""
        batch = {
            "tokens": torch.from_numpy(toks).to(self.device),
            # host tensors: the model plans its cache writes on the host
            "cache_len": torch.from_numpy(cache_len.astype(np.int64)),
            "write_rows": torch.tensor(rows, dtype=torch.long),
        }
        with torch.inference_mode():
            logits, self.caches = self.bundle.forward_step(
                self.params, batch, self.caches, compute_dtype=self._compute_dtype)
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
        if not pre:
            return
        toks = np.zeros((self.n_slots, chunk), np.int32)
        cache_len = np.zeros((self.n_slots,), np.int32)
        n_new = {}
        for i, r in pre:
            part = r.prompt[r.n_prefilled: r.n_prefilled + chunk]
            toks[i, : len(part)] = part
            cache_len[i] = r.n_prefilled
            n_new[i] = len(part)
        t0 = time.perf_counter()
        logits = self._forward(toks, cache_len, [i for i, _ in pre])
        self._sync()
        self._record(toks)
        self._counters["prefill_forwards"] += 1
        self._counters["prefill_tokens"] += sum(n_new.values())
        self._counters["prefill_s"] += time.perf_counter() - t0

        # first output token of every slot whose prompt just completed, from
        # that slot's last valid position in this chunk
        last_idx = np.zeros((self.n_slots,), np.int64)
        finishing = []
        for i, r in pre:
            r.n_prefilled += n_new[i]
            self.cache_len[i] = r.n_prefilled
            if r.prefill_done:
                last_idx[i] = n_new[i] - 1
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
        if not dec:
            return
        toks = np.zeros((self.n_slots, 1), np.int32)
        for i, r in dec:
            toks[i, 0] = r.out_tokens[-1] if r.out_tokens else r.prompt[-1]
        t0 = time.perf_counter()
        logits = self._forward(toks, self.cache_len, [i for i, _ in dec])
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
        """One engine step: lifecycle sweep, admit, one prefill chunk, one
        decode forward."""
        self._counters["steps"] += 1
        self._sweep()
        self._admit()
        self._prefill_step()
        self._decode_step()

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
