"""Speculative decoding over shared-table LUT plans, in PyTorch.

Counterpart of `repro.serving.spec_decode` (DESIGN.md §14). One set of
learned centroids resolves under two plans: an all-LUT draft and a target
that keeps some sites dense (`LUTPlan.keeping_dense`); a multi-plan artifact
ships both, the tables they share stored once. `SpecDecoder` replaces the
engine's (n_slots, 1) decode step with a draft/verify round:

1. draft: up to gamma greedy (n_slots, 1) forwards of the draft model
   propose d_1..d_gamma per slot (d_0 is the slot's last emitted token). The
   draft keeps dense (n_slots, max_seq) caches even when the engine is paged,
   so its rollback is `cache_len` bookkeeping; each of its forwards writes
   only the rows it advances, in place.
2. verify: one target forward over (n_slots, gamma + 1) tokens d_0..d_gamma,
   a fixed third token shape N = n_slots * (gamma + 1) at every LUT site.
3. accept and emit: verify position j is sampled with the slot's own
   parameters and PRNG counter len(out_tokens) + j, the key plain decode
   would use for that token; the round emits t_0..t_{m-1}, m the longest run
   with d_j == t_{j-1}. Every emitted token is drawn from the target's logits
   on an accepted prefix, so output equals plain decode's, greedy and
   sampled.
4. rollback: target positions past the accepted prefix are invalid by
   `cache_len` (dense) and their pages go back to the pool (paged); the
   draft's `cache_len` rewinds, with one masked catch-up forward for slots
   that accepted all gamma drafts and the bonus token.

Each slot's depth gamma_eff follows its remaining token budget, its cache
headroom and a per-request opt-out (gamma_eff = 0 rides the verify forward
as a plain width-1 decode). The counters flow into `engine.stats()`.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from repro_torch.serving.sampling import GREEDY, batch_arrays, sample_tokens

# counters contributed to engine.stats() (zeroed by reset_counters)
_COUNTER_KEYS = (
    "spec_rounds",
    "spec_slot_rounds",
    "spec_draft_forwards",
    "spec_prefill_forwards",
    "spec_verify_forwards",
    "spec_catchup_forwards",
    "spec_tokens_proposed",
    "spec_tokens_accepted",
    "spec_bonus_tokens",
    "spec_tokens_emitted",
    "spec_pages_rewound",
)


class SpecDecoder:
    """Draft/verify decode scheduler of a ServingEngine.

    Owns the draft model (bundle, params, dense KV caches) and the
    accept/rollback bookkeeping; the target forward, the sampling streams,
    the slots' lifecycle and the paged pool stay with the engine. A
    self-draft (draft == target) is valid: acceptance is about 1."""

    def __init__(self, engine: Any, draft_bundle: Any, draft_params: Any, *, gamma: int,
                 kv_dtype: torch.dtype):
        if gamma < 1:
            raise ValueError(f"spec_gamma={gamma} must be >= 1")
        t_arch, d_arch = engine.bundle.arch, draft_bundle.arch
        if (draft_bundle.kind, d_arch.vocab) != (engine.bundle.kind, t_arch.vocab):
            raise ValueError(f"draft bundle ({draft_bundle.kind}, vocab={d_arch.vocab}) is not "
                             f"interchangeable with the target ({engine.bundle.kind}, "
                             f"vocab={t_arch.vocab})")
        self.eng = engine
        self.gamma = gamma
        self.draft_bundle = draft_bundle
        self.draft_params = draft_params
        # dense draft caches whatever the engine's: the draft never touches the pool
        self.draft_caches = draft_bundle.init_caches(engine.n_slots, engine.max_seq,
                                                     dtype=kv_dtype, device=engine.device)
        self.cache_len = np.zeros((engine.n_slots,), np.int32)
        self.reset_counters()

    # ------------------------------------------------------------------
    def reset_counters(self) -> None:
        self._c: dict[str, int] = {k: 0 for k in _COUNTER_KEYS}

    def counters(self) -> dict[str, Any]:
        """Spec counters and derived rates, merged into engine.stats()."""
        c: dict[str, Any] = dict(self._c)
        c["spec_gamma"] = self.gamma
        prop = c["spec_tokens_proposed"]
        c["spec_acceptance_rate"] = c["spec_tokens_accepted"] / prop if prop else 0.0
        em = c["spec_tokens_emitted"]
        # verify participations per emitted token: plain decode is exactly 1
        c["target_forwards_per_token"] = c["spec_slot_rounds"] / em if em else 0.0
        return c

    def reset_slot(self, slot: int) -> None:
        """Called by the engine on slot admit and retire."""
        self.cache_len[slot] = 0

    # ------------------------------------------------------------------
    def _draft_forward(self, toks: np.ndarray, cache_len: np.ndarray,
                       write_len: np.ndarray) -> torch.Tensor:
        logits = self.eng._forward(toks, cache_len, write_len,
                                   model=(self.draft_bundle, self.draft_params,
                                          self.draft_caches))
        self.eng._record(toks, tag="draft")
        return logits

    def mirror_prefill(self, toks: np.ndarray, cache_len: np.ndarray,
                       write_len: np.ndarray) -> None:
        """Feed the prompt chunk the target just consumed through the draft,
        with the same cursors and rows, so that the draft's cache holds every
        prompt token."""
        self._draft_forward(toks, cache_len, write_len)
        self._c["spec_prefill_forwards"] += 1
        adv = write_len > 0
        self.cache_len[adv] = cache_len[adv] + write_len[adv]

    def _sample_grid(self, logits: torch.Tensor) -> np.ndarray:
        """A token for every (slot, verify position j), with the slot's
        sampling parameters and PRNG counter len(out_tokens) + j: the keys
        plain decode would use for those tokens."""
        eng = self.eng
        params = [r.sampling if r is not None else GREEDY for r in eng.slots]
        if all(p.greedy for p in params):
            return torch.argmax(logits, dim=-1).cpu().numpy()
        width = logits.shape[1]
        row_params = [p for p in params for _ in range(width)]
        counters: list[int] = []
        for r in eng.slots:
            base = len(r.out_tokens) if r is not None else 0
            counters.extend(base + j for j in range(width))
        flat = sample_tokens(logits.reshape(eng.n_slots * width, -1),
                             *batch_arrays(row_params, counters, logits.device))
        return flat.cpu().numpy().reshape(eng.n_slots, width)

    def _rewind_pages(self, slot: int) -> None:
        """Return the pages wholly past the accepted prefix to the pool.
        Pages a decode extended are never prefix-registered, so they go to
        the free list; the kept partial page was made private (COW) before
        the verify wrote it."""
        eng = self.eng
        keep = -(-int(eng.cache_len[slot]) // eng.pool.page_size)
        pages = eng.slot_pages[slot]
        while len(pages) > keep:
            eng.pool.unref(pages.pop())
            eng.block_tables[slot, len(pages)] = 0
            self._c["spec_pages_rewound"] += 1

    # ------------------------------------------------------------------
    def decode_round(self) -> None:
        """One round for every decode-phase slot: the draft forwards, one
        (n_slots, gamma + 1) target verify, accept and emit, rollback."""
        eng = self.eng
        dec = [(i, r) for i, r in enumerate(eng.slots) if r is not None and r.prefill_done]
        if not dec:
            return
        t0 = time.perf_counter()
        # per-slot depth: the token budget (a round may emit gamma_eff + 1),
        # the cache headroom (the verify writes s .. s + gamma_eff) and the
        # per-request opt-out
        gam: dict[int, int] = {}
        for i, r in dec:
            g = self.gamma if r.spec_decode is not False else 0
            g = min(g, r.max_tokens - len(r.out_tokens) - 1,
                    eng.max_seq - 1 - int(eng.cache_len[i]))
            gam[i] = max(g, 0)
        if eng.paged:
            dec = eng._prepare_pages(dec, lambda i, r: gam[i] + 1)
            if not dec:
                return
        self._c["spec_rounds"] += 1
        self._c["spec_slot_rounds"] += len(dec)
        s0 = {i: int(eng.cache_len[i]) for i, _ in dec}

        # draft: a greedy chain d_1..d_gamma_eff per slot, rows masked
        drafts = {i: [r.out_tokens[-1] if r.out_tokens else r.prompt[-1]] for i, r in dec}
        for j in range(max(gam.values())):     # as the reference: shed slots' depths too
            toks = np.zeros((eng.n_slots, 1), np.int32)
            write_len = np.zeros((eng.n_slots,), np.int32)
            for i, _ in dec:
                if gam[i] > j:
                    toks[i, 0] = drafts[i][j]
                    write_len[i] = 1
            logits = self._draft_forward(toks, self.cache_len, write_len)
            nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
            self._c["spec_draft_forwards"] += 1
            for i, _ in dec:
                if gam[i] > j:
                    drafts[i].append(int(nxt[i]))
                    self.cache_len[i] += 1

        # verify: one target forward of fixed shape (n_slots, gamma + 1); a
        # slot's depth rides write_len (paged) or causal masking (dense: the
        # padding lands above every valid query position)
        width = self.gamma + 1
        toks = np.zeros((eng.n_slots, width), np.int32)
        cache_len = np.zeros((eng.n_slots,), np.int32)
        write_len = np.zeros((eng.n_slots,), np.int32)
        for i, _ in dec:
            toks[i, : len(drafts[i])] = drafts[i]
            cache_len[i] = s0[i]
            write_len[i] = gam[i] + 1
        logits = eng._forward(toks, cache_len, write_len)
        eng._record(toks)
        self._c["spec_verify_forwards"] += 1
        eng._counters["decode_forwards"] += 1

        # accept, emit, roll back
        t = self._sample_grid(logits)
        catchup: list[tuple[int, int, int]] = []       # (slot, token, position)
        for i, r in dec:
            g, d = gam[i], drafts[i]
            m = 1
            while m <= g and d[m] == int(t[i, m - 1]):
                m += 1
            self._c["spec_tokens_proposed"] += g
            self._c["spec_tokens_accepted"] += m - 1
            if g and m == g + 1:
                self._c["spec_bonus_tokens"] += 1
            emitted = 0
            for j in range(m):
                eng.cache_len[i] = s0[i] + j + 1
                tok = int(t[i, j])
                r.out_tokens.append(tok)
                emitted += 1
                self._c["spec_tokens_emitted"] += 1
                eng._counters["decode_tokens"] += 1
                eng._check_done_after_token(i, r, tok)
                if eng.slots[i] is not r:
                    break                 # EOS or budget: later accepts are dropped
            if eng.slots[i] is not r:
                continue                  # retired: _retire reset the slot
            # the draft's cache through s0 + emitted - 1 holds the emitted
            # tokens; a full accept needs d_gamma written at s0 + gamma
            if emitted == g + 1 and g:
                catchup.append((i, d[g], s0[i] + g))
            else:
                self.cache_len[i] = s0[i] + emitted
            if eng.paged:
                self._rewind_pages(i)
        if catchup:
            toks = np.zeros((eng.n_slots, 1), np.int32)
            write_len = np.zeros((eng.n_slots,), np.int32)
            for i, tok, pos in catchup:
                toks[i, 0] = tok
                write_len[i] = 1
                self.cache_len[i] = pos
            self._draft_forward(toks, self.cache_len, write_len)     # logits unused
            self._c["spec_catchup_forwards"] += 1
            for i, _, pos in catchup:
                self.cache_len[i] = pos + 1
        eng._sync()
        eng._counters["decode_s"] += time.perf_counter() - t0
