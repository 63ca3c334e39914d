"""Continuous-batching serving engine over paged KV pools (PyTorch).

The port of the JAX package's `models/engine.py` `ServingEngine`, the
host loop a production deployment runs around the paged kernels:

- requests queue up and are admitted into fixed batch *slots* as they
  free (highest priority first, FIFO within a priority); each admission
  reserves its worst-case page span from the page allocator and
  releases it on completion;
- prefill is chunked across steps: each `step()` advances every
  mid-prefill request by one page-sized chunk
  (`serving.paged_chunk_step` on the request's own table row against
  the shared pools), so a long prompt never stalls the decode cadence
  of the requests already streaming;
- one `step()` = admissions + one prefill chunk per prefilling slot +
  one batched `serving.paged_decode_step` for every active slot;
- `step_burst(k)`: k decode steps for every active slot with the tokens
  fed back on the device (`serving.paged_decode_burst`): its inputs go
  up in one copy, and its tokens, valid flags and logprobs come back in
  one read; it falls back to `step()` while a slot prefills, a queued
  request could be admitted, or nothing is active;
- slots without an emitted token (free, or still prefilling) ride
  along in the batched decode against the allocator's null page 0,
  which no request owns, so their writes can never land in live pages.

Sampling: a request's temperature, top_k and top_p, per row
(`serving.sample_token_per_row`), with randomness addressed by (engine
seed, request id, token index), so a sampled stream is the same whatever
shares the batch and under `step()` or `step_burst(k)`; ``logit_bias``
rows live on the device and change only at admission and retirement;
``logprobs`` records log P(token) under the unfiltered, unbiased
distribution.

``kv_precision`` (INT8 / FP8-E4M3 / FP8-E5M2 / NF4): quantized-KV
serving.  Full pages live in quantized pools with one scale per (page,
kv head) and each slot keeps one tail page in the model's dtype; the
steps are `serving.paged_chunk_step_q` and `serving.paged_decode_step_q`,
and a page is quantized when its tail fills.  The host mirrors each
slot's full and tail lengths, so no length is read back, and knows from
them which rows may fill a page at each step (`serving.flush_schedule`).

The pools live on the parameters' device and are updated in place.  The
LoRA, prefix-cache, speculative, tensor-parallel and Gemma-family
(``chunk_step`` / ``decode_step``) features of the JAX engine raise
NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from metal_flash_attention_tpu_torch.models import llama, serving
from metal_flash_attention_tpu_torch.native.page_allocator import (
    PageAllocator,
    PagerError,
)
from metal_flash_attention_tpu_torch.ops.paged_attention import (
    as_kv_precision,
)
from metal_flash_attention_tpu_torch.utils.errors import not_ported


def _sample_rows(logits, seed, rids, idxs, temp, top_k, top_p):
    """Per-row sampling with request-addressed randomness: the row key is
    a hash of (seed, rid, token index), keyed by the REQUEST, not the
    slot, so a sampled stream does not depend on what else runs."""
    return serving.sample_token_per_row(
        logits, serving._row_keys(seed, rids, idxs), temp, top_k, top_p)


def _sampling_rows(reqs, idxs):
    """Host arrays of each row's (request id, token index, temperature,
    top_k, top_p) for `_sample_rows`; a row without a request (None) is
    greedy."""
    n = len(reqs)
    rids = np.zeros((n,), np.int32)
    idx = np.zeros((n,), np.int32)
    temp = np.zeros((n,), np.float32)
    top_k = np.zeros((n,), np.int32)
    top_p = np.ones((n,), np.float32)
    for j, r in enumerate(reqs):
        if r is not None:
            rids[j], idx[j] = r.rid, idxs[j]
            temp[j], top_k[j], top_p[j] = r.temperature, r.top_k, r.top_p
    return rids, idx, temp, top_k, top_p


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray            # [prompt_len] int32
    max_new_tokens: int
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = off
    top_p: float = 1.0            # 1 = off
    stop: frozenset = frozenset()  # token ids that end the request
    finished: bool = False         # hit a stop token
    want_logprobs: bool = False
    out: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)   # aligned with out
    next_token: Optional[int] = None
    pages: Optional[np.ndarray] = None   # reserved page ids
    prefill_pos: int = 0                 # tokens prefilled so far
    logit_bias: Optional[np.ndarray] = None   # [vocab] float32
    priority: int = 0                    # higher admits sooner
    submitted_step: int = -1             # engine step counters
    admitted_step: int = -1
    first_token_step: int = -1
    done_step: int = -1


class ServingEngine:
    """Continuous-batching engine for the Llama family.

    >>> eng = ServingEngine(params, cfg, max_batch=4, num_pages=256)
    >>> rid = eng.submit(prompt_tokens, max_new_tokens=64)
    >>> while not eng.idle:
    ...     for rid, tok in eng.step():
    ...         ...                      # stream tokens out
    >>> eng.result(rid)
    """

    def __init__(self, params: dict, cfg: llama.LlamaConfig, *,
                 max_batch: int, num_pages: int, page_size: int = 128,
                 max_seq: int = 4096, chunk_step=None, decode_step=None,
                 admissions_per_step: int = 1, seed: int = 0,
                 prefix_cache: bool = False, kv_sharding=None,
                 draft_fn=None, draft_len: int = 0,
                 draft_history: int = 16, kv_precision=None, lora=None):
        # The combinations the JAX engine refuses, refused as it does.
        custom = chunk_step is not None or decode_step is not None
        if lora is not None and (draft_fn is not None
                                 or kv_precision is not None or custom):
            raise ValueError(
                "lora rides on the default llama paged steps only "
                "(not speculative/quantized/custom-family steps)")
        if kv_precision is not None and (draft_fn is not None
                                         or kv_sharding is not None
                                         or custom):
            raise ValueError("kv_precision is incompatible with draft_fn / "
                             "kv_sharding / custom step overrides")
        # draft_len and draft_history only matter with draft_fn.
        for value, what, item in (
                (custom, "family step overrides (chunk_step / "
                 "decode_step)", "paged-kernel options for Gemma and sinks"),
                (prefix_cache, "prefix caching", "prefix cache"),
                (kv_sharding, "tensor-parallel pools (kv_sharding)",
                 "tensor-parallel serving"),
                (draft_fn, "speculative decoding (draft_fn)",
                 "speculative decoding"),
                (lora, "multi-adapter LoRA", "LoRA")):
            if value:
                raise not_ported(what, item)
        if admissions_per_step < 1:
            raise ValueError(f"admissions_per_step must be >= 1, got "
                             f"{admissions_per_step}")
        self.params = params
        self.cfg = cfg
        self.page_size = page_size
        self.max_pages = -(-max_seq // page_size)
        self.admissions_per_step = admissions_per_step
        self.alloc = PageAllocator(num_pages=num_pages, page_size=page_size)
        self.device = params["embed"].device
        self._kv_precision = (None if kv_precision is None
                              else as_kv_precision(kv_precision))
        if self._kv_precision is None:
            pool_shape = (num_pages, cfg.n_kv_heads, page_size,
                          cfg.head_dim)

            def pools():
                return [torch.zeros(pool_shape, dtype=cfg.dtype,
                                    device=self.device)
                        for _ in range(cfg.n_layers)]
            self._k = pools()
            self._v = pools()
        else:
            # Quantized pools (scales 1) and one tail page a slot; the
            # host mirrors each slot's tokens in full pages and in its
            # tail, as `_flush_full_pages` moves them.
            q = serving.init_quantized_paged_model_cache(
                cfg, max_batch, page_size, precision=self._kv_precision,
                page_size=page_size, num_pages=num_pages,
                device=self.device)
            self._qk, self._qv = q.qk, q.qv
            self._ks, self._vs = q.k_scales, q.v_scales
            self._tail_k, self._tail_v = q.tail_k, q.tail_v
            self._full = np.zeros((max_batch,), np.int32)
            self._tlen = np.zeros((max_batch,), np.int32)
        # Inactive slots ride along in the batched decode: with bf16
        # pools they write their (garbage) token KV at lengths = 0
        # through table rows that point at the null page; with quantized
        # pools they are frozen (`active`).
        self._table = np.zeros((max_batch, self.max_pages), np.int32)
        self._lengths = np.zeros((max_batch,), np.int32)
        self._slots: list[Optional[_Request]] = [None] * max_batch
        self._queue: deque[_Request] = deque()
        self._done: dict[int, _Request] = {}
        self._next_rid = 0
        self.seed = int(seed)
        # Per-slot logit-bias rows live on the device and change only at
        # admission and retirement (no upload a step).
        self._bias_dev: Optional[torch.Tensor] = None
        self._bias_count = 0
        # Observability counters (see .stats / .request_stats).
        self.n_steps = 0
        self.n_emitted = 0
        self.n_prefill_chunks = 0

    # -- public API -------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, stop_tokens=(),
               logprobs: bool = False, lora_id: int = 0,
               logit_bias=None, priority: int = 0) -> int:
        """Queue a request; returns its id.  temperature 0 (the default)
        decodes greedily; temperature > 0 samples with the optional
        top-k / nucleus filters.  Sampled streams are a pure function of
        (engine seed, request id, token index).

        ``stop_tokens``: token ids (e.g. EOS) that end the request; the
        stop token is part of the output.  ``logprobs``: record log
        P(token | context) under the model's unfiltered distribution for
        every generated token (:meth:`result_logprobs`).  ``logit_bias``:
        a {token: bias} dict or a [vocab] array added to the logits
        before choosing.  ``priority``: higher admits sooner, FIFO
        within a priority."""
        if lora_id:
            raise not_ported("multi-adapter LoRA", "LoRA")
        bias_vec = None
        if logit_bias is not None:
            bias_vec = np.zeros((self.cfg.vocab_size,), np.float32)
            if isinstance(logit_bias, dict):
                for t, v in logit_bias.items():
                    bias_vec[int(t)] = float(v)
            else:
                bias_vec[:] = np.asarray(logit_bias, np.float32)
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(
            rid, np.asarray(prompt, np.int32), int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p),
            stop=frozenset(int(t) for t in stop_tokens),
            want_logprobs=bool(logprobs), logit_bias=bias_vec,
            priority=int(priority), submitted_step=self.n_steps))
        return rid

    @property
    def idle(self) -> bool:
        return not self._queue and all(r is None for r in self._slots)

    def result(self, rid: int) -> np.ndarray:
        """prompt + generated-so-far for ``rid`` (done, running, or still
        queued)."""
        req = self._done.get(rid)
        if req is None:
            req = next((r for r in list(self._slots) + list(self._queue)
                        if r is not None and r.rid == rid), None)
        if req is None:
            raise KeyError(rid)
        return np.concatenate([req.prompt, np.asarray(req.out, np.int32)])

    @property
    def stats(self) -> dict:
        """Engine counters: steps run, tokens emitted, prefill chunks,
        queue and slot occupancy, free pool pages."""
        return {
            "steps": self.n_steps,
            "emitted_tokens": self.n_emitted,
            "prefill_chunks": self.n_prefill_chunks,
            "queue_depth": len(self._queue),
            "active_slots": sum(r is not None for r in self._slots),
            "free_pages": self.alloc.free_pages,
        }

    def request_stats(self, rid: int) -> dict:
        """Per-request lifecycle in engine steps: queue wait,
        time-to-first-token, total residency, tokens generated."""
        req = self._done[rid]

        def since_submit(step):
            # Aborted requests can miss lifecycle events.
            return None if step < 0 else step - req.submitted_step
        return {
            "queue_steps": since_submit(req.admitted_step),
            "ttft_steps": since_submit(req.first_token_step),
            "total_steps": since_submit(req.done_step),
            "generated": len(req.out),
        }

    def result_logprobs(self, rid: int) -> np.ndarray:
        """Per-generated-token log-probabilities (aligned with the
        generated suffix of :meth:`result`) of a done request submitted
        with ``logprobs=True``."""
        req = self._done[rid]
        if not req.want_logprobs:
            raise ValueError(
                f"request {rid} was not submitted with logprobs=True")
        return np.asarray(req.logprobs, np.float32)

    @torch.inference_mode()
    def abort(self, rid: int) -> bool:
        """Cancel a request: a queued one is dropped, a running one frees
        its slot and pages at once.  Its partial output stays readable
        with :meth:`result`.  Returns False if ``rid`` is unknown or
        already done."""
        for j, q in enumerate(self._queue):
            if q.rid == rid:
                del self._queue[j]
                q.done_step = self.n_steps
                self._done[rid] = q
                return True
        for i, r in enumerate(self._slots):
            if r is not None and r.rid == rid:
                r.finished = True
                self._free_slot(i)
                return True
        return False

    @torch.inference_mode()
    def step_burst(self, k: int) -> list[tuple[int, int]]:
        """Emit up to ``k`` tokens per active slot from k decode steps
        between two host reads (`serving.paged_decode_burst`, or
        `paged_decode_burst_q` over quantized pools): tokens feed back on
        the device, and per-row sampling, stop ids and budgets are
        handled there; the burst runs at most as many steps as the
        largest budget left.  Its inputs go up in one copy at entry, and
        its tokens, valid flags and logprobs come back in one read; the
        host mirrors the lengths from the valid flags.  Falls back to a
        normal :meth:`step` whenever bursting cannot run: a slot is
        mid-prefill, a queued request could be admitted, or nothing is
        active.  Streams equal those of k successive :meth:`step`
        calls."""
        if k < 1:
            raise ValueError(f"step_burst needs k >= 1, got {k}")
        can = (not any(r is not None and r.next_token is None
                       for r in self._slots)
               and any(r is not None for r in self._slots)
               and not (self._queue
                        and any(r is None for r in self._slots)))
        if not can:
            return self.step()
        self.n_steps += 1
        n = len(self._slots)
        tokens = np.zeros((n,), np.int32)
        active = np.zeros((n,), bool)
        remaining = np.zeros((n,), np.int32)
        n_stops = max([len(r.stop) for r in self._slots
                       if r is not None] + [1])
        stops = np.full((n, n_stops), -1, np.int32)
        for i, r in enumerate(self._slots):
            if r is None:
                continue
            tokens[i] = r.next_token
            active[i] = True
            remaining[i] = r.max_new_tokens - len(r.out)
            # The host's length mirror below assumes every active row
            # emits at least once this burst (emit == alive); `_retire`
            # keeps exhausted rows out.
            assert remaining[i] >= 1, (
                f"slot {i} entered burst with remaining={remaining[i]}")
            stops[i, :len(r.stop)] = sorted(r.stop)
        rids, idx0, temp, top_k, top_p = _sampling_rows(
            self._slots, [0 if r is None else len(r.out)
                          for r in self._slots])
        # No row can emit past its budget, which the host knows: steps
        # beyond the largest one would only run frozen rows.
        k = min(int(k), int(remaining.max()))
        quantized = self._kv_precision is not None
        if quantized:
            lengths = (self._full, self._tlen)
            schedule = serving.flush_schedule(self._tlen, active,
                                              self.page_size, k)
            rows = np.concatenate(schedule).astype(np.int32)
        else:
            lengths = (self._lengths,)
            rows = np.zeros((0,), np.int32)
        (tok_t, table_t, *len_t, active_t, rem_t, stops_t, rids_t, idx0_t,
         temp_t, top_k_t, top_p_t, rows_t) = self._upload(
            tokens, self._table, *lengths, active, remaining, stops, rids,
            idx0, temp, top_k, top_p, rows)
        common = dict(
            n_steps=k, active=active_t, remaining=rem_t,
            stop_ids=stops_t, seed=self.seed, rids=rids_t, idx0=idx0_t,
            temp=temp_t, top_k=top_k_t, top_p=top_p_t,
            want_logprobs=any(r is not None and r.want_logprobs
                              for r in self._slots),
            # When no row samples, each step's choice is one argmax.
            sampled=any(r is not None and r.temperature > 0.0
                        for r in self._slots),
            logit_bias=self._bias_dev if self._bias_count else None)
        if quantized:
            cache = serving.QuantizedPagedModelCache(
                qk=self._qk, qv=self._qv, k_scales=self._ks,
                v_scales=self._vs, tail_k=self._tail_k,
                tail_v=self._tail_v, page_table=table_t, full_len=len_t[0],
                tail_len=len_t[1], precision=self._kv_precision)
            flush_rows = torch.split(rows_t.long(),
                                     [len(r) for r in schedule])
            toks, valid, lps, _, _ = serving.paged_decode_burst_q(
                self.params, tok_t, self.cfg, cache, flush_rows=flush_rows,
                **common)
        else:
            cache = serving.PagedModelCache(
                k=tuple(self._k), v=tuple(self._v), page_table=table_t,
                lengths=len_t[0])
            toks, valid, lps, _, _ = serving.paged_decode_burst(
                self.params, tok_t, self.cfg, cache, **common)
        # ONE device-to-host read for all three outputs.
        out = torch.stack([toks, valid.to(torch.int32),
                           lps.view(torch.int32)]).cpu().numpy()
        toks, valid, lps = out[0], out[1].astype(bool), \
            out[2].view(np.float32)
        # A row's cache advanced once per emitted token (a burst row is
        # alive exactly for its emitting steps): mirror that instead of
        # reading lengths back, flushing each whole page of tail.
        adv = valid.sum(axis=1).astype(np.int32)
        if quantized:
            total = self._tlen + adv
            self._full = (self._full + self.page_size
                          * (total // self.page_size)).astype(np.int32)
            self._tlen = (total % self.page_size).astype(np.int32)
        self._lengths = (self._lengths + adv).astype(np.int32)
        emitted: list[tuple[int, int]] = []
        for i, r in enumerate(self._slots):
            if r is None:
                continue
            for j in range(k):
                if not valid[i, j]:
                    break
                t = int(toks[i, j])
                r.out.append(t)
                r.finished = t in r.stop
                if r.want_logprobs:
                    r.logprobs.append(float(lps[i, j]))
                emitted.append((r.rid, t))
                r.next_token = t
        self._retire()
        self.n_emitted += len(emitted)
        return emitted

    @torch.inference_mode()
    def step(self) -> list[tuple[int, int]]:
        """One engine iteration; returns the (request_id, token) pairs
        emitted this step."""
        self.n_steps += 1
        emitted: list[tuple[int, int]] = []
        for _ in range(self.admissions_per_step):
            if not self._admit():
                break
        self._prefill_step(emitted)
        if any(r is not None and r.next_token is not None
               for r in self._slots):
            self._decode_active(emitted)
        self._retire()
        self.n_emitted += len(emitted)
        return emitted

    # -- internals --------------------------------------------------------

    def _admit(self) -> bool:
        """Admit one queued request into a free slot: reserve its page
        span and queue it for chunked prefill.  The slot's decode-visible
        table row stays on the null page until its prefill completes."""
        free = next((i for i, r in enumerate(self._slots) if r is None),
                    None)
        if free is None or not self._queue:
            return False
        qi = max(range(len(self._queue)),
                 key=lambda j: (self._queue[j].priority, -j))
        req = self._queue[qi]
        budget = len(req.prompt) + req.max_new_tokens + 1
        if budget > self.max_pages * self.page_size:
            raise ValueError(f"request {req.rid} exceeds max_seq")
        try:
            pages = self.alloc.reserve(seq=free, num_tokens=budget)
        except PagerError:
            return False    # retry after a retirement
        del self._queue[qi]
        req.admitted_step = self.n_steps
        req.pages = np.zeros((self.max_pages,), np.int32)
        req.pages[:len(pages)] = pages
        req.prefill_pos = 0
        if req.logit_bias is not None:
            if self._bias_dev is None:
                self._bias_dev = torch.zeros(
                    (len(self._slots), self.cfg.vocab_size),
                    dtype=torch.float32, device=self.device)
            self._bias_dev[free] = torch.from_numpy(req.logit_bias)
            self._bias_count += 1
        self._slots[free] = req
        return True

    def _upload(self, *arrays: np.ndarray) -> list:
        """Host arrays (int32, float32 or bool) to the device in ONE
        copy: packed as int32 words into one buffer, each starting 16-byte
        aligned (as the kernels want their table and lengths), and handed
        back as views in their own dtypes and shapes."""
        words, offsets, off = [], [], 0
        for a in arrays:
            if a.dtype not in (np.int32, np.float32, np.bool_):
                raise TypeError(f"cannot upload {a.dtype}")
            w = np.ascontiguousarray(a, np.int32 if a.dtype == np.bool_
                                     else a.dtype).view(np.int32).ravel()
            words += [w, np.zeros((-w.size % 4,), np.int32)]
            offsets.append(off)
            off += w.size + words[-1].size
        buf = torch.from_numpy(np.concatenate(words)).to(self.device)
        out = []
        for a, o in zip(arrays, offsets):
            t = buf[o:o + a.size].view(a.shape)
            if a.dtype == np.float32:
                t = t.view(torch.float32)
            elif a.dtype == np.bool_:
                t = t.bool()
            out.append(t)
        return out

    def _rows(self, rows: np.ndarray) -> torch.Tensor:
        """Row indices as int64 on the device (no copy when there are
        none)."""
        if not rows.size:
            return torch.empty((0,), dtype=torch.long, device=self.device)
        return torch.as_tensor(rows, dtype=torch.long, device=self.device)

    def _pick(self, logits, bias, reqs, idxs):
        """The next token of each row of float32 logits [n, vocab] (its
        request in ``reqs``, None for a ride-along row; ``idxs`` the index
        of the token it emits; ``bias`` the rows' logit bias or None),
        and their logprobs when a request asks for them: host arrays from
        one read."""
        biased = logits if bias is None else logits + bias
        live = [r for r in reqs if r is not None]
        if any(r.temperature > 0.0 for r in live):
            toks = _sample_rows(biased, self.seed, *self._upload(
                *_sampling_rows(reqs, idxs)))
        else:
            toks = serving._greedy(biased)
        if not any(r.want_logprobs for r in live):
            return toks.cpu().numpy(), None
        lps = serving._logprob_rows(logits, toks)
        out = torch.stack([toks, lps.view(torch.int32)]).cpu().numpy()
        return out[0], out[1].view(np.float32)

    def _cache(self, table: np.ndarray,
               lengths: np.ndarray) -> serving.PagedModelCache:
        return serving.PagedModelCache(
            k=tuple(self._k), v=tuple(self._v),
            page_table=torch.as_tensor(table, device=self.device),
            lengths=torch.as_tensor(lengths, device=self.device))

    def _q_cache(self, table: np.ndarray, full: np.ndarray,
                 tlen: np.ndarray, slots=slice(None)
                 ) -> serving.QuantizedPagedModelCache:
        """The shared quantized pools with the tails of ``slots`` (views:
        the steps write them in place)."""
        return serving.QuantizedPagedModelCache(
            qk=self._qk, qv=self._qv, k_scales=self._ks, v_scales=self._vs,
            tail_k=tuple(t[slots] for t in self._tail_k),
            tail_v=tuple(t[slots] for t in self._tail_v),
            page_table=torch.as_tensor(table, device=self.device),
            full_len=torch.as_tensor(full, device=self.device),
            tail_len=torch.as_tensor(tlen, device=self.device),
            precision=self._kv_precision)

    def _prefill_step(self, emitted) -> None:
        """Advance every mid-prefill request by one page-sized chunk.  On
        the final chunk the slot goes live: its table row is installed
        and its first token emitted."""
        for i, req in enumerate(self._slots):
            if req is None or req.next_token is not None:
                continue
            pos = req.prefill_pos
            self.n_prefill_chunks += 1
            chunk = torch.as_tensor(
                req.prompt[None, pos:pos + self.page_size],
                device=self.device)
            if self._kv_precision is None:
                logits, _ = serving.paged_chunk_step(
                    self.params, chunk, self.cfg,
                    self._cache(req.pages[None, :],
                                np.full((1,), pos, np.int32)))
            else:
                # A 1-row view: the shared pools and this slot's tail.
                # Chunks start page-aligned, so the tail enters empty and
                # fills exactly when the chunk is a whole page.
                zero = np.zeros((1,), np.int32)
                fills = chunk.shape[1] == self.page_size
                logits, _ = serving.paged_chunk_step_q(
                    self.params, chunk, self.cfg,
                    self._q_cache(req.pages[None, :],
                                  np.full((1,), pos, np.int32), zero,
                                  slice(i, i + 1)),
                    self._rows(np.arange(int(fills))))
            req.prefill_pos = pos + chunk.shape[1]
            if req.prefill_pos >= len(req.prompt):
                self._table[i] = req.pages
                self._lengths[i] = len(req.prompt)
                if self._kv_precision is not None:
                    n = len(req.prompt)
                    self._full[i] = n - n % self.page_size
                    self._tlen[i] = n % self.page_size
                toks, lps = self._pick(
                    logits[:, -1], None if req.logit_bias is None
                    else self._bias_dev[i:i + 1], [req], [0])
                tok = int(toks[0])
                req.next_token = tok
                req.first_token_step = self.n_steps
                req.out.append(tok)
                req.finished = tok in req.stop
                if req.want_logprobs:
                    req.logprobs.append(float(lps[0]))
                emitted.append((req.rid, tok))

    def _decode_active(self, emitted) -> None:
        """One batched decode step over every slot; the live ones emit
        their next token."""
        tokens = np.zeros((len(self._slots),), np.int32)
        active = np.zeros((len(self._slots),), bool)
        for i, r in enumerate(self._slots):
            if r is not None and r.next_token is not None:
                tokens[i] = r.next_token
                active[i] = True
        token_t = torch.as_tensor(tokens, device=self.device)
        if self._kv_precision is None:
            logits, _ = serving.paged_decode_step(
                self.params, token_t, self.cfg,
                self._cache(self._table, self._lengths))
        else:
            rows = serving.flush_schedule(self._tlen, active,
                                          self.page_size, 1)[0]
            logits, _ = serving.paged_decode_step_q(
                self.params, token_t, self.cfg,
                self._q_cache(self._table, self._full, self._tlen),
                torch.as_tensor(active, device=self.device),
                self._rows(rows))
            # The flush's arithmetic on the host: active rows advance by
            # one; a tail that reaches the page rolls into full pages.
            new_tail = self._tlen + active.astype(np.int32)
            flush = new_tail >= self.page_size
            self._full = np.where(flush, self._full + self.page_size,
                                  self._full).astype(np.int32)
            self._tlen = np.where(flush, 0, new_tail).astype(np.int32)
        reqs = [r if active[i] else None for i, r in enumerate(self._slots)]
        toks, lps = self._pick(
            logits, self._bias_dev if self._bias_count else None, reqs,
            [0 if r is None else len(r.out) for r in reqs])
        for i, r in enumerate(reqs):
            if r is None:
                continue   # inactive rows: lengths stay pinned
            self._lengths[i] += 1
            if len(r.out) < r.max_new_tokens and not r.finished:
                r.next_token = int(toks[i])
                r.out.append(r.next_token)
                r.finished = r.next_token in r.stop
                if r.want_logprobs:
                    r.logprobs.append(float(lps[i]))
                emitted.append((r.rid, r.next_token))

    def _retire(self) -> None:
        for i, r in enumerate(self._slots):
            if r is not None and (r.finished
                                  or len(r.out) >= r.max_new_tokens):
                self._free_slot(i)

    def _free_slot(self, i: int) -> None:
        """Release slot i's pages and move its request to done."""
        r = self._slots[i]
        self.alloc.release(i)
        r.done_step = self.n_steps
        if r.logit_bias is not None:
            self._bias_dev[i] = 0.0
            self._bias_count -= 1
        self._table[i] = 0
        self._lengths[i] = 0
        if self._kv_precision is not None:
            self._full[i] = 0
            self._tlen[i] = 0
        self._done[r.rid] = r
        self._slots[i] = None
