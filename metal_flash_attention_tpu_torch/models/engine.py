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
  one batched greedy `serving.paged_decode_step` for every active slot;
- slots without an emitted token (free, or still prefilling) ride
  along in the batched decode against the allocator's null page 0,
  which no request owns, so their writes can never land in live pages.

``kv_precision`` (INT8 / FP8-E4M3 / FP8-E5M2 / NF4): quantized-KV
serving.  Full pages live in quantized pools with one scale per (page,
kv head) and each slot keeps one tail page in the model's dtype; the
steps are `serving.paged_chunk_step_q` and `serving.paged_decode_step_q`,
and a page is quantized when its tail fills.  The host mirrors each
slot's full and tail lengths, so no length is read back.

The pools live on the parameters' device and are updated in place.
Greedy decoding only: the sampling, logprobs, logit-bias, LoRA,
prefix-cache, speculative, tensor-parallel and burst features of the JAX
engine raise NotImplementedError (ROADMAP.md).
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


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray            # [prompt_len] int32
    max_new_tokens: int
    stop: frozenset = frozenset()  # token ids that end the request
    finished: bool = False         # hit a stop token
    out: list = field(default_factory=list)
    next_token: Optional[int] = None
    pages: Optional[np.ndarray] = None   # reserved page ids
    prefill_pos: int = 0                 # tokens prefilled so far
    priority: int = 0                    # higher admits sooner
    submitted_step: int = -1             # engine step counters
    admitted_step: int = -1
    first_token_step: int = -1
    done_step: int = -1


class ServingEngine:
    """Greedy continuous-batching engine for the Llama family.

    >>> eng = ServingEngine(params, cfg, max_batch=4, num_pages=256)
    >>> rid = eng.submit(prompt_tokens, max_new_tokens=64)
    >>> while not eng.idle:
    ...     for rid, tok in eng.step():
    ...         ...                      # stream tokens out
    >>> eng.result(rid)
    """

    def __init__(self, params: dict, cfg: llama.LlamaConfig, *,
                 max_batch: int, num_pages: int, page_size: int = 128,
                 max_seq: int = 4096, admissions_per_step: int = 1,
                 prefix_cache: bool = False, kv_sharding=None,
                 draft_fn=None, kv_precision=None, lora=None):
        # The combinations the JAX engine refuses, refused as it does.
        if lora is not None and (draft_fn is not None
                                 or kv_precision is not None):
            raise ValueError(
                "lora rides on the default llama paged steps only "
                "(not speculative or quantized steps)")
        if kv_precision is not None and (draft_fn is not None
                                         or kv_sharding is not None):
            raise ValueError("kv_precision is incompatible with draft_fn / "
                             "kv_sharding")
        for value, what, item in (
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
        """Queue a request for greedy decoding; returns its id.

        ``stop_tokens``: token ids (e.g. EOS) that end the request; the
        stop token is part of the output.  ``priority``: higher admits
        sooner, FIFO within a priority."""
        if temperature > 0 or top_k or top_p < 1.0:
            raise not_ported("sampled decoding (temperature/top_k/top_p)",
                             "engine sampling")
        if logprobs:
            raise not_ported("logprobs", "engine sampling")
        if logit_bias is not None:
            raise not_ported("logit_bias", "engine sampling")
        if lora_id:
            raise not_ported("multi-adapter LoRA", "LoRA")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(
            rid, np.asarray(prompt, np.int32), int(max_new_tokens),
            stop=frozenset(int(t) for t in stop_tokens),
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

    def step_burst(self, k: int):
        raise not_ported("step_burst (k decode steps per dispatch)",
                         "engine step_burst")

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
        self._slots[free] = req
        return True

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
                # Chunks start page-aligned, so the tail enters empty.
                zero = np.zeros((1,), np.int32)
                logits, _ = serving.paged_chunk_step_q(
                    self.params, chunk, self.cfg,
                    self._q_cache(req.pages[None, :],
                                  np.full((1,), pos, np.int32), zero,
                                  slice(i, i + 1)))
            req.prefill_pos = pos + chunk.shape[1]
            if req.prefill_pos >= len(req.prompt):
                self._table[i] = req.pages
                self._lengths[i] = len(req.prompt)
                if self._kv_precision is not None:
                    n = len(req.prompt)
                    self._full[i] = n - n % self.page_size
                    self._tlen[i] = n % self.page_size
                tok = int(logits[0, -1].argmax())
                req.next_token = tok
                req.first_token_step = self.n_steps
                req.out.append(tok)
                req.finished = tok in req.stop
                emitted.append((req.rid, tok))

    def _decode_active(self, emitted) -> None:
        """One batched greedy decode step over every slot; the live ones
        emit their next token."""
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
            logits, _ = serving.paged_decode_step_q(
                self.params, token_t, self.cfg,
                self._q_cache(self._table, self._full, self._tlen),
                torch.as_tensor(active, device=self.device))
            # The flush's arithmetic on the host: active rows advance by
            # one; a tail that reaches the page rolls into full pages.
            new_tail = self._tlen + active.astype(np.int32)
            flush = new_tail >= self.page_size
            self._full = np.where(flush, self._full + self.page_size,
                                  self._full).astype(np.int32)
            self._tlen = np.where(flush, 0, new_tail).astype(np.int32)
        toks = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        for i, r in enumerate(self._slots):
            if r is None or r.next_token is None:
                continue   # inactive rows: lengths stay pinned
            self._lengths[i] += 1
            if len(r.out) < r.max_new_tokens and not r.finished:
                r.next_token = int(toks[i])
                r.out.append(r.next_token)
                r.finished = r.next_token in r.stop
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
        self._table[i] = 0
        self._lengths[i] = 0
        if self._kv_precision is not None:
            self._full[i] = 0
            self._tlen[i] = 0
        self._done[r.rid] = r
        self._slots[i] = None
