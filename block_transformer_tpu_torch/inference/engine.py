"""Continuous-batching serving engine (port of
``block_transformer_tpu/inference/engine.py``, one device).

A fixed pool of ``n_slots`` sequence slots decodes block-synchronously:
every decode step produces one block (``block_length`` tokens) for every
live slot. Waiting prompts are admitted into free slots between decode
windows; a slot's region of the global block-level KV cache is re-prefilled
on admission while the other slots' caches persist.

- Cache kinds: ``"bf16"`` (a cache in the activation dtype, decode
  attention through K2's bf16 form), ``"int8"`` (the contiguous INT8 cache,
  per-slot writes through K5, decode attention through K2), ``"int4"`` (the
  contiguous INT4 cache, packed two values a byte: plain per-row writes,
  decode attention on the dequantized layer, as in the JAX package),
  ``"paged"`` (an INT8 page pool: pages come from a free list at
  admission, first fit; decode attends through K6, writes through K7 after
  the layer loop, and admission places prefilled pages with K8) and
  ``"paged-int4"`` (an INT4 page pool: each decode step writes every
  layer's packed K/V first with a plain indexed write, then attends through
  K6's INT4 form; admission prefills an INT4 mini-cache and K8 copies its
  packed pages). The token decoder's local cache is bf16 on every kind.
- Admission pads each prompt to the next ``bucket_blocks`` multiple and
  prefills same-bucket prompts together, in chunks of at most
  ``admit_chunk`` rows padded to a power of two by repeating the last row
  (a repeated row writes the same values again).
- The decode window: the JAX package runs up to ``window_len`` blocks in
  one ``lax.while_loop`` program; here it is a host loop over the blocks
  that stops once no slot is live, reading one flag per block. EOS and each
  slot's block budget are kept on the device (``alive``, ``blocks_left``).
- ``run`` dispatches window i+1 before it consumes window i, as the JAX
  engine does, so admission, slot reuse, ``stats`` and the dispatch count
  follow the same schedule.

The engine's state lives on ``device`` ("cuda" by default) and is updated
in place; ``params`` must already be there (the engine never moves them).
Sampling draws from a ``torch.Generator`` seeded from ``seed``. Admission
and decode declare the KV mode of the W8A8 decisions (``ops.linear.kv_mode``:
the cache kind, and ``int8`` for either paged pool), as the JAX engine does.
Not ported: serving over a mesh (``mesh``) and ``overlap_streams > 1``; the
engine raises for both.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from block_transformer_tpu_torch.config import BlockTransformerConfig
from block_transformer_tpu_torch.inference import generate as gen
from block_transformer_tpu_torch.kernels import paged_attention
from block_transformer_tpu_torch.models import embedder as emb
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import masks


@dataclass
class Request:
    uid: int
    prompt: np.ndarray              # [T] token ids
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    stream: Optional[Callable[[int, List[int]], None]] = None
    # host-clock stamps (perf_counter): queue wait = admitted - submitted;
    # TTFT = first_token - submitted; TPOT = (done - first_token) /
    # max(1, tokens - 1)
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    done_at: float = 0.0


@dataclass
class EngineStats:
    steps: int = 0
    tokens_generated: int = 0
    prompts_admitted: int = 0
    prompts_finished: int = 0
    # positions decoded past a request's EOS / max_new_tokens inside its
    # final block (paid but not emitted)
    tokens_wasted: int = 0


def _round_up(x, m):
    return -(-x // m) * m


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class ContinuousBatchingEngine:
    def __init__(self, params, cfg: BlockTransformerConfig, *, n_slots: int = 8,
                 max_blocks: int = 512, greedy: bool = True,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 kv_cache: str = "bf16", bucket_blocks: int = 64,
                 sync_blocks: int = 4, max_window: int = 64, seed: int = 0,
                 page_size: int = 256, pool_pages: Optional[int] = None,
                 mesh=None, mesh_impl: str = "gspmd",
                 latency_mode: bool = False, window_growth: float = 2.0,
                 overlap_streams: int = 1, admit_chunk: int = 64,
                 device="cuda"):
        del mesh_impl                  # moot: no mesh serving in the port
        if mesh is not None:
            raise NotImplementedError("the port serves on one device: mesh "
                                      "serving is not ported")
        if overlap_streams > 1:
            raise NotImplementedError("overlap_streams > 1 is mesh-only and "
                                      "not ported")
        if kv_cache not in ("bf16", "int8", "int4", "paged", "paged-int4"):
            raise ValueError(f"unknown kv_cache {kv_cache!r} (expected bf16, "
                             "int8, int4, paged or paged-int4)")
        if cfg.block_decoder_cls != "gpt-neo-x":
            raise NotImplementedError(f"block decoder {cfg.block_decoder_cls!r}")
        self.device = dev = torch.device(device)
        for t in _leaves(params):
            if t.device.type != dev.type or (
                    dev.index is not None and t.device.index != dev.index):
                raise ValueError(f"params must be on {dev}, found a tensor on "
                                 f"{t.device}")
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_blocks = max_blocks
        self.greedy = greedy
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.bucket_blocks = max(1, bucket_blocks)
        # blocks per window while prompts wait for a slot; with an empty
        # queue windows grow up to max_window
        self.sync_blocks = max(1, sync_blocks)
        self.max_window = max(self.sync_blocks, max_window)
        # latency mode: the first window after an admission is capped at
        # sync_blocks, later ones grow by window_growth per dispatch
        self.latency_mode = latency_mode
        self.window_growth = max(1.0, window_growth)
        self._window_cap = self.sync_blocks if latency_mode else self.max_window
        self.admit_chunk = max(1, admit_chunk)
        n = cfg.n_embedding_tokens
        ph = cfg.embedder.projection_hidden_size
        # the activation dtype: a never-quantized embedder table's (the
        # lookup table or an encoder embedder's word embeddings)
        e = params["embedder"]
        table = (e.get("embeddings")
                 or e.get("roberta", {}).get("word_embeddings")
                 or e.get("t5", {}).get("embed"))
        dtype = table["weight"].dtype
        cap = max_blocks * n
        self.cap = cap = _round_up(cap, 128) if cap >= 128 else cap
        self.kv_kind = kv_cache
        # the KV mode admission and decode declare for the W8A8 decisions:
        # a paged pool declares int8 at either width, as the JAX engine does
        self._kv_mode = "int8" if kv_cache.startswith("paged") else kv_cache
        bcfg = cfg.block_decoder

        if kv_cache.startswith("paged"):
            # an INT8 or INT4 pool; page 0 is the null page, pages 1.. are
            # handed out at admission
            bits = 4 if kv_cache.endswith("int4") else 8
            self.page_size = ps = min(page_size, cap)
            self.cap = cap = _round_up(cap, ps)
            self.n_virt = cap // ps
            self.pool_pages = max(self.n_virt + 1, pool_pages or max(
                self.n_virt + 1, n_slots * self.n_virt // 2 + 1))
            self.cache = neox.PagedKVCache.create(
                bcfg, n_slots, cap, n_pages=self.pool_pages, page_size=ps,
                bits=bits, device=dev)
            self._free_pages = list(range(1, self.pool_pages))
            self._slot_pages: Dict[int, list] = {}
            # admission prefills a contiguous mini-cache of the pool's
            # width, then copies its pages into the pool
            self._make_cache = lambda b: neox.QuantKVCache.create(
                bcfg, b, cap, bits=bits, device=dev)
        else:
            self._make_cache = lambda b: neox.make_kv_cache(
                bcfg, b, cap, kv_cache, dtype=dtype, device=dev)
            self.cache = self._make_cache(n_slots)
        i32 = dict(dtype=torch.int32, device=dev)
        self.slot_len = torch.zeros((n_slots,), **i32)      # blocks used
        self.kv_valid = torch.zeros((n_slots, cap), **i32)
        self.next_embeds = torch.zeros((n_slots, n, ph), dtype=dtype,
                                       device=dev)
        # device-side liveness: EOS clears alive and budgets reach zero on
        # the device, so a window stays right when the host consumes its
        # tokens a window late
        self.alive = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
        self.blocks_left = torch.zeros((n_slots,), **i32)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self._kv_idx = torch.arange(cap, **i32) // n
        self._ar_n = torch.arange(n, **i32)
        self._cols = torch.arange(cap, **i32)

        # host-side bookkeeping
        self.active: Dict[int, Request] = {}   # slot -> request
        self._dispatched: Dict[int, int] = {}  # slot -> blocks dispatched
        self.waiting: List[Request] = []
        self.completed: List[Request] = []
        self.stats = EngineStats()
        self._uid = 0

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               stream: Optional[Callable] = None) -> int:
        self._uid += 1
        self.waiting.append(Request(self._uid, np.asarray(prompt, np.int32),
                                    max_new_tokens, stream=stream,
                                    submitted_at=time.perf_counter()))
        return self._uid

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def latency_metrics(self, skip: int = 0) -> dict:
        """Host-clock latency over completed requests (the first ``skip``
        left out): queue wait (submit -> admit), TTFT (submit -> first
        token) and TPOT (time per output token after the first). Tokens
        reach the host a window at a time, so TTFT follows the window
        cadence."""
        done = [r for r in self.completed[skip:]
                if not r.error and r.generated and r.first_token_at]
        if not done:
            return {"completed": 0}

        def pct(xs, q):
            xs = sorted(xs)
            return float(xs[min(len(xs) - 1, int(q * len(xs)))])

        queue = [r.admitted_at - r.submitted_at for r in done]
        ttft = [r.first_token_at - r.submitted_at for r in done]
        tpot = [(r.done_at - r.first_token_at) / max(1, len(r.generated) - 1)
                for r in done]
        return {
            "completed": len(done),
            "queue_wait_s_mean": float(np.mean(queue)),
            "ttft_s_mean": float(np.mean(ttft)),
            "ttft_s_p50": pct(ttft, 0.50), "ttft_s_p95": pct(ttft, 0.95),
            "tpot_s_mean": float(np.mean(tpot)),
            "tpot_s_p95": pct(tpot, 0.95),
        }

    # ------------------------------------------------------------------
    def _prefill(self, slots, true_len, ids, att, bam) -> None:
        """Reset G slots and prefill their cache regions in one batched run.

        ids/att [G, Nb, L] right-padded to the bucket; bam [G, Nb]; slots,
        true_len (real prompt blocks) [G]. The G rows run as a mini-cache,
        then land in the engine's cache: along the slot axis (contiguous)
        or page by page through K8 (paged, either width; unallocated tail
        pages go to the null page). Padded tail positions stay kv_valid = 0 and are
        overwritten as decode advances."""
        cfg, cap = self.cfg, self.cap
        n = cfg.n_embedding_tokens
        G = ids.shape[0]
        be = emb.embed_blocks(self.params["embedder"], cfg.embedder,
                              cfg.block_length, ids,
                              attention_mask=att)          # [G, Nb, n, ph]
        x = be.reshape(G, -1, be.shape[-1])
        S = x.shape[1]
        valid = torch.zeros((G, cap), dtype=torch.int32, device=self.device)
        valid[:, :S] = bam.to(torch.int32).repeat_interleave(n, dim=1)
        mask = masks.block_decode_mask(0, cap, S, valid, n)
        positions = torch.arange(S, dtype=torch.int32, device=self.device)
        hidden, rows = neox.neox_stack(
            self.params["block_decoder"], x, cfg=cfg.block_decoder,
            mask=mask, positions=positions, cache=self._make_cache(G))
        c = self.cache
        if isinstance(c, neox.PagedKVCache):
            paged_attention.paged_page_copy_int8(
                c.k, c.k_scale, c.v, c.v_scale, c.page_table[slots],
                rows.k, rows.k_scale, rows.v, rows.v_scale)
        else:
            for f in c._fields:
                if f != "length":
                    getattr(c, f)[:, slots] = getattr(rows, f)
        # zero validity beyond each true prompt (padded bucket tail)
        self.kv_valid[slots] = torch.where(
            self._cols[None] < true_len[:, None] * n, valid, 0)
        # block-decoder output at each last real prompt block
        idx = (true_len[:, None] - 1) * n + self._ar_n[None]      # [G, n]
        last = hidden.gather(1, idx[:, :, None].long().expand(
            G, n, hidden.shape[-1]))
        self.next_embeds[slots] = last.to(self.next_embeds.dtype)

    def _one_block(self):
        """One block for every slot; rows that are not live emit pad, embed
        zeros and keep their state. Each slot writes its new K/V at its own
        frontier (``neox_stack(write_pos=...)``)."""
        cfg = self.cfg
        n = cfg.n_embedding_tokens
        B = self.n_slots
        live = self.alive & (self.blocks_left > 0)
        tokens, inner_alive = gen.decode_block_tokens(
            self.params, cfg, self.next_embeds, greedy=self.greedy,
            temperature=self.temperature, generator=self.generator,
            top_k=self.top_k, top_p=self.top_p)
        tokens = torch.where(live[:, None], tokens, cfg.pad_token_id)
        has_eos = live & ~inner_alive

        # embed the new block and run the block decoder one step per slot
        new_be = emb.embed_blocks(self.params["embedder"], cfg.embedder,
                                  cfg.block_length, tokens)      # [B, n, ph]
        new_be = new_be.masked_fill(~live[:, None, None], 0.0)
        q_idx = self.slot_len[:, None].expand(B, n)              # block ids
        write_pos = self.slot_len * n
        valid_new = live.to(torch.int32)
        self.kv_valid = _scatter_valid(self.kv_valid, write_pos, valid_new, n)
        mask = masks.AttnMask(q_idx, self._kv_idx, self.kv_valid)
        # a finished slot may sit at write_pos == cap: its write is dropped
        # and its rotary position clamped (its outputs are never read)
        positions = (write_pos[:, None] + self._ar_n[None]).clamp(
            max=self.cap - 1)
        hidden, self.cache = neox.neox_stack(
            self.params["block_decoder"], new_be.to(self.next_embeds.dtype),
            cfg=cfg.block_decoder, mask=mask, positions=positions,
            cache=self.cache, write_pos=write_pos)
        self.next_embeds = torch.where(
            live[:, None, None], hidden[:, -n:, :].to(self.next_embeds.dtype),
            self.next_embeds)
        self.slot_len += valid_new
        self.alive &= inner_alive
        self.blocks_left -= valid_new
        return tokens, has_eos

    def _decode_window(self, window_len: int):
        """Up to ``window_len`` blocks; stops early once no slot is live.
        Returns tokens [B, window_len, L] and has_eos [B, window_len]; rows
        past the executed blocks keep pad / False."""
        B, L = self.n_slots, self.cfg.block_length
        tokens = torch.full((B, window_len, L), self.cfg.pad_token_id,
                            dtype=torch.int32, device=self.device)
        has_eos = torch.zeros((B, window_len), dtype=torch.bool,
                              device=self.device)
        for i in range(window_len):
            if not bool((self.alive & (self.blocks_left > 0)).any()):
                break
            tokens[:, i], has_eos[:, i] = self._one_block()
        return tokens, has_eos

    # ------------------------------------------------------------------
    def _admit(self):
        free = [s for s in range(self.n_slots) if s not in self.active]
        L = self.cfg.block_length
        # preprocess + bucket every admissible prompt, grouping by bucket so
        # same-bucket prompts prefill together
        groups: Dict[int, list] = {}
        skipped: List[Request] = []          # did not fit the page pool now
        while free and self.waiting:
            slot = free.pop(0)
            req = self.waiting.pop(0)
            d = gen.preprocess_inputs(self.cfg, req.prompt[None])
            N = d["input_ids"].shape[1]
            if N + (req.max_new_tokens + L - 1) // L > self.max_blocks:
                # too long for this pool: completed with an error
                req.done = True
                req.error = (f"prompt needs {N} blocks + "
                             f"{(req.max_new_tokens + L - 1) // L} generated "
                             f"> pool max_blocks={self.max_blocks}")
                self.completed.append(req)
                free.insert(0, slot)
                continue
            if self.kv_kind.startswith("paged"):
                # pages for the prompt and the whole budget, so decode never
                # grows a row; first fit when the pool is tight (skipped
                # requests keep their queue order and retry next admission)
                blocks_budget = (req.max_new_tokens + L - 1) // L
                n_emb = self.cfg.n_embedding_tokens
                need = min(self.n_virt,
                           -(-((N + blocks_budget) * n_emb) // self.page_size))
                if len(self._free_pages) < need:
                    skipped.append(req)
                    free.insert(0, slot)
                    continue
                pgs = [self._free_pages.pop() for _ in range(need)]
                self._slot_pages[slot] = pgs
                row = torch.zeros((self.n_virt,), dtype=torch.int32)
                row[:len(pgs)] = torch.tensor(pgs, dtype=torch.int32)
                self.cache.page_table[slot] = row.to(self.device)
            Nb = min(_round_up(N, self.bucket_blocks), self.max_blocks)
            groups.setdefault(Nb, []).append((slot, req, d, N))
        if skipped:
            self.waiting = skipped + self.waiting
        for Nb, batch in groups.items():
            for c0 in range(0, len(batch), self.admit_chunk):
                self._prefill_chunk(Nb, batch[c0:c0 + self.admit_chunk])

    def _prefill_chunk(self, Nb: int, batch) -> None:
        """Batched prefill of one admission chunk (one Nb bucket), padded to
        the next power of two by repeating the last row."""
        L = self.cfg.block_length
        G = len(batch)
        Gp = 1 << (G - 1).bit_length()           # next power of two
        padded = batch + [batch[-1]] * (Gp - G)
        ids = np.concatenate([
            np.pad(d["input_ids"], ((0, 0), (0, Nb - N), (0, 0)),
                   constant_values=self.cfg.pad_token_id)
            for _, _, d, N in padded])
        att = np.concatenate([
            np.pad(d["attention_mask"], ((0, 0), (0, Nb - N), (0, 0)))
            for _, _, d, N in padded])
        bam = np.concatenate([
            np.pad(d["block_attention_mask"], ((0, 0), (0, Nb - N)))
            for _, _, d, N in padded])
        slots = np.asarray([s for s, _, _, _ in padded], np.int64)
        lens = np.asarray([N for _, _, _, N in padded], np.int32)
        dev = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        with linear_ops.kv_mode(self._kv_mode):
            self._prefill(dev(slots), dev(lens), dev(ids), dev(att),
                          dev(bam))
        sl = dev(slots[:G])
        self.slot_len[sl] = dev(lens[:G])
        self.alive[sl] = True
        self.blocks_left[sl] = dev(np.asarray(
            [-(-r.max_new_tokens // L) for _, r, _, _ in batch], np.int32))
        now = time.perf_counter()
        for slot, req, _, _ in batch:
            self.active[slot] = req
            self._dispatched[slot] = 0
            req.admitted_at = now
            self.stats.prompts_admitted += 1
        if self.latency_mode:
            # fresh admissions restart the window ramp
            self._window_cap = self.sync_blocks

    def _target_window(self) -> int:
        """Blocks until the next scheduling event the host can foresee: the
        earliest budget end among active slots, capped at ``sync_blocks``
        while prompts wait; 0 when in-flight windows already cover every
        active slot's budget."""
        L = self.cfg.block_length
        rem = []
        for s, req in self.active.items():
            r = -(-req.max_new_tokens // L) - self._dispatched.get(s, 0)
            if r > 0:
                rem.append(r)
        if not rem:
            return 0
        wl = min(min(rem), self.max_window)
        if self.waiting:
            wl = min(wl, self.sync_blocks)
        if self.latency_mode:
            wl = min(wl, int(self._window_cap))
        return max(1, wl)

    def _dispatch(self, window_len: Optional[int] = None):
        """Decode one window and return its token / eos tensors with the
        slot -> request snapshot they belong to."""
        wl = window_len or self.sync_blocks
        with linear_ops.kv_mode(self._kv_mode):
            tokens, has_eos = self._decode_window(wl)
        for s in self.active:
            self._dispatched[s] = self._dispatched.get(s, 0) + wl
        self.stats.steps += 1
        if self.latency_mode:
            self._window_cap = min(self.max_window,
                                   self._window_cap * self.window_growth)
        # snapshot slot -> request now: a slot freed by an earlier window
        # may be re-admitted before this window is consumed
        return tokens, has_eos, dict(self.active), wl

    def _consume(self, window):
        """Hand one window's tokens to their requests; free the slots that
        finished (and, paged, their pages)."""
        tokens_d, eos_d, snapshot, wl = window
        tokens = tokens_d.cpu().numpy()
        has_eos = eos_d.cpu().numpy()
        now = time.perf_counter()
        finished = []
        for s, req in snapshot.items():
            if req.done:
                continue
            eos = False
            for i in range(min(wl, tokens.shape[1])):
                if eos or len(req.generated) >= req.max_new_tokens:
                    break
                block = [int(t) for t in tokens[s, i]]
                remaining = req.max_new_tokens - len(req.generated)
                emit = []
                for t in block[:remaining]:
                    if t == self.cfg.pad_token_id and has_eos[s, i]:
                        break
                    emit.append(t)
                req.generated.extend(emit)
                if emit and not req.first_token_at:
                    req.first_token_at = now
                self.stats.tokens_generated += len(emit)
                self.stats.tokens_wasted += len(block) - len(emit)
                if req.stream:
                    req.stream(req.uid, emit)
                eos = bool(has_eos[s, i])
            if eos or len(req.generated) >= req.max_new_tokens:
                req.done = True
                req.done_at = now
                finished.append(s)
        for s in finished:
            req = snapshot[s]
            self.completed.append(req)
            if self.active.get(s) is req:
                del self.active[s]
                self._dispatched.pop(s, None)
                if self.kv_kind.startswith("paged"):
                    self._free_pages.extend(self._slot_pages.pop(s, []))
                    # point the dead slot at the null page: every slot
                    # writes each decode step, and its old pages may go to
                    # another request
                    self.cache.page_table[s] = 0
            self.stats.prompts_finished += 1

    @torch.no_grad()
    def step(self):
        """Admit waiting prompts, then decode one window and consume it."""
        self._admit()
        if not self.active:
            return
        self._consume(self._dispatch(self._target_window() or 1))

    @torch.no_grad()
    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive windows until all submitted work finishes (or max_steps);
        returns the completed requests. Window i+1 is dispatched before
        window i is consumed, so slot turnover lags one window, as in the
        JAX engine."""
        pending = None
        for _ in range(max_steps):
            self._admit()
            wl = self._target_window() if self.active else 0
            if wl > 0:
                nxt = self._dispatch(wl)
            elif pending is None:
                break
            else:
                nxt = None
            if pending is not None:
                self._consume(pending)
            pending = nxt
        if pending is not None:
            self._consume(pending)
        return self.completed


def _scatter_valid(kv_valid, write_pos, valid_new, n):
    """kv_valid with [b, write_pos[b] + j] = valid_new[b] for j < n."""
    cols = torch.arange(kv_valid.shape[1], dtype=torch.int32,
                        device=kv_valid.device)[None]
    in_range = (cols >= write_pos[:, None]) & (cols < write_pos[:, None] + n)
    return torch.where(in_range, valid_new[:, None], kv_valid)
