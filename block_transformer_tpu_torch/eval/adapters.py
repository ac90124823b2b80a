"""LM adapters: score flat token sequences with the block / vanilla models
(port of ``block_transformer_tpu/eval/adapters.py``).

``BlockTransformerLM`` reproduces the reference's pad adapter
(lm_eval/models/block_transformer_pad.py:71-156): left-pad ``block_length-1``
pad tokens so the first content token sits in block 0's last slot (making
flattened shifted logit ``j`` predict input token ``j+1``, the HF
convention), right-pad to a block boundary, mark ONE attention bit on the
EOS slot right after each row's content (:121-129), run with
``skip_padding_blocks=False`` and truncate flattened logits to ``seq_len``
(:151). ``nopad=True`` gives the right-pad-only variant for old checkpoints
(block_transformer_nopad.py: logits truncated to ``seq_len - (block_length
- 1)``).

Scoring runs in length-bucketed batches, the JAX package's buckets, sort
order and pad fill, under ``torch.no_grad()`` on the parameters' device
(the kernels have no backward). Nothing is compiled per bucket. The JAX
adapter copies a batch's whole ``[B, S, V]`` float32 logits to the host and
takes its log-softmax there; here the log-softmax of the positions that
predict a continuation token is taken in float32 on the device, which
gathers each token's log-probability and the greedy match. Only those
values come to the host, where each request's sum is taken in float32 in
the JAX adapter's order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from block_transformer_tpu_torch.config import (BlockTransformerConfig,
                                                NeoXConfig)
from block_transformer_tpu_torch.eval.harness import LM
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.models import vanilla as vmod


def _bucket(n: int, step: int = 128, lo: int = 128) -> int:
    return max(lo, -(-n // step) * step)


def params_device(params) -> torch.device:
    """The device of the first tensor leaf of a parameter tree."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def continuation_scores(logits: torch.Tensor, rows: torch.Tensor,
                        pos: torch.Tensor, toks: torch.Tensor):
    """For each (row, position, token) triple: the token's log-probability
    under ``logits[row, pos]`` (a float32 log-softmax over the vocabulary)
    and whether it is the argmax. Returns two host numpy arrays, float32
    and bool."""
    sel = logits[rows, pos].float()                     # [T, V], a copy
    sel -= torch.logsumexp(sel, dim=-1, keepdim=True)
    lp = sel.gather(-1, toks[:, None])[:, 0]
    greedy = sel.argmax(dim=-1) == toks
    return lp.cpu().numpy(), greedy.cpu().numpy()


class _TokenizedLM(LM):
    """Shared batching/scoring machinery over a logits function."""

    pad_fill = 0   # batch-buffer fill token (overridden by model adapters)

    def __init__(self, tokenizer, max_length=2048, batch_size=8):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_size = batch_size

    def tok_encode(self, s: str):
        return self.tokenizer.encode(s)

    @property
    def eot_token_id(self):
        tok = self.tokenizer
        for attr in ("eos_token_id", "eot_token_id"):
            v = getattr(tok, attr, None)
            if v is not None:
                return int(v)
        return 0

    @property
    def device(self) -> torch.device:
        return params_device(self.params)

    def _logits_fn(self, inps: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
        """inps [B, S] int32 and lengths [B] on the device -> logits
        [B, S, V] whose position t predicts input token t + 1."""
        raise NotImplementedError

    @torch.no_grad()
    def _loglikelihood_tokens(self, requests) -> List[Tuple[float, bool]]:
        order = sorted(range(len(requests)),
                       key=lambda i: -(len(requests[i][0]) + len(requests[i][1])))
        out: List = [None] * len(requests)
        dev = self.device
        for i0 in range(0, len(order), self.batch_size):
            chunk = order[i0:i0 + self.batch_size]
            seqs, conts = [], []
            for i in chunk:
                ctx, cont = requests[i]
                whole = (list(ctx) + list(cont))[-(self.max_length + 1):]
                cont = cont[-self.max_length:]
                seqs.append(whole[:-1])          # model input
                conts.append(list(cont))
            S = _bucket(max(len(s) for s in seqs))
            B = len(seqs)
            # fill with the pad token: the block adapter sets one attention
            # bit on the slot after each row's content (the "EOS slot"),
            # which must hold pad/EOS, not token 0
            inps = np.full((B, S), self.pad_fill, np.int32)
            lengths = np.zeros((B,), np.int32)
            for r, s in enumerate(seqs):
                inps[r, :len(s)] = s
                lengths[r] = len(s)
            # cont[j] of row r is predicted by position lengths[r] - n + j:
            # cont occupies the last n input positions of the full sequence
            rows = np.concatenate([np.full(len(c), r) for r, c in
                                   enumerate(conts)])
            pos = np.concatenate([np.arange(len(c)) + lengths[r] - len(c)
                                  for r, c in enumerate(conts)])
            toks = np.concatenate([np.asarray(c, np.int64) for c in conts])
            logits = self._logits_fn(torch.from_numpy(inps).to(dev),
                                     torch.from_numpy(lengths).to(dev))
            lp, greedy = continuation_scores(
                logits, *(torch.from_numpy(a.astype(np.int64)).to(dev)
                          for a in (rows, pos, toks)))
            del logits
            at = 0
            for r, i in enumerate(chunk):
                n = len(conts[r])
                out[i] = (float(lp[at:at + n].sum()),
                          bool(greedy[at:at + n].all()))
                at += n
        return out


class _GenerateMixin:
    """generate_until for adapters that own block-transformer params.

    Requests are grouped into (context-length bucket, max_new) batches and
    generated together: shorter contexts left-pad with attention-0 pad
    blocks, which the block decoder masks out — one two-level generation
    per batch instead of per request."""

    def generate_until(self, requests):
        from block_transformer_tpu_torch.inference import generate as gen
        out: List = [None] * len(requests)
        parsed = []
        for i, (context, kw) in enumerate(requests):
            until = kw.get("until") or []
            max_new = int(kw.get("max_gen_toks", 64))
            ctx = self.tok_encode(context)[-(self.max_length - max_new):]
            parsed.append((i, ctx, until, max_new))

        def bucket_key(p):
            return (_bucket(len(p[1]), step=self.cfg.block_length * 16,
                            lo=self.cfg.block_length * 4), p[3])

        parsed.sort(key=lambda p: (bucket_key(p), -len(p[1])))
        b = 0
        while b < len(parsed):
            key = bucket_key(parsed[b])
            chunk = [p for p in parsed[b:b + self.batch_size]
                     if bucket_key(p) == key]
            b += len(chunk)
            Tb, max_new = key
            ids = np.full((len(chunk), Tb), self.cfg.pad_token_id, np.int32)
            for r, (_, ctx, _, _) in enumerate(chunk):
                ids[r, Tb - len(ctx):] = ctx     # right-align; left pads
            att = np.zeros_like(ids)
            for r, (_, ctx, _, _) in enumerate(chunk):
                att[r, Tb - len(ctx):] = 1
            res = gen.generate(self.params, self.cfg, ids,
                               attention_mask=att,
                               max_length=Tb + max_new, device=self.device)
            for r, (i, ctx, until, _) in enumerate(chunk):
                new = res[r, Tb:].tolist()
                if self.eot_token_id in new:
                    new = new[:new.index(self.eot_token_id)]
                text = self.tokenizer.decode(new)
                for stop in until:
                    idx = text.find(stop)
                    if idx >= 0:
                        text = text[:idx]
                out[i] = text
        return out


class BlockTransformerLM(_GenerateMixin, _TokenizedLM):
    def __init__(self, params, cfg: BlockTransformerConfig, tokenizer,
                 max_length=2048, batch_size=8, nopad: bool = False):
        super().__init__(tokenizer, max_length, batch_size)
        self.params = params
        self.cfg = cfg
        self.pad_fill = cfg.pad_token_id
        self.nopad = nopad

    def _logits_fn(self, inps, lengths):
        cfg = self.cfg
        L = cfg.block_length
        B, S = inps.shape
        left = 0 if self.nopad else (L - 1)
        right = (-(S + left)) % L
        right = right if right else L  # always >=1 slot for the EOS bit
        total = S + left + right
        ids = torch.full((B, total), cfg.pad_token_id, dtype=torch.int32,
                         device=inps.device)
        ids[:, left:left + S] = inps
        pos = torch.arange(total, dtype=torch.int32, device=inps.device)[None]
        att = ((pos >= left) & (pos < left + lengths[:, None])).to(torch.int32)
        # one attention bit on the EOS slot after each row's content
        att[torch.arange(B, device=inps.device), left + lengths.long()] = 1
        N = total // L
        ids_b = ids.reshape(B, N, L)
        att_b = att.reshape(B, N, L)
        bam = (att_b != 0).any(-1).to(torch.int32)
        out = bt.block_transformer_forward(self.params, cfg, ids_b, att_b,
                                           bam)
        flat = out.logits.reshape(B, (N - 1) * L, -1)
        if not self.nopad:
            return flat[:, :S, :]
        # re-align: nopad logits start predicting from position L-1; the
        # first L-1 positions get zero logits, as in the JAX adapter
        pad = flat.new_zeros((B, L - 1, flat.shape[-1]))
        return torch.cat([pad, flat[:, :S - (L - 1), :]], dim=1)


class VanillaLM(_TokenizedLM):
    def __init__(self, params, cfg: NeoXConfig, tokenizer, max_length=2048,
                 batch_size=8):
        super().__init__(tokenizer, max_length, batch_size)
        self.params = params
        self.cfg = cfg

    def _logits_fn(self, inps, lengths):
        att = (torch.arange(inps.shape[1], device=inps.device)[None]
               < lengths[:, None]).to(torch.int32)
        return vmod.vanilla_forward(self.params, self.cfg, inps, att)
