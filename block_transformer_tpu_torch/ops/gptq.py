"""Calibration-based INT4 / INT8 weight quantization, GPTQ (port of
``block_transformer_tpu/ops/gptq.py``).

GPTQ (Frantar et al., 2023) rounds a weight's rows one at a time against the
Gram ``H = X^T X`` of the layer's calibration inputs, and folds each row's
rounding error into the rows not yet rounded through the Cholesky factor of
``H^-1``, so that the layer's output error ``||X (W - W_hat)||`` is what is
made small, not the weight error. The output is the packed format of
``ops.quant``: split-half INT4 nibbles with contiguous group scales ``[G,
N]``, or INT8 with per-channel scales ``[N]``, so K1 and K4 serve a GPTQ
tree as they serve a round-to-nearest (RTN) one. ``act_order`` rounds rows
by descending Hessian diagonal with static group scales and puts Q back in
row order, which keeps that layout.

Layers are calibrated in forward order, each one's Grams taken from
activations through the layers already quantized (sequential
propagation). The calibration forward mirrors the teacher-forced
``block_transformer_forward`` of the NeoX family (the GPT-NeoX block decoder
and the prefix token decoder with an expansion layer) in float32, with the
plain attention (``attention_xla``) and the exact GELU. The Hessian math is
float64 with the JAX package's formulation: dead inputs (``H[i, i] <= 0``)
get a unit diagonal and a zero row, the diagonal is damped by ``damp`` times
its mean, then ``inv(H)``, ``cholesky(H^-1).T`` and a sweep over blocks of
rows; ``torch.round`` rounds half to even, as ``np.round`` does.

Everything runs on ``device``: the card unless the caller passes
``device="cpu"``. The JAX package runs the row sweep in numpy; here it
stays plain torch (about seven small ops a row) and is launch-bound on the
card.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from block_transformer_tpu_torch.models import embedder as emb
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import masks
from block_transformer_tpu_torch.ops import quant
from block_transformer_tpu_torch.ops.attention import attention_xla

f64 = torch.float64


# ---------------------------------------------------------------------------
# Error-compensated rounding of one weight matrix
# ---------------------------------------------------------------------------

def gptq_round(W, H, *, bits: int = 4, group_size: int = 128,
               damp: float = 0.01, act_order: bool = False):
    """GPTQ rounding of ``W [K, N]`` against the input Gram ``H [K, K]``, on
    W's device. Returns ``(Q int32 [K, N], scale f32 [G, N])`` for bits 4
    (grid [-7, 7], group scales over contiguous K-row ranges, as
    ``quant.quantize_int4``) or ``(Q, scale f32 [N])`` for bits 8 (per
    channel, as ``quant.quantize_int8``).

    Without ``act_order`` a group's scales are taken when the sweep enters
    the group, from the error-compensated weights (a block of rows is a
    group, so every row the scale covers is up to date). ``act_order``
    sweeps rows by descending ``H`` diagonal with static group scales from
    the original weights."""
    dev = W.device
    W = W.to(f64).clone()
    H = H.to(device=dev, dtype=f64).clone()
    K, N = W.shape
    if tuple(H.shape) != (K, K):
        raise ValueError(f"H {tuple(H.shape)} for W {tuple(W.shape)}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = 7 if bits == 4 else 127
    # divisors as tensors on the device: CUDA divides by a Python scalar
    # through its reciprocal, numpy (the JAX package's sweep) divides
    qmax_t = torch.tensor(float(qmax), dtype=f64, device=dev)
    gs = quant._int4_group_size(K, group_size) if bits == 4 else K
    G = K // gs

    # dead inputs (never active in calibration) round to 0; a unit
    # diagonal keeps the Cholesky factor defined
    diag = H.diagonal()
    dead = diag <= 0.0
    H[dead, dead] = 1.0
    W[dead, :] = 0.0

    perm = None
    scales = torch.zeros((G, N), dtype=f64, device=dev)
    if act_order:
        perm = torch.argsort(-H.diagonal(), stable=True)
        scales = torch.clamp(W.reshape(G, gs, N).abs().amax(dim=1),
                             min=1e-8) / qmax_t
        W = W[perm]
        H = H[perm][:, perm]
        row_group = (perm // gs).tolist()      # sweep position -> group

    H.diagonal().add_(damp * float(H.diagonal().mean()))

    # upper Cholesky factor of the inverse: Hinv = U^T U; U[i, i] scales
    # row i's error, U[i, i+1:] carries it forward
    U = torch.linalg.cholesky(torch.linalg.inv(H)).T.contiguous()

    Q = torch.zeros((K, N), dtype=f64, device=dev)
    t = torch.empty(N, dtype=f64, device=dev)
    block = gs if (G > 1 and not act_order) else min(128, K)
    for b0 in range(0, K, block):
        b1 = min(b0 + block, K)
        Wb = W[b0:b1]                          # a view: the sweep edits W
        Eb = torch.zeros_like(Wb)
        for i in range(b0, b1):
            j = i - b0
            if act_order:
                s = scales[row_group[i]]
            else:
                if i % gs == 0:
                    rows = Wb[j:j + gs] if G > 1 else W
                    scales[i // gs] = torch.clamp(rows.abs().amax(dim=0),
                                                  min=1e-8) / qmax_t
                s = scales[i // gs]
            w, q = Wb[j], Q[i]
            torch.div(w, s, out=q)
            q.round_().clamp_(-qmax, qmax)
            torch.mul(q, s, out=t)
            torch.div(w - t, U[i, i], out=Eb[j])
            if j + 1 < b1 - b0:
                Wb[j + 1:].addr_(U[i, i + 1:b1], Eb[j], alpha=-1)
        if b1 < K:
            W[b1:] -= U[b0:b1, b1:].T @ Eb

    if act_order:
        Q = Q[torch.argsort(perm)]
    Q = Q.to(torch.int32)
    if bits == 8:
        return Q, scales[0].float()
    return Q, scales.float()


def pack_gptq_int4(Q: torch.Tensor, scale: torch.Tensor):
    """(Q int [K, N], scale [G, N]) -> (packed int8 [K/2, N], scale f32) in
    ``quant.quantize_int4``'s split-half layout."""
    half = Q.shape[0] // 2
    q = Q.to(torch.int32)
    byte = (q[:half] & 0xF) | ((q[half:] & 0xF) << 4)
    return byte.to(torch.uint8).view(torch.int8), scale.float()


def gptq_quantize_linear_weight(w, H, *, bits: int, group_size: int,
                                damp: float = 0.01, act_order: bool = False):
    """One [K, N] kernel -> the quantized node's ``kernel_q4`` /
    ``kernel_q8`` and ``scale``."""
    Q, scale = gptq_round(w, H, bits=bits, group_size=group_size, damp=damp,
                          act_order=act_order)
    if bits == 4:
        packed, scale = pack_gptq_int4(Q, scale)
        return {"kernel_q4": packed, "scale": scale}
    return {"kernel_q8": Q.to(torch.int8), "scale": scale}


def dequantize_leaf(leaf: dict) -> torch.Tensor:
    """A ``gptq_quantize_linear_weight`` result -> its float32 weight."""
    if "kernel_q4" in leaf:
        return quant.dequantize_int4(leaf["kernel_q4"], leaf["scale"],
                                     torch.float32)
    return quant.dequantize_int8(leaf["kernel_q8"], leaf["scale"],
                                 torch.float32)


def rtn_weight(w: torch.Tensor, bits: int, group_size: int) -> torch.Tensor:
    """Round-to-nearest on the same grid, dequantized to float32."""
    if bits == 4:
        return quant.dequantize_int4(*quant.quantize_int4(w, group_size),
                                     torch.float32)
    return quant.dequantize_int8(*quant.quantize_int8(w), torch.float32)


def output_error(w: torch.Tensor, w_hat: torch.Tensor,
                 H: torch.Tensor) -> float:
    """||X (W - W_hat)|| / ||X W|| from the Gram ``H = X^T X`` (float64):
    ``sqrt(tr(D^T H D) / tr(W^T H W))``."""
    w = w.to(f64)
    d = w - w_hat.to(f64)
    num = ((H @ d) * d).sum()
    den = ((H @ w) * w).sum()
    return float(torch.sqrt(num / den))


# ---------------------------------------------------------------------------
# Calibration driver for the NeoX block-transformer family
# ---------------------------------------------------------------------------

def _gram(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked input Gram: x [B, S, K], valid [B, S] in {0, 1} -> float64
    [K, K], the sum over valid positions of x x^T."""
    x = x.to(f64) * valid.to(f64)[..., None]
    x2 = x.reshape(-1, x.shape[-1])
    return x2.T @ x2


class _Timer:
    """Seconds spent in named phases, the device synchronized at each
    boundary, when ``stats`` (a dict to fill) is given; else nothing."""

    def __init__(self, stats, device):
        self.stats, self.device = stats, device
        self.t = time.perf_counter()

    def lap(self, key: str) -> None:
        if self.stats is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stats[key] = self.stats.get(key, 0.0) + now - self.t
        self.t = now


class _StackQuantizer:
    """Sequential per-layer GPTQ over one stacked NeoX trunk
    (``{"layers": ..., "final_ln": ...}``), its four linears a layer in
    forward order. ``run`` returns the quantized ``layers`` node and the
    final-normed hidden states computed with the quantized weights."""

    def __init__(self, stack_params, cfg, *, trunk: str, bits: int,
                 group_size: int, damp: float, act_order: bool, log, stats):
        self.params = stack_params
        self.cfg = cfg
        self.trunk = trunk
        self.bits = bits
        self.group_size = group_size
        self.damp = damp
        self.act_order = act_order
        self.log = log
        self.stats = stats

    def _quantize(self, name, i, w, H, timer):
        self.log(f"    layer {i} {name}: K={w.shape[0]} N={w.shape[1]} "
                 f"bits={self.bits}")
        timer.lap(f"{self.trunk} calibration_s")
        leaf = gptq_quantize_linear_weight(
            w, H, bits=self.bits, group_size=self.group_size, damp=self.damp,
            act_order=self.act_order)
        w_hat = dequantize_leaf(leaf)
        timer.lap(f"{self.trunk} rounding_s")
        if self.stats is not None:
            self.stats.setdefault("layer_errors", []).append({
                "trunk": self.trunk, "layer": i, "linear": name,
                "K": w.shape[0], "N": w.shape[1],
                "gptq": output_error(w, w_hat, H),
                "rtn": output_error(w, rtn_weight(w, self.bits,
                                                  self.group_size), H)})
            timer.lap(f"{self.trunk} error_s")
        return leaf, w_hat

    def run(self, hs, valids, masks_, positions, timer):
        cfg = self.cfg
        if not cfg.use_parallel_residual:
            raise NotImplementedError("the GPTQ driver implements the "
                                      "parallel-residual (Pythia) layout")
        layers = self.params["layers"]
        L = layers["ln1"]["scale"].shape[0]
        dev = hs[0].device
        cos, sin = neox.rope_tables(cfg, int(positions.max()) + 1, dev)
        eps = cfg.layer_norm_eps
        out = {name: [] for name in ("qkv", "out", "up", "down")}

        def pick(node, i):
            return {k: pick(v, i) if isinstance(v, dict) else v[i].float()
                    for k, v in node.items()}

        for i in range(L):
            p = pick(layers, i)
            # QKV
            a_ins = [neox.layer_norm(h, p["ln1"], eps) for h in hs]
            H = sum(_gram(a, v) for a, v in zip(a_ins, valids))
            leaf, p["attn"]["qkv"]["kernel"] = self._quantize(
                "qkv", i, p["attn"]["qkv"]["kernel"], H, timer)
            out["qkv"].append(leaf)
            a_flats = []
            for a_in, m in zip(a_ins, masks_):
                B, S = a_in.shape[:2]
                qkv = a_in @ p["attn"]["qkv"]["kernel"] + p["attn"]["qkv"][
                    "bias"]
                qkv = qkv.reshape(B, S, 3, cfg.num_heads,
                                  cfg.head_dim).permute(2, 0, 3, 1, 4)
                q = neox.apply_rope(qkv[0], cos, sin, positions)
                k = neox.apply_rope(qkv[1], cos, sin, positions)
                attn = attention_xla(q, k, qkv[2], m)
                a_flats.append(attn.transpose(1, 2).reshape(B, S, -1))
            # attention out
            H = sum(_gram(a, v) for a, v in zip(a_flats, valids))
            leaf, p["attn"]["out"]["kernel"] = self._quantize(
                "out", i, p["attn"]["out"]["kernel"], H, timer)
            out["out"].append(leaf)
            # MLP up
            m_ins = [neox.layer_norm(h, p["ln2"], eps) for h in hs]
            H = sum(_gram(m, v) for m, v in zip(m_ins, valids))
            leaf, p["mlp"]["up"]["kernel"] = self._quantize(
                "up", i, p["mlp"]["up"]["kernel"], H, timer)
            out["up"].append(leaf)
            # MLP down
            us = [F.gelu(m @ p["mlp"]["up"]["kernel"] + p["mlp"]["up"]["bias"],
                         approximate="none") for m in m_ins]
            H = sum(_gram(u, v) for u, v in zip(us, valids))
            leaf, p["mlp"]["down"]["kernel"] = self._quantize(
                "down", i, p["mlp"]["down"]["kernel"], H, timer)
            out["down"].append(leaf)
            # advance the hidden states through the quantized layer
            hs = [h + (a @ p["attn"]["out"]["kernel"] + p["attn"]["out"][
                      "bias"]) + (u @ p["mlp"]["down"]["kernel"]
                                  + p["mlp"]["down"]["bias"])
                  for h, a, u in zip(hs, a_flats, us)]

        def stacked(name, node):
            leaves = out[name]
            return dict({k: torch.stack([lf[k] for lf in leaves])
                         for k in leaves[0]}, bias=node["bias"])

        q_layers = {
            "ln1": layers["ln1"], "ln2": layers["ln2"],
            "attn": {n: stacked(n, layers["attn"][n]) for n in ("qkv", "out")},
            "mlp": {n: stacked(n, layers["mlp"][n]) for n in ("up", "down")},
        }
        fin = [neox.layer_norm(h, {k: v.float() for k, v in
                                   self.params["final_ln"].items()}, eps)
               for h in hs]
        timer.lap(f"{self.trunk} calibration_s")
        return q_layers, fin


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@torch.no_grad()
def gptq_quantize_block_transformer(params, cfg, batches, *, bits: int = 4,
                                    group_size: int = 128,
                                    token_decoder_bits: int = None,
                                    lm_head_bits: int = None,
                                    skip_lm_head: bool = False,
                                    damp: float = 0.01,
                                    act_order: bool = False,
                                    verbose: bool = False, device="cuda",
                                    stats: dict = None):
    """Sequential GPTQ over a block-transformer parameter tree.

    ``batches``: ``(input_ids, attention_mask, block_attention_mask)``
    calibration samples in block format ([B, N, L] and [B, N]; numpy or
    tensors). Returns, on ``device``, a tree in
    ``quant.quantize_block_transformer``'s format (stacked ``kernel_q4`` /
    ``kernel_q8`` and ``scale`` nodes; the embedder, layer norms and biases
    as they were), which generation and the engine consume unchanged.
    ``token_decoder_bits`` and ``lm_head_bits`` mix precisions as there;
    ``skip_lm_head`` keeps the head in float.

    ``stats``, a dict, is filled with the seconds of each trunk's
    calibration forward (``<trunk> calibration_s``) and rounding
    (``<trunk> rounding_s``), the device synchronized at each boundary,
    and ``layer_errors``: for each linear of the two stacks, the relative
    layer-output error ``||X (W - W_hat)|| / ||X W||`` of GPTQ and of RTN
    on the same grid, from the calibration Gram (its cost goes to ``<trunk>
    error_s``)."""
    if cfg.block_decoder_cls != "gpt-neo-x":
        raise NotImplementedError("gptq: the NeoX family only")
    tdc = cfg.token_decoder
    if (tdc.cls != "gpt-neo-x" or tdc.decoding_strategy != "prefix"
            or tdc.expansion_method != "expansion_layer"):
        raise NotImplementedError("gptq: the prefix NeoX token decoder with "
                                  "an expansion layer only")
    dev = torch.device(device)
    log = (lambda *a: print("[gptq]", *a, flush=True)) if verbose else (
        lambda *a: None)
    td_bits = bits if token_decoder_bits is None else token_decoder_bits
    n = cfg.n_embedding_tokens
    ph = cfg.embedder.projection_hidden_size
    L_blk = cfg.block_length
    n_exp = cfg.n_expanded_emb
    params = _to(params, dev)
    batches = [tuple(torch.as_tensor(a).to(dev) for a in b) for b in batches]
    timer = _Timer(stats, dev)

    # ---- block decoder ----------------------------------------------------
    hs, valids, masks_ = [], [], []
    for ids, att, bam in batches:
        B, N, _ = ids.shape
        be = emb.embed_blocks(params["embedder"], cfg.embedder, L_blk, ids,
                              attention_mask=att)
        hs.append(be.reshape(B, N * n, ph).float())
        valids.append(torch.repeat_interleave(bam.to(torch.int32), n, dim=1))
        masks_.append(masks.block_decoder_train_mask(bam, n))
    S = hs[0].shape[1]
    log("block decoder:", len(batches), "calibration batches")
    sq = _StackQuantizer(params["block_decoder"], cfg.block_decoder,
                         trunk="block_decoder", bits=bits,
                         group_size=group_size, damp=damp,
                         act_order=act_order, log=log, stats=stats)
    q_bd_layers, bd_hidden = sq.run(
        hs, valids, masks_, torch.arange(S, dtype=torch.int32, device=dev),
        timer)
    q_bd = dict(params["block_decoder"], layers=q_bd_layers)

    # ---- token decoder inputs (block i conditions block i+1) --------------
    td_params = params["token_decoder"]
    exp_ins, exp_valids, td_meta = [], [], []
    for (ids, att, bam), hidden in zip(batches, bd_hidden):
        B, N, _ = ids.shape
        Bb = B * (N - 1)
        blk_s = bam[:, 1:].reshape(Bb)
        exp_ins.append(hidden[:, :-n, :].reshape(Bb, n, ph))
        exp_valids.append(blk_s.to(torch.int32)[:, None].expand(Bb, n))
        td_meta.append((ids[:, 1:, :].reshape(Bb, L_blk),
                        att[:, 1:, :].reshape(Bb, L_blk), blk_s))

    # expansion layer, at the token decoder's bits
    H = sum(_gram(x, v) for x, v in zip(exp_ins, exp_valids))
    log(f"expansion: K={ph}")
    timer.lap("token_decoder calibration_s")
    leaf = gptq_quantize_linear_weight(
        td_params["expansion"]["kernel"].float(), H, bits=td_bits,
        group_size=group_size, damp=damp, act_order=act_order)
    exp_w = dequantize_leaf(leaf)
    timer.lap("token_decoder rounding_s")
    exp_b = td_params["expansion"].get("bias")
    q_td = dict(td_params, expansion=dict(leaf) if exp_b is None else
                dict(leaf, bias=exp_b))

    td_hs, td_valids, td_masks = [], [], []
    for block_embeddings, (ids_s, att_s, blk_s) in zip(exp_ins, td_meta):
        Bb = ids_s.shape[0]
        x = block_embeddings @ exp_w
        if exp_b is not None:
            x = x + exp_b.float()
        expanded = x.reshape(Bb, n * cfg.expansion_ratio,
                             tdc.neox.hidden_size)
        tok_embeds = neox.embed_tokens(td_params, ids_s[:, :-1]).float()
        td_hs.append(torch.cat([expanded, tok_embeds], dim=1))
        td_att = att_s[:, :-1]             # the inputs after the prefix
        td_masks.append(masks.token_decoder_train_mask(td_att,
                                                       n_prefix=n_exp))
        adapted = torch.cat([torch.ones((Bb, n_exp), dtype=torch.int32,
                                        device=dev),
                             td_att.to(torch.int32)], dim=1)
        td_valids.append(adapted * blk_s.to(torch.int32)[:, None])
    log("token decoder:", len(batches), "calibration batches")
    sq_td = _StackQuantizer(td_params, tdc.neox, trunk="token_decoder",
                            bits=td_bits, group_size=group_size, damp=damp,
                            act_order=act_order, log=log, stats=stats)
    q_td["layers"], td_hidden = sq_td.run(
        td_hs, td_valids, td_masks,
        torch.arange(n_exp + L_blk - 1, dtype=torch.int32, device=dev),
        timer)

    # ---- LM head ------------------------------------------------------------
    if not skip_lm_head:
        head_bits = lm_head_bits if lm_head_bits is not None else td_bits
        H = sum(_gram(h[:, n_exp - 1:, :],
                      att_s.to(torch.int32) * blk_s.to(torch.int32)[:, None])
                for h, (_, att_s, blk_s) in zip(td_hidden, td_meta))
        log(f"lm head: bits={head_bits}")
        timer.lap("lm_head calibration_s")
        head = td_params["embed_out"]
        leaf = gptq_quantize_linear_weight(
            head["kernel"].float(), H, bits=head_bits, group_size=group_size,
            damp=damp, act_order=act_order)
        q_td["embed_out"] = dict(leaf, bias=head["bias"]) if "bias" in head \
            else leaf
        timer.lap("lm_head rounding_s")

    return dict(params, block_decoder=q_bd, token_decoder=q_td)
