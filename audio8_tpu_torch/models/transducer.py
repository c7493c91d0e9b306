"""RNN-T (transducer) ASR model of the port
(``audio8_tpu/models/transducer.py``): the wav2vec2 encoder, an LSTM
prediction network and an additive joint.

Parameter names: the encoder keeps fairseq's (``Wav2Vec2Encoder``); the
predictor and the joint carry the JAX names (``predictor.embed.
embedding``, ``predictor.rnn_{i}.cell.{ii,if,ig,io,hi,hf,hg,ho}``,
``joint.{enc_proj,pred_proj,out}``), so ``models/convert.py`` maps a JAX
tree by name.

:class:`LSTMCell` is flax's ``OptimizedLSTMCell`` in torch ops: gates i,
f, g, o; input kernels without a bias, hidden kernels with one;
``dense_h + dense_i``, then ``c' = f·c + i·g`` and ``h' = o·tanh(c')``
(``nn.LSTM``'s cuDNN kernel rounds otherwise in bf16). Below f32 the
products round as the JAX ``Dense`` does and the sigmoid is XLA's
op-by-op expansion (``nn/conformer.py:sigmoid``). The carry follows
JAX: the training sequence starts it in float32 (flax's
``initialize_carry`` builds it in ``param_dtype``), so under bf16 ``c``
and ``h`` stay float32 through the sequence and the predictor's output
is float32; decode builds it in the compute dtype
(:meth:`TransducerPredictor.init_carry`).

The decode loops (:meth:`Transducer.decode_frames`, the greedy search,
and :meth:`Transducer.decode_beam`) run fixed trip counts as JAX's
``fori_loop`` does: every frame takes ``max_symbols_per_frame`` rounds
(one more in the beam search), rows that finished are masked, and
nothing is read back to the host inside them. Eager PyTorch launches
each op of every (frame, round) on its own.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audio8_tpu_torch.config import TransducerConfig
from audio8_tpu_torch.models.seq2seq import top_k_stable
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2Encoder,
                                              frozen_encoder, init_weights)
from audio8_tpu_torch.nn.conformer import sigmoid
from audio8_tpu_torch.nn.dropout import dropout
from audio8_tpu_torch.nn.embeddings import LookupTableEmbeddings
from audio8_tpu_torch.nn.layers import Dense
from audio8_tpu_torch.ops.hashrand import MASK32, mul32
from audio8_tpu_torch.utils import Offsets

Carry = List[Tuple[torch.Tensor, torch.Tensor]]
GATES = ("i", "f", "g", "o")
NEG = -1.0e30


def _sigmoid_to_f32(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid(z).astype(float32)`` for ``z`` below f32 as XLA
    compiles it on the CPU: ``1 / (1 + exp(-z))`` with the exponential
    and the sum rounded in z's dtype and the quotient, which the convert
    consumes, left in float32."""
    return 1.0 / (1.0 + torch.exp(-z)).float()


class _RecurrentDense(Dense):
    """A hidden-state kernel: orthogonal init, as flax's
    ``recurrent_kernel_init``."""

    def init_from(self, generator: torch.Generator) -> None:
        w = torch.empty(self.weight.shape, device=generator.device)
        nn.init.orthogonal_(w, generator=generator)
        with torch.no_grad():
            self.weight.copy_(w)
            self.bias.zero_()


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: ``ii/if/ig/io`` (no bias) on the input,
    ``hi/hf/hg/ho`` (with bias) on ``h``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.compute_dtype = dtype
        for g in GATES:
            self.add_module(f"i{g}", Dense(in_features, features, bias=False,
                                           dtype=dtype))
        for g in GATES:
            self.add_module(f"h{g}", _RecurrentDense(features, features,
                                                     dtype=dtype))

    def packed(self):
        """(input kernel (4H, in), hidden kernel (4H, H), hidden bias
        (4H,)) in the compute dtype: the four gates' weights side by
        side, as flax concatenates them before its two products."""
        dt = self.compute_dtype
        wi = torch.cat([getattr(self, f"i{g}").weight for g in GATES])
        wh = torch.cat([getattr(self, f"h{g}").weight for g in GATES])
        bh = torch.cat([getattr(self, f"h{g}").bias for g in GATES])
        return wi.to(dt), wh.to(dt), bh.to(dt)

    def input_proj(self, x: torch.Tensor, packed) -> torch.Tensor:
        """``dense_i``: the input's product with the input kernels."""
        return F.linear(x.to(self.compute_dtype), packed[0])

    def step(self, carry, dense_i: torch.Tensor, packed):
        """One step from ``dense_i`` (the input's product): returns the
        new ``(c, h)``; ``h`` is also the output."""
        c, h = carry
        dt = self.compute_dtype
        _, wh, bh = packed
        if dt == torch.float32:
            dense_h = F.linear(h.to(dt), wh, bh)
        else:  # the JAX Dense's two roundings: product, then bias
            dense_h = F.linear(h.to(dt), wh) + bh
        zi, zf, zg, zo = (dense_h + dense_i).chunk(4, dim=-1)
        g = torch.tanh(zg)
        if c.dtype == dt:
            i, f, o = sigmoid(zi), sigmoid(zf), sigmoid(zo)
            new_c = f * c + i * g
            return new_c, o * torch.tanh(new_c)
        # a float32 carry under a lower compute dtype (the training
        # sequence): XLA leaves unrounded what JAX converts to float32
        # right away: f, o and the product i * g
        i = _sigmoid_to_f32(zi).to(dt)
        new_c = _sigmoid_to_f32(zf) * c + i.float() * g.float()
        return new_c, _sigmoid_to_f32(zo) * torch.tanh(new_c)


class _RNN(nn.Module):
    """flax ``nn.RNN`` around a cell (the ``rnn_{i}/cell`` scope)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cell = LSTMCell(in_features, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, U, in) -> (B, U, H) from a float32 zero carry."""
        b, u, _ = x.shape
        zeros = torch.zeros((b, self.cell.features), dtype=torch.float32,
                            device=x.device)
        carry = (zeros, zeros)
        packed = self.cell.packed()
        dense_i = self.cell.input_proj(x, packed)
        outs = []
        for t in range(u):
            carry = self.cell.step(carry, dense_i[:, t], packed)
            outs.append(carry[1])
        return torch.stack(outs, dim=1)


class TransducerPredictor(nn.Module):
    """Label-history network: embed -> dropout -> per layer (LSTM ->
    dropout). ``forward`` runs a whole (GO-prefixed) label sequence for
    training; :meth:`step` advances one token per row for decode."""

    def __init__(self, vocab_size: int, num_layers: int = 2,
                 d_model: int = 512, embed_dim: int = 256,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model = d_model
        self.num_layers = num_layers
        self.rate = dropout_rate
        self.compute_dtype = dtype
        self.embed = LookupTableEmbeddings(vocab_size, embed_dim, dtype)
        for i in range(num_layers):
            self.add_module(f"rnn_{i}", _RNN(embed_dim if i == 0 else d_model,
                                             d_model, dtype))

    @property
    def rnns(self) -> List[_RNN]:
        return [getattr(self, f"rnn_{i}") for i in range(self.num_layers)]

    def init_carry(self, batch: int, device=None) -> Carry:
        """Zero decode carry in the compute dtype (JAX ``init_carry``)."""
        zeros = torch.zeros((batch, self.d_model), dtype=self.compute_dtype,
                            device=device)
        return [(zeros, zeros) for _ in range(self.num_layers)]

    def forward(self, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """(B, U1) token ids -> (B, U1, d_model) prediction states;
        ``generator``: training mode (dropout seeds drawn from it)."""
        x = dropout(self.embed(ids), self.rate, generator)
        for rnn in self.rnns:
            x = dropout(rnn(x), self.rate, generator)
        return x

    def packed(self):
        """Every layer's :meth:`LSTMCell.packed` weights, built once per
        decode call."""
        return [rnn.cell.packed() for rnn in self.rnns]

    def step(self, carry: Carry, tok: torch.Tensor, packed=None):
        """One decode step: tok (B,) -> (out (B, d), carry)."""
        packed = packed or self.packed()
        x = self.embed(tok)
        new_carry = []
        for rnn, state, p in zip(self.rnns, carry, packed):
            state = rnn.cell.step(state, rnn.cell.input_proj(x, p), p)
            new_carry.append(state)
            x = state[1]
        return x, new_carry


class TransducerJoint(nn.Module):
    """Additive joint: ``out(tanh(enc_proj(enc) + pred_proj(pred)))``,
    logits cast to float32."""

    def __init__(self, d_enc: int, d_pred: int, vocab_size: int,
                 d_joint: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.enc_proj = Dense(d_enc, d_joint, dtype=dtype)
        self.pred_proj = Dense(d_pred, d_joint, dtype=dtype)
        self.out = Dense(d_joint, vocab_size, dtype=dtype)

    def forward(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """enc (B, T, d_e), pred (B, U1, d_p) -> logits (B, T, U1, V)."""
        e = self.enc_proj(enc)[:, :, None, :] + self.pred_proj(pred)[:, None]
        return self.logits(torch.tanh(e))

    def single(self, enc_t: torch.Tensor, pred_u: torch.Tensor
               ) -> torch.Tensor:
        """One lattice node per row: (B, d_e), (B, d_p) -> (B, V)."""
        return self.from_proj(self.enc_proj(enc_t), pred_u)

    def from_proj(self, enc_p: torch.Tensor, pred_u: torch.Tensor
                  ) -> torch.Tensor:
        """:meth:`single` with ``enc_proj`` already applied (decode
        projects a frame once for all its rounds)."""
        return self.logits(torch.tanh(enc_p + self.pred_proj(pred_u)))

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """``out(h).astype(float32)``: below f32 XLA rounds the product
        and adds the bias in float32 (the convert consumes the sum)."""
        out = self.out
        if out.compute_dtype == torch.float32:
            return out(h)
        dt = out.compute_dtype
        return (F.linear(h.to(dt), out.weight.to(dt)).float()
                + out.bias.to(dt).float())


class Transducer(nn.Module):
    """Encoder + predictor + joint; blank = ``Offsets.GO``.
    ``generator``: when given at construction, the parameters get the
    JAX package's random init drawn from it."""

    def __init__(self, cfg: TransducerConfig,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg
        self.compute_dtype = dtype
        self.encoder = Wav2Vec2Encoder(cfg, dtype)
        self.predictor = TransducerPredictor(
            cfg.vocab_size, cfg.pred_layers, cfg.pred_dim,
            cfg.pred_embed_dim, cfg.pred_dropout, dtype)
        self.joint = TransducerJoint(cfg.d_model, cfg.pred_dim,
                                     cfg.vocab_size, cfg.d_joint, dtype)
        if generator is not None:
            self.init_from(generator)

    def init_from(self, generator: torch.Generator) -> None:
        init_weights(self, generator, self.encoder.mask_emb)

    def forward(self, x: torch.Tensor, input_lengths: torch.Tensor,
                targets: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                freeze: bool = True):
        """Training forward: targets (B, U) label ids (no GO/EOS) ->
        (log_probs (B, T', U+1, V) float32, pad_mask). ``generator``:
        training mode; ``freeze``: no gradient into the encoder (the JAX
        ``stop_gradient``, ``models.wav2vec2.frozen_encoder``)."""
        with frozen_encoder(self.config, freeze):
            enc, pad_mask = self.encoder(x, input_lengths, generator)
        if freeze:
            enc = enc.detach()
        go = torch.full((targets.shape[0], 1), Offsets.GO,
                        dtype=targets.dtype, device=targets.device)
        pred = self.predictor(torch.cat([go, targets], dim=1), generator)
        logits = self.joint(enc, pred)
        return torch.log_softmax(logits, dim=-1), pad_mask

    def encode(self, x: torch.Tensor, input_lengths: torch.Tensor):
        """(B, T) waveform -> (enc (B, T', D), frame_lengths (B,) int32)."""
        enc, pad_mask = self.encoder(x, input_lengths)
        b, t_max, _ = enc.shape
        frame_lengths = (pad_mask.sum(dim=-1).to(torch.int32)
                         if pad_mask is not None else
                         torch.full((b,), t_max, dtype=torch.int32,
                                    device=enc.device))
        return enc, frame_lengths

    def decode_init(self, batch: int, device=None):
        """Fresh decode state: the predictor advanced once on blank ->
        ``(pred_out (B, d_p), carry)``."""
        device = device or self.joint.out.weight.device
        carry = self.predictor.init_carry(batch, device)
        return self.predictor.step(carry, torch.full(
            (batch,), Offsets.GO, dtype=torch.int32, device=device))

    def decode_frames(self, enc: torch.Tensor, frame_lengths: torch.Tensor,
                      tokens: torch.Tensor, n: torch.Tensor,
                      pred_out: torch.Tensor, carry: Carry,
                      max_symbols_per_frame: int = 4, extra=(), t0=0):
        """Resumable greedy lattice search over one window of encoder
        frames (the JAX ``decode_frames``): ``(tokens, n, pred_out,
        carry)`` in and out; frames at ``t >= frame_lengths[row]`` are
        inert for that row. ``extra`` optionally carries the alignment
        buffers ``(times, lps)``: per emitted token, its global frame
        (``t0`` + local t) and its log-posterior; they are returned
        after the state when given."""
        b, t_max, _ = enc.shape
        max_output_len = tokens.shape[1]
        blank = Offsets.GO
        rows = torch.arange(b, device=enc.device)
        track = len(extra) > 0
        packed = self.predictor.packed()
        blank_t = torch.full((b,), blank, dtype=torch.int32, device=enc.device)
        tokens, n = tokens.clone(), n.clone()
        if track:
            times, lps = (e.clone() for e in extra)
        for t in range(t_max):
            # projected frame by frame: the same product at every window
            # width, the exported one-frame search's included
            enc_p = self.joint.enc_proj(enc[:, t])
            live = t < frame_lengths
            for _ in range(max_symbols_per_frame):
                logits = self.joint.from_proj(enc_p, pred_out)
                best = torch.argmax(logits, dim=-1).to(torch.int32)
                emit = live & (best != blank) & (n < max_output_len)
                pos = torch.clamp(n, max=max_output_len - 1).long()
                tokens[rows, pos] = torch.where(emit, best, tokens[rows, pos])
                if track:
                    lp_best = (logits.max(dim=-1).values
                               - torch.logsumexp(logits, dim=-1))
                    times[rows, pos] = torch.where(
                        emit, torch.full_like(times[rows, pos], t0 + t),
                        times[rows, pos])
                    lps[rows, pos] = torch.where(emit, lp_best,
                                                 lps[rows, pos])
                new_out, new_carry = self.predictor.step(
                    carry, torch.where(emit, best, blank_t), packed)
                sel = emit[:, None]
                pred_out = torch.where(sel, new_out, pred_out)
                carry = [(torch.where(sel, c2, c1), torch.where(sel, h2, h1))
                         for (c1, h1), (c2, h2) in zip(carry, new_carry)]
                n = n + emit.to(torch.int32)
                live = emit
        if track:
            return tokens, n, pred_out, carry, (times, lps)
        return tokens, n, pred_out, carry

    @torch.no_grad()
    def decode(self, x: torch.Tensor, input_lengths: torch.Tensor,
               max_output_len: int = 200, max_symbols_per_frame: int = 4,
               timed: bool = False):
        """Batched greedy decode -> (tokens (B, max_output_len) int32
        PAD-padded, lengths (B,)), plus per-token (frames, log-posteriors)
        when ``timed``."""
        enc, frame_lengths = self.encode(x, input_lengths)
        b, dev = enc.shape[0], enc.device
        pred_out, carry = self.decode_init(b, dev)
        tokens = torch.full((b, max_output_len), Offsets.PAD,
                            dtype=torch.int32, device=dev)
        n = torch.zeros((b,), dtype=torch.int32, device=dev)
        if timed:
            extra = (torch.full((b, max_output_len), -1, dtype=torch.int32,
                                device=dev),
                     torch.zeros((b, max_output_len), dtype=torch.float32,
                                 device=dev))
            tokens, n, _, _, (times, lps) = self.decode_frames(
                enc, frame_lengths, tokens, n, pred_out, carry,
                max_symbols_per_frame, extra=extra)
            return tokens, n, times, lps
        tokens, n, _, _ = self.decode_frames(
            enc, frame_lengths, tokens, n, pred_out, carry,
            max_symbols_per_frame)
        return tokens, n

    @torch.no_grad()
    def decode_beam(self, x: torch.Tensor, input_lengths: torch.Tensor,
                    beam: int = 8, max_output_len: int = 200,
                    max_symbols_per_frame: int = 4):
        """Batched time-synchronous beam search (the JAX
        ``decode_beam``) -> (tokens (B, K, max_output_len) PAD-padded,
        lengths (B, K), scores (B, K)), beams by descending score."""
        enc, frame_lengths = self.encode(x, input_lengths)
        return self.beam_search(enc, frame_lengths, beam, max_output_len,
                                max_symbols_per_frame)

    @torch.no_grad()
    def beam_search(self, enc: torch.Tensor, frame_lengths: torch.Tensor,
                    beam: int = 8, max_output_len: int = 200,
                    max_symbols_per_frame: int = 4):
        """:meth:`decode_beam` on encoder features.

        Per frame each hypothesis either closes (takes the frame's blank)
        or extends by a label, for ``max_symbols_per_frame`` rounds and a
        forced-close round. Hypotheses with equal label sequences merge:
        the candidates sort by (closed, two rolling uint32 hashes) with
        stable sorts, least significant key first (``lax.sort`` with
        ``num_keys=3``), equal runs log-sum their scores
        (``scatter_reduce`` for ``segment_max``/``segment_sum``), and the
        run head survives; top-k ties go to the lower index
        (``top_k_stable``). The hashes are uint32 with wraparound in
        int64 (``ops.hashrand.mul32``), bit-equal to JAX's, since they
        set the sort order and the run heads."""
        b, t_max, d_e = enc.shape
        dev = enc.device
        k, u_max = beam, max_output_len
        blank = Offsets.GO
        v = self.config.vocab_size
        syms = torch.arange(v - 1, device=dev)
        ext_syms = (syms + (syms >= blank).long()).to(torch.int32)
        mul1, mul2 = 1000003, 2654435761
        arange_k = torch.arange(k, device=dev)
        rows = torch.arange(b, device=dev)
        packed = self.predictor.packed()
        m2, m = k * (v - 1), k * v

        def flat_step(carry, tok):
            flat = [(c.reshape(b * k, -1), h.reshape(b * k, -1))
                    for c, h in carry]
            out, new = self.predictor.step(flat, tok.reshape(b * k), packed)
            return (out.reshape(b, k, -1),
                    [(c.reshape(b, k, -1), h.reshape(b, k, -1))
                     for c, h in new])

        pred0, carry0 = self.decode_init(b, dev)
        ids = torch.arange(1, k + 1, dtype=torch.int64, device=dev)
        score = torch.full((b, k), NEG, device=dev)
        score[:, 0] = 0.0
        state = dict(
            tokens=torch.full((b, k, u_max), Offsets.PAD, dtype=torch.int32,
                              device=dev),
            n=torch.zeros((b, k), dtype=torch.int32, device=dev),
            score=score,
            h1=ids[None].repeat(b, 1),
            h2=(ids * 7919)[None].repeat(b, 1),
            pred=pred0[:, None].expand(b, k, pred0.shape[-1]),
            carry=[(c[:, None].expand(b, k, c.shape[-1]),
                    h[:, None].expand(b, k, h.shape[-1])) for c, h in carry0])
        cand_parent = torch.cat([arange_k, arange_k.repeat_interleave(
            v - 1, output_size=m2)])[None].expand(b, m)
        cand_token = torch.cat([torch.full((k,), -1, dtype=torch.int32,
                                           device=dev),
                                ext_syms.repeat(k)])[None].expand(b, m)
        cand_closed = torch.cat([torch.ones(k, dtype=torch.int64, device=dev),
                                 torch.zeros(m2, dtype=torch.int64,
                                             device=dev)])[None].expand(b, m)
        sym_u = (ext_syms + 1).long()
        seg_base = (rows * m)[:, None]

        def round_fn(state, closed, lp, force_close):
            close_score = state["score"] + torch.where(
                closed, torch.zeros((), device=dev), lp[:, :, blank])
            lbl_ok = (~closed) & (state["n"] < u_max)
            if force_close:
                lbl_ok = torch.zeros_like(lbl_ok)
            lbl_score = torch.where(
                lbl_ok[:, :, None],
                state["score"][:, :, None] + lp[:, :, ext_syms.long()],
                torch.full((), NEG, device=dev))
            lbl_h1 = (mul32(state["h1"], mul1)[:, :, None]
                      + sym_u) & MASK32
            lbl_h2 = (mul32(state["h2"], mul2)[:, :, None]
                      + sym_u) & MASK32
            c_h1 = torch.cat([state["h1"], lbl_h1.reshape(b, m2)], dim=1)
            c_h2 = torch.cat([state["h2"], lbl_h2.reshape(b, m2)], dim=1)
            c_score = torch.cat([close_score, lbl_score.reshape(b, m2)],
                                dim=1)
            # lax.sort over (closed, h1, h2), stable: least significant
            # key first; closed and h1 share one int64 key
            _, order = torch.sort(c_h2, dim=1, stable=True)
            key = (cand_closed.gather(1, order) << 32) | c_h1.gather(1, order)
            _, o2 = torch.sort(key, dim=1, stable=True)
            order = order.gather(1, o2)
            key_s, h2_s = key.gather(1, o2), c_h2.gather(1, order)
            sc_s = c_score.gather(1, order)
            first = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                          device=dev),
                               (key_s[:, 1:] != key_s[:, :-1])
                               | (h2_s[:, 1:] != h2_s[:, :-1])], dim=1)
            seg = (torch.cumsum(first.long(), dim=1) - 1 + seg_base)
            flat_ids = seg.reshape(-1)
            flat = sc_s.reshape(-1)
            mx = torch.full((b * m,), NEG, device=dev).scatter_reduce(
                0, flat_ids, flat, "amax", include_self=False)
            mx = torch.clamp(mx, min=NEG)
            ssum = torch.zeros((b * m,), device=dev).scatter_add(
                0, flat_ids, torch.exp(flat - mx[flat_ids]))
            merged = (mx + torch.log(torch.clamp(ssum, min=1e-38)))[
                flat_ids].reshape(b, m)
            rank_score = torch.where(first, merged,
                                     torch.full((), NEG, device=dev))
            _, top = top_k_stable(rank_score, k)
            pick_idx = order.gather(1, top)  # candidate index of each pick
            parent = cand_parent.gather(1, pick_idx)
            token = cand_token.gather(1, pick_idx)
            new_closed = cand_closed.gather(1, pick_idx).bool()

            def by_parent(a):
                idx = parent.reshape(b, k, *([1] * (a.ndim - 2)))
                return torch.gather(a, 1, idx.expand(-1, -1, *a.shape[2:]))

            emitted = token >= 0
            n_par = state["n"].gather(1, parent)
            tokens = by_parent(state["tokens"])
            pos = torch.clamp(n_par, max=u_max - 1).long()
            cur = tokens.gather(2, pos[..., None])[..., 0]
            tokens = tokens.scatter(2, pos[..., None],
                                    torch.where(emitted, token, cur)[..., None])
            pred_par = by_parent(state["pred"])
            carry_par = [(by_parent(c), by_parent(h))
                         for c, h in state["carry"]]
            step_out, step_carry = flat_step(
                carry_par, torch.where(emitted, token,
                                       torch.full_like(token, blank)))
            sel = emitted[:, :, None]
            new_state = dict(
                tokens=tokens, n=n_par + emitted.to(torch.int32),
                score=merged.gather(1, top),
                h1=c_h1.gather(1, pick_idx), h2=c_h2.gather(1, pick_idx),
                pred=torch.where(sel, step_out, pred_par),
                carry=[(torch.where(sel, c2, c1), torch.where(sel, h2_, h1_))
                       for (c1, h1_), (c2, h2_) in zip(carry_par,
                                                       step_carry)])
            return new_state, new_closed

        for t in range(t_max):
            active = (t < frame_lengths)[:, None]
            closed = torch.zeros((b, k), dtype=torch.bool, device=dev)
            new = state
            enc_p = self.joint.enc_proj(enc[:, t])
            enc_t = enc_p[:, None].expand(b, k, enc_p.shape[-1])
            for r in range(max_symbols_per_frame + 1):
                lp = torch.log_softmax(self.joint.from_proj(
                    enc_t.reshape(b * k, -1),
                    new["pred"].reshape(b * k, -1)).reshape(b, k, v), dim=-1)
                new, closed = round_fn(new, closed, lp,
                                       force_close=(r == max_symbols_per_frame))
            out = {}
            for key, val in new.items():
                if key == "carry":
                    out[key] = [(torch.where(active[:, :, None], c2, c1),
                                 torch.where(active[:, :, None], h2, h1))
                                for (c1, h1), (c2, h2) in zip(state[key],
                                                              val)]
                elif val.ndim == 3:
                    out[key] = torch.where(active[:, :, None], val,
                                           state[key])
                else:
                    out[key] = torch.where(active, val, state[key])
            state = out
        order = torch.argsort(-state["score"], dim=1, stable=True)
        return (torch.gather(state["tokens"], 1, order[:, :, None].expand(
                    -1, -1, u_max)),
                state["n"].gather(1, order), state["score"].gather(1, order))


def create_transducer_model(vocab_size: int,
                            config: Optional[TransducerConfig] = None,
                            dtype: torch.dtype = torch.float32,
                            generator: Optional[torch.Generator] = None,
                            **kwargs) -> Transducer:
    """The JAX factory: a ``TransducerConfig`` from ``kwargs`` unless one
    is given."""
    cfg = config or TransducerConfig(
        vocab_size=vocab_size,
        **{k: v for k, v in kwargs.items()
           if k in TransducerConfig.__dataclass_fields__})
    return Transducer(cfg, dtype, generator)
