"""Seq2seq ASR model of the port (``audio8_tpu/models/seq2seq.py``): the
wav2vec2 encoder and a transformer decoder with learned-positional tied
embeddings.

``Seq2Seq.forward`` is the teacher-forced forward; :meth:`Seq2Seq.decode`
the batched greedy decode through the decoder's KV cache, and
:meth:`Seq2Seq.decode_beam` the batched beam search with the GNMT length
penalty. The JAX package runs both loops on the device
(``lax.while_loop``); the port runs them on the host, one decoder step
per token, and reads ``all(done)`` back after each step. Beams are
ranked by a stable descending sort (ties to the lower flat index, as
``jax.lax.top_k`` breaks them), so the card, the CPU and JAX keep the
same beams.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from audio8_tpu_torch.config import DecoderConfig, EncoderConfig
from audio8_tpu_torch.models.text import TextTransformerDecoder, sequence_mask
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder, init_weights
from audio8_tpu_torch.utils import Offsets


def top_k_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values,
    ties broken by the lower index (a stable descending sort; CUDA's
    ``torch.topk`` promises no order among ties)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


class Seq2Seq(nn.Module):
    """``encoder`` (a ``Wav2Vec2Encoder``, fairseq names) + ``decoder``
    (a :class:`~audio8_tpu_torch.models.text.TextTransformerDecoder`, JAX
    names). ``generator``: when given at construction, the parameters
    get the JAX package's random init drawn from it."""

    def __init__(self, encoder_config: EncoderConfig,
                 decoder_config: DecoderConfig,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder_config = encoder_config
        self.decoder_config = decoder_config
        self.encoder = Wav2Vec2Encoder(encoder_config, dtype)
        self.decoder = TextTransformerDecoder(decoder_config, dtype)
        if generator is not None:
            self.init_from(generator)

    def init_from(self, generator: torch.Generator) -> None:
        init_weights(self, generator, self.encoder.mask_emb)

    def forward(self, x, input_lengths, dst, dst_lengths, generator=None,
                freeze: bool = True) -> torch.Tensor:
        """Teacher-forced forward -> (B, T_dst, V) f32 log-probs.
        ``generator``: training mode; ``freeze``: no gradient into the
        encoder (it runs under ``torch.no_grad()``, the JAX
        ``stop_gradient`` on its output)."""
        dst_mask = sequence_mask(dst_lengths, dst.shape[1])
        with torch.no_grad() if freeze else contextlib.nullcontext():
            memory, src_pad_mask = self.encoder(x, input_lengths, generator)
        return self.decoder(memory, src_pad_mask, dst, dst_mask, generator)

    @torch.no_grad()
    def decode(self, x, input_lengths, max_output_len: int = 100):
        """Batched greedy decode from GO until every row has emitted EOS
        (or ``max_output_len``). Returns (tokens (B, max_output_len),
        lengths (B,)); positions after EOS are PAD."""
        memory, src_pad_mask = self.encoder(x, input_lengths)
        cross_kv = self.decoder.compute_cross_kv(memory)  # projected once
        b, dev = x.shape[0], x.device
        cache = self.decoder.init_cache(b, max_output_len + 1, dev)
        tokens = torch.full((b, max_output_len), Offsets.PAD,
                            dtype=torch.int64, device=dev)
        tok = torch.full((b, 1), Offsets.GO, dtype=torch.int64, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        pad = torch.tensor(Offsets.PAD, device=dev)
        for i in range(max_output_len):
            log_probs, cache = self.decoder.step(memory, src_pad_mask, tok,
                                                 cache, cross_kv)
            best = torch.where(done, pad, torch.argmax(log_probs, dim=-1))
            tokens[:, i] = best
            done = done | (best == Offsets.EOS)
            tok = best[:, None]
            if bool(done.all()):  # the host reads the flag every step
                break
        return tokens, (tokens != Offsets.PAD).sum(dim=-1)

    @torch.no_grad()
    def decode_beam(self, x, input_lengths, beam: int = 4,
                    max_output_len: int = 100, length_penalty: float = 0.6):
        """Batched beam search: B*K rows through the cached ``step``;
        a finished hypothesis continues only with PAD at its score. Returns
        the best hypothesis per row under ``score / ((5 + len) / 6) **
        length_penalty`` (len without EOS and PAD) and its length (EOS
        kept, as in :meth:`decode`).

        The cache is reordered as the JAX ``decode_beam`` reorders it: a
        tensor whose leading axis has B*K entries is gathered along it by
        the parents. The stacked (L, B*K, ...) keys and values lead with
        the layer axis, so (unless L == B*K) they keep each row's own
        history; the port reproduces that so both pick the same tokens."""
        k = beam
        if k <= 1:
            return self.decode(x, input_lengths, max_output_len)
        memory, src_pad_mask = self.encoder(x, input_lengths)
        b, dev = x.shape[0], x.device
        v = self.decoder_config.vocab_size
        cross_kv = self.decoder.compute_cross_kv(memory)

        def expand(t):  # row b*k + j <- utterance b
            return torch.repeat_interleave(t, k, dim=0)

        memory = expand(memory)
        src_pad_mask = (None if src_pad_mask is None
                        else expand(src_pad_mask))
        cross_kv = [(expand(ck), expand(cv)) for ck, cv in cross_kv]
        cache = self.decoder.init_cache(b * k, max_output_len + 1, dev)
        neg_inf = torch.tensor(-1e9, dtype=torch.float32, device=dev)
        tokens = torch.full((b, k, max_output_len), Offsets.PAD,
                            dtype=torch.int64, device=dev)
        tok = torch.full((b * k, 1), Offsets.GO, dtype=torch.int64,
                         device=dev)
        # only beam 0 is live at step 0, so the first expansion seeds k
        # distinct tokens
        scores = torch.where(torch.arange(k, device=dev) == 0,
                             torch.zeros((), device=dev),
                             neg_inf)[None].repeat(b, 1)
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
        pad_only = torch.full((v,), -1e9, device=dev)
        pad_only[Offsets.PAD] = 0.0
        rows = torch.arange(b, device=dev)[:, None] * k
        for i in range(max_output_len):
            log_probs, cache = self.decoder.step(memory, src_pad_mask, tok,
                                                 cache, cross_kv)
            lp = log_probs.reshape(b, k, v).float()
            lp = torch.where(done[..., None], pad_only, lp)
            cand = scores[..., None] + lp
            scores, flat = top_k_stable(cand.reshape(b, k * v), k)
            parent = torch.div(flat, v, rounding_mode="floor")
            best = flat % v
            tokens = torch.gather(tokens, 1, parent[..., None].expand(
                -1, -1, max_output_len))
            tokens[:, :, i] = best
            done = torch.gather(done, 1, parent) | (best == Offsets.EOS)
            flat_parent = (rows + parent).reshape(-1)
            cache = {name: (leaf[flat_parent]
                            if torch.is_tensor(leaf) and leaf.ndim >= 1
                            and leaf.shape[0] == b * k else leaf)
                     for name, leaf in cache.items()}
            tok = best.reshape(b * k, 1)
            if bool(done.all()):
                break
        emitted = ((tokens != Offsets.PAD)
                   & (tokens != Offsets.EOS)).sum(dim=-1)
        lp_norm = ((5.0 + emitted.float()) / 6.0) ** length_penalty
        best_beam = torch.argmax(scores / lp_norm, dim=-1)
        out = tokens[torch.arange(b, device=dev), best_beam]
        return out, (out != Offsets.PAD).sum(dim=-1)


def create_seq2seq_model(vocab_size: int,
                         encoder_config: Optional[EncoderConfig] = None,
                         decoder_config: Optional[DecoderConfig] = None,
                         dtype: torch.dtype = torch.float32,
                         generator: Optional[torch.Generator] = None,
                         **kwargs) -> Seq2Seq:
    """The JAX factory: a 12-layer encoder and a 2-layer, 4-head decoder
    with learned-positional tied embeddings, unless configs are given."""
    enc = encoder_config or EncoderConfig(
        **{k: v for k, v in kwargs.items()
           if k in EncoderConfig.__dataclass_fields__})
    dec = decoder_config or DecoderConfig(
        vocab_size=vocab_size, d_model=enc.d_model,
        num_heads=int(kwargs.get("decoder_heads", 4)),
        num_layers=int(kwargs.get("decoder_layers", 2)),
        dropout=float(kwargs.get("decoder_dropout", 0.1)),
        layer_drop=float(kwargs.get("decoder_layer_drop", 0.0)))
    return Seq2Seq(enc, dec, dtype, generator)
