"""Paired audio <-> text dual encoder with the symmetric CLIP loss
(``audio8_tpu/models/dual_encoder.py``).

The learnable temperature is a parameter of the loss module
(``logit_scale``, the log of the inverse temperature), so it trains with
everything else: :class:`PairedModule` holds the model and the loss as
``model`` and ``loss``, the JAX ``{'model': ..., 'loss': ...}`` tree,
and the trainer's one optimizer steps both.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from audio8_tpu_torch.config import PooledConfig, TextEncoderConfig
from audio8_tpu_torch.models.text import (TextBoWPooledEncoder,
                                          TextTransformerPooledEncoder)
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2PooledEncoder,
                                              init_weights)
from audio8_tpu_torch.nn.layers import Dense


class ProjectionStack(nn.Module):
    """Optional ReLU stacking layers (``stack_{i}``) + the projection
    (``out``) to the shared space."""

    def __init__(self, input_dim: int, stacking_layers: Tuple[int, ...],
                 output_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stack = len(stacking_layers)
        for i, h in enumerate(stacking_layers):
            self.add_module(f"stack_{i}", Dense(input_dim, h, dtype=dtype))
            input_dim = h
        self.out = Dense(input_dim, output_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_stack):
            x = torch.relu(getattr(self, f"stack_{i}")(x))
        return self.out(x)


class DualEncoderModel(nn.Module):
    """The two towers, each projected to ``output_dim``."""

    def __init__(self, audio_config: PooledConfig,
                 text_config: TextEncoderConfig,
                 stacking_layers: Sequence[int] = (), output_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.audio_encoder = Wav2Vec2PooledEncoder(audio_config, dtype)
        if text_config.encoder_type == "transformer":
            self.text_encoder = TextTransformerPooledEncoder(text_config,
                                                             dtype)
        else:
            self.text_encoder = TextBoWPooledEncoder(
                text_config.vocab_size, text_config.d_model,
                text_config.reduction_type, dtype)
        self.audio_proj = ProjectionStack(self.audio_encoder.output_dim,
                                          tuple(stacking_layers), output_dim,
                                          dtype)
        self.text_proj = ProjectionStack(self.text_encoder.output_dim,
                                         tuple(stacking_layers), output_dim,
                                         dtype)

    def init_from(self, generator: torch.Generator) -> None:
        """The JAX package's random init, drawn from ``generator``."""
        init_weights(self, generator, self.audio_encoder.encoder.mask_emb)

    def encode_audio(self, x, lengths, generator=None, freeze: bool = True):
        return self.audio_proj(self.audio_encoder(x, lengths, generator,
                                                  freeze))

    def encode_text(self, ids, lengths, generator=None, freeze: bool = True):
        return self.text_proj(self.text_encoder(ids, lengths, generator,
                                                freeze))

    def forward(self, audio, audio_lengths, text, text_lengths,
                generator=None, freeze_audio: bool = True,
                freeze_text: bool = True):
        """``generator``: training mode (the audio tower draws first)."""
        a = self.encode_audio(audio, audio_lengths, generator, freeze_audio)
        t = self.encode_text(text, text_lengths, generator, freeze_text)
        return a, t


class SymmetricCLIPLoss(nn.Module):
    """InfoNCE in both directions: ``logits = exp(logit_scale) *
    normalize(a) @ normalize(t)^T``, loss = (CE(rows) + CE(cols)) / 2.
    ``logit_scale`` starts at log(1 / init_temperature) and is a
    parameter when ``learn_temperature``, else a constant."""

    def __init__(self, init_temperature: float = 0.07,
                 learn_temperature: bool = True):
        super().__init__()
        init = math.log(1.0 / init_temperature)
        if learn_temperature:
            self.logit_scale = nn.Parameter(torch.tensor(init,
                                                         dtype=torch.float32))
        else:
            self.fixed_scale = init

    def scale(self, device) -> torch.Tensor:
        if hasattr(self, "logit_scale"):
            return self.logit_scale
        return torch.tensor(self.fixed_scale, dtype=torch.float32,
                            device=device)

    def forward(self, audio_emb: torch.Tensor, text_emb: torch.Tensor,
                row_mask: Optional[torch.Tensor] = None):
        """``row_mask`` (B,) marks real rows; padding rows are left out
        both as anchors and as negatives. Returns (loss, metrics)."""
        logit_scale = self.scale(audio_emb.device)
        a, t = audio_emb.float(), text_emb.float()
        a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1,
                                                     keepdim=True), min=1e-8)
        t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1,
                                                     keepdim=True), min=1e-8)
        logits = torch.exp(logit_scale) * (a @ t.t())
        b = logits.shape[0]
        m = (torch.ones(b, device=logits.device) if row_mask is None
             else row_mask.float())
        neg = torch.where(m > 0, torch.zeros((), device=m.device),
                          torch.full((), -1e30, device=m.device))
        lse_rows = torch.logsumexp(logits + neg[None, :], dim=-1)
        lse_cols = torch.logsumexp(logits + neg[:, None], dim=0)
        diag = torch.diagonal(logits)
        denom = torch.clamp(m.sum(), min=1.0)
        loss_a = ((lse_rows - diag) * m).sum() / denom
        loss_t = ((lse_cols - diag) * m).sum() / denom
        loss = 0.5 * (loss_a + loss_t)
        hits = torch.argmax(logits + neg[None, :], dim=-1) == torch.arange(
            b, device=logits.device)
        acc = (hits.float() * m).sum() / denom
        return loss, {"clip_loss": loss, "clip_accuracy": acc,
                      "logit_scale": torch.exp(logit_scale)}


class PairedModule(nn.Module):
    """The trained parameters of paired pretraining: ``model`` (a
    :class:`DualEncoderModel`) and ``loss`` (its
    :class:`SymmetricCLIPLoss`)."""

    def __init__(self, model: DualEncoderModel, loss: SymmetricCLIPLoss):
        super().__init__()
        self.model = model
        self.loss = loss


def create_paired_model(vocab_size: int,
                        audio_config: Optional[PooledConfig] = None,
                        text_config: Optional[TextEncoderConfig] = None,
                        stacking_layers: Sequence[int] = (),
                        output_dim: int = 256,
                        dtype: torch.dtype = torch.float32,
                        **kwargs) -> DualEncoderModel:
    """The JAX factory, with its keyword defaults."""
    ac = audio_config or PooledConfig(
        d_model=int(kwargs.get("audio_d_model", 768)),
        num_heads=int(kwargs.get("audio_num_heads", 12)),
        num_layers=int(kwargs.get("audio_num_layers", 12)),
        dropout=float(kwargs.get("audio_dropout", 0.1)),
        d_ff=int(kwargs.get("audio_d_ff", 3072)),
        reduction_type=str(kwargs.get("audio_reduction_type", "max")),
        reduction_d_k=int(kwargs.get("audio_d_k", 64)),
        timestep_masking=float(kwargs.get("audio_timestep_masking", 0.5)),
        channel_masking=float(kwargs.get("audio_channel_masking", 0.1)))
    tc = text_config or TextEncoderConfig(
        vocab_size=vocab_size,
        d_model=int(kwargs.get("text_d_model", 512)),
        num_heads=int(kwargs.get("text_num_heads", 8)),
        num_layers=int(kwargs.get("text_num_layers", 8)),
        dropout=float(kwargs.get("text_dropout", 0.1)),
        d_ff=int(kwargs.get("text_d_ff", 2048)),
        rpr_k=kwargs.get("text_rpr_k", 8),
        reduction_type=str(kwargs.get("text_reduction_type", "max")),
        reduction_d_k=int(kwargs.get("text_d_k", 64)),
        encoder_type=str(kwargs.get("text_encoder_type", "transformer")))
    return DualEncoderModel(ac, tc, tuple(stacking_layers), output_dim, dtype)
