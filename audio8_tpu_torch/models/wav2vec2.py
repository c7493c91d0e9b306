"""wav2vec 2.0 CTC acoustic model (``audio8_tpu/models/wav2vec2.py``).

Structure map to the JAX package (and the fairseq names the parameters
carry, so a fairseq CTC checkpoint loads by prefix, ``models/convert.py``):

  ConvFeatureExtractor     feature_extractor.conv_layers.{i}.0 (conv),
                           .conv_layers.0.2 (block-0 GroupNorm)
  AudioTransformerEncoder  encoder.pos_conv.0, encoder.layer_norm,
                           encoder.layers.{i}
  Wav2Vec2Encoder          + layer_norm, post_extract_proj, mask_emb
  Wav2Vec2AcousticModel    encoder (a Wav2Vec2Encoder) + proj (CTC head)

The group-norm extractor and post-norm encoder of wav2vec2-base/large,
for serving and for CTC fine-tuning. Training mode is a forward given a
``generator`` (the trainer's ``torch.Generator``): every stochastic op
draws its integer seed from it, in forward order, and runs the JAX
package's hash randomness with that seed (``dropout_input``, time masking
with ``mask_emb``, channel masking, the encoder and residual dropouts,
attention-probability dropout in the kernel). ``freeze_fx`` runs the
extractor under ``torch.no_grad()`` (the JAX ``stop_gradient``), and
``freeze`` the whole encoder. The other topologies of ``EncoderConfig``
are not ported yet; :func:`check_supported` refuses a config that asks
for them.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from audio8_tpu_torch.config import AcousticConfig, EncoderConfig
from audio8_tpu_torch.nn.dropout import dropout
from audio8_tpu_torch.nn.layers import (Conv1D, Dense, GroupNorm, LayerNorm,
                                        PositionalConv, gelu)
from audio8_tpu_torch.nn.transformer import TransformerEncoderStack
from audio8_tpu_torch.ops.hashrand import draw_seed
from audio8_tpu_torch.ops.masks import span_mask

# (EncoderConfig field, value the port runs, what a different value asks for)
_SUPPORTED = (
    ("pre_norm", False, "pre_norm (stable layer norm)"),
    ("extractor_mode", "group", "extractor_mode='layer'"),
    ("conv_bias", False, "conv_bias"),
    ("pos_conv_depth", 1, "pos_conv_depth > 1 (data2vec positional stack)"),
    ("gated_rel_pos", False, "gated_rel_pos (WavLM position bias)"),
    ("encoder_type", "transformer", "encoder_type='conformer'"),
    ("causal_chunk_frames", 0, "causal_chunk_frames (causal-chunk masks)"),
    ("moe_experts", 0, "moe_experts (MoE FFN)"),
    ("packed_qkv", False, "packed_qkv"),
    ("flash_attention", False, "flash_attention"),
)


def check_supported(cfg: EncoderConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run
    rather than computing something else silently."""
    for field, value, what in _SUPPORTED:
        if getattr(cfg, field) != value:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md, 'Modules to "
                "port'): the PyTorch port serves the group-norm, post-norm "
                "wav2vec2 encoder")
    if cfg.fused_attention not in (None, True):
        raise NotImplementedError(
            f"fused_attention={cfg.fused_attention!r} is not ported yet "
            "(ROADMAP.md, 'TPU kernels to port'); the port always runs the "
            "fused attention core")


class _Block(nn.Module):
    """One extractor block; children named as fairseq's Sequential
    (``0`` = conv, ``2`` = GroupNorm on block 0)."""


class ConvFeatureExtractor(nn.Module):
    """Strided conv stack: waveform (B, T) -> frames (B, T', C), group
    mode: conv -> [GroupNorm on block 0] -> GELU, no conv bias."""

    def __init__(self, conv_features: Sequence[Tuple[int, int, int]],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_features = [tuple(b) for b in conv_features]
        self.compute_dtype = dtype
        self.conv_layers = nn.ModuleList()
        c_in = 1
        for i, (dim, k, stride) in enumerate(self.conv_features):
            block = _Block()
            block.add_module("0", Conv1D(c_in, dim, k, stride, dtype=dtype))
            if i == 0:
                block.add_module("2", GroupNorm(dim, dim, dtype=dtype))
            self.conv_layers.append(block)
            c_in = dim

    def forward(self, x: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``input_lengths``: optional per-row valid sample counts. When
        given, the block-0 GroupNorm takes statistics over valid frames
        only (the JAX package's masked statistics)."""
        x = x[..., None].to(self.compute_dtype)
        for i, ((_, k, stride), block) in enumerate(
                zip(self.conv_features, self.conv_layers)):
            x = getattr(block, "0")(x)
            if i == 0:
                mask = None
                if input_lengths is not None:
                    valid = ((input_lengths - k) // stride + 1).clamp_min(0)
                    mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                            < valid[:, None])
                x = getattr(block, "2")(x, mask)
            x = gelu(x)
        return x


class AudioTransformerEncoder(TransformerEncoderStack):
    """Conv positional embedding + LayerNorm + post-norm transformer
    layers (fairseq ``TransformerEncoder``: ``pos_conv.0``,
    ``layer_norm``, ``layers.{i}``)."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 d_ff: Optional[int] = None, conv_pos_kernel: int = 128,
                 conv_pos_groups: int = 16,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 attention_dropout: Optional[float] = None,
                 layer_drop: float = 0.0):
        super().__init__(num_heads, d_model, num_layers, d_ff, dtype,
                         dropout_rate, attention_dropout, layer_drop)
        self.dropout_rate = dropout_rate
        self.pos_conv = nn.Sequential(PositionalConv(
            d_model, conv_pos_kernel, conv_pos_groups, dtype=dtype))
        self.layer_norm = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Zero padded frames, add the positional conv, LayerNorm,
        dropout, then the layers with ``pad_mask`` as the attention key
        mask."""
        if pad_mask is not None:
            x = torch.where(pad_mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
        x = self.layer_norm(x + self.pos_conv(x))
        x = dropout(x, self.dropout_rate, generator)
        return super().forward(x, pad_mask, generator)


def downsample_lengths(input_lengths: torch.Tensor, t_samples: int,
                       t_frames: int) -> torch.Tensor:
    """Sample lengths -> frame lengths with the reshape-all semantics: a
    frame is valid iff all ``ratio = T_samples // T'`` samples of its window
    are."""
    ratio = max(t_samples // max(t_frames, 1), 1)
    return torch.clamp(input_lengths // ratio, max=t_frames)


class Wav2Vec2Encoder(nn.Module):
    """Conv features -> LayerNorm -> projection -> (training-time dropout
    and masking) -> transformer."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported(cfg)
        self.config = cfg
        self.feature_extractor = ConvFeatureExtractor(cfg.conv_features, dtype)
        self.layer_norm = LayerNorm(cfg.fx_dim, dtype)
        self.post_extract_proj = Dense(cfg.fx_dim, cfg.d_model, dtype=dtype)
        # replaces time-masked frames in training
        self.mask_emb = nn.Parameter(torch.zeros(cfg.d_model))
        self.encoder = AudioTransformerEncoder(
            cfg.d_model, cfg.num_heads, cfg.num_layers, cfg.d_ff,
            cfg.conv_pos_kernel, cfg.conv_pos_groups, dtype, cfg.dropout,
            cfg.attention_dropout, cfg.layer_drop)

    def forward(self, x: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``generator``: the trainer's seed source; when given, the
        forward runs in training mode."""
        cfg = self.config
        no_grad = torch.no_grad() if cfg.freeze_fx else contextlib.nullcontext()
        with no_grad:
            fx = self.feature_extractor(x, input_lengths)
        features = self.layer_norm(fx)
        pad_mask = None
        if input_lengths is not None:
            frames = downsample_lengths(input_lengths, x.shape[1],
                                        features.shape[1])
            pad_mask = (torch.arange(features.shape[1], device=x.device)[None, :]
                        < frames[:, None])
        features = self.post_extract_proj(features)
        if generator is not None:
            features = self._train_masks(features, generator)
        return self.encoder(features, pad_mask, generator), pad_mask

    def _train_masks(self, features: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
        """``dropout_input``, then time masking (frames replaced by
        ``mask_emb``) and channel masking (channels zeroed), each span
        mask from its own seed (``audio8_tpu`` ``_features``)."""
        cfg = self.config
        b, t, c = features.shape
        dev = features.device
        features = dropout(features, cfg.dropout_input, generator)
        if cfg.timestep_masking > 0.0:
            tm = span_mask(draw_seed(generator), b, t, cfg.timestep_masking,
                           cfg.timestep_mask_len, dev)
            features = torch.where(tm[..., None],
                                   self.mask_emb.to(features.dtype), features)
        if cfg.channel_masking > 0.0:
            cm = span_mask(draw_seed(generator), b, c, cfg.channel_masking,
                           cfg.channel_mask_len, dev)
            features = torch.where(cm[:, None, :], torch.zeros(
                (), dtype=features.dtype, device=dev), features)
        return features


class Wav2Vec2AcousticModel(nn.Module):
    """Encoder + CTC projection -> (log-probs f32 (B, T', V), pad mask).

    ``generator``: when given, parameters get the JAX package's random
    init drawn from it (serving with seeded weights); otherwise they are
    zeros/ones, waiting for ``load_state_dict``."""

    def __init__(self, cfg: AcousticConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg
        self.encoder = Wav2Vec2Encoder(cfg, dtype)
        self.proj = Dense(cfg.d_model, cfg.num_labels, dtype=dtype)
        if generator is not None:
            self.init_from(generator)

    def init_from(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if hasattr(m, "init_from") and m is not self:
                m.init_from(generator)
        with torch.no_grad():
            self.encoder.mask_emb.uniform_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                freeze: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``generator``: training mode, seeds drawn from it. ``freeze``:
        no gradient into the encoder (it runs under ``torch.no_grad()``,
        the JAX ``stop_gradient`` on its output)."""
        no_grad = torch.no_grad() if freeze else contextlib.nullcontext()
        with no_grad:
            encoded, pad_mask = self.encoder(x, input_lengths, generator)
        logits = self.proj(encoded).float()
        return torch.log_softmax(logits, dim=-1), pad_mask
