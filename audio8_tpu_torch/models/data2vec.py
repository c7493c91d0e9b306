"""data2vec-audio masked regression (``audio8_tpu/models/data2vec.py``,
arXiv 2202.03555).

The student sees span-masked features and predicts, at the masked frames,
the teacher's representation of the unmasked audio: the instance-
normalised average of its top-k transformer-layer outputs. The teacher is
an exponential moving average of the student's weights. One module plays
both roles: the student (a mask seed given) returns ``final_proj`` of the
context; the teacher (no mask seed, ``collect_hiddens``) returns every
layer's output and runs with no dropout, no LayerDrop and no mask.

Parameters carry fairseq's data2vec-audio names (the ``Wav2Vec2Model``
body and ``final_proj``), so a data2vec checkpoint warm-starts the CTC
model's encoder. As in the JAX model, the encoder is always a transformer
stack: the model passes no conformer setting to it, even under a
conformer preset (a documented deviation, ROADMAP.md §3).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from audio8_tpu_torch.config import Data2VecPretrainConfig
from audio8_tpu_torch.models.hubert import ssl_encoder_config
from audio8_tpu_torch.models.wav2vec2 import (AudioTransformerEncoder,
                                              ConvFeatureExtractor,
                                              check_supported,
                                              downsample_lengths,
                                              init_weights)
from audio8_tpu_torch.nn.dropout import dropout
from audio8_tpu_torch.nn.layers import Dense, LayerNorm
from audio8_tpu_torch.ops.masks import span_mask
from audio8_tpu_torch.parallel.sharding import global_sum, row_offset

# the JAX AudioTransformerEncoder's defaults of the fields the JAX data2vec
# model does not pass on
_JAX_ENCODER_DEFAULTS = dict(
    encoder_type="transformer", position_embeddings_type="relative",
    conv_depthwise_kernel_size=31, rotary_base=10000.0,
    conformer_activation="swish")


class Data2VecAudioModel(nn.Module):
    """Student: ``(prediction (B, T', D), time_mask, pad_mask)``. Teacher
    (``collect_hiddens=True``, no mask seed): ``([(B, T', D)] per layer,
    zero time_mask, pad_mask)``. ``generator`` in ``forward``: training
    mode (dropout seeds from it); at construction, the JAX package's
    random init from it (else zeros and ones)."""

    def __init__(self, cfg: Data2VecPretrainConfig,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        self.config = cfg
        self.feature_extractor = ConvFeatureExtractor(
            cfg.conv_features, dtype, cfg.extractor_mode, cfg.conv_bias)
        self.layer_norm = LayerNorm(cfg.fx_dim, dtype)
        self.post_extract_proj = Dense(cfg.fx_dim, cfg.d_model, dtype=dtype)
        self.mask_emb = nn.Parameter(torch.zeros(cfg.d_model))
        self.encoder = AudioTransformerEncoder(
            ssl_encoder_config(cfg, **_JAX_ENCODER_DEFAULTS), dtype)
        self.final_proj = Dense(cfg.d_model, cfg.d_model, dtype=dtype)
        if generator is not None:
            init_weights(self, generator, self.mask_emb)

    def forward(self, x: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None,
                mask_seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                collect_hiddens: bool = False):
        """``mask_seed``: the time mask's seed (the student's; evaluation
        masks too); ``None`` masks nothing (the teacher)."""
        cfg = self.config
        fx = self.feature_extractor(x, input_lengths)
        features = self.post_extract_proj(self.layer_norm(fx))
        features = dropout(features, cfg.dropout_input, generator)
        b, t, _ = features.shape
        dev = features.device
        pad_mask = None
        if input_lengths is not None:
            frames = downsample_lengths(input_lengths, x.shape[1], t)
            pad_mask = (torch.arange(t, device=dev)[None, :]
                        < frames[:, None])
        if mask_seed is not None and cfg.timestep_masking > 0.0:
            time_mask = span_mask(mask_seed, b, t, cfg.timestep_masking,
                                  cfg.timestep_mask_len, dev, row_offset())
            features = torch.where(time_mask[..., None],
                                   self.mask_emb.to(features.dtype), features)
        else:
            time_mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
        if collect_hiddens:
            _, hiddens = self.encoder(features, pad_mask, generator,
                                      return_hiddens=True)
            return hiddens, time_mask, pad_mask
        context = self.encoder(features, pad_mask, generator)
        return self.final_proj(context), time_mask, pad_mask


def data2vec_targets(hiddens: List[torch.Tensor], k: int) -> torch.Tensor:
    """Instance-normalise each of the top-k layer outputs over all T'
    frames (per row and channel, no pad mask, population variance,
    ``rsqrt(var + 1e-5)``) in float32 and average them."""
    acc = None
    for h in hiddens[-k:]:
        h = h.float()
        mu = h.mean(dim=1, keepdim=True)
        var = ((h - mu) ** 2).mean(dim=1, keepdim=True)
        n = (h - mu) * torch.rsqrt(var + 1e-5)
        acc = n if acc is None else acc + n
    return acc / k


def data2vec_loss(pred: torch.Tensor, target: torch.Tensor,
                  time_mask: torch.Tensor, pad_mask: Optional[torch.Tensor]):
    """The squared error summed over channels over sqrt(D), averaged over
    the masked valid frames; also the target's and the prediction's
    standard deviation there (the collapse monitors) and the frame
    count; over the global batch in a data-parallel step
    (``parallel/sharding.py:global_sum``)."""
    d = pred.shape[-1]
    w = time_mask if pad_mask is None else (time_mask & pad_mask)
    wf = w.float()
    diff2 = ((pred.float() - target.detach()) ** 2).sum(dim=-1) \
        / float(np.sqrt(np.float32(d)))
    n_masked = global_sum(wf.sum())
    denom = torch.clamp(n_masked, min=1.0)
    loss = global_sum((diff2 * wf).sum() / denom)

    def masked_std(x):
        mu = global_sum((x * wf[..., None]).sum(dim=(0, 1))) / denom
        var = global_sum((((x - mu) ** 2) * wf[..., None]).sum(dim=(0, 1))
                         ) / denom
        return torch.sqrt(var + 1e-8).mean()

    metrics = {"target_std": masked_std(target.float()),
               "pred_std": masked_std(pred.detach().float()),
               "n_masked": n_masked}
    return loss, metrics


def ema_decay_schedule(step: int, start: float, end: float,
                       anneal_steps: int) -> float:
    """Linear anneal ``start -> end`` over ``anneal_steps`` in float32, as
    the jitted JAX step computes it on the CPU: XLA divides by the
    constant ``anneal_steps`` as a product with its float32 reciprocal and
    fuses ``start + (end - start) * frac`` into one rounding."""
    if anneal_steps <= 0:
        return float(np.float32(end))
    inv = np.float32(1.0) / np.float32(anneal_steps)
    frac = np.clip(np.float32(step) * inv, np.float32(0.0), np.float32(1.0))
    fused = np.float64(np.float32(start)) \
        + np.float64(np.float32(end - start)) * np.float64(frac)
    return float(np.float32(fused))


@torch.no_grad()
def ema_update(teacher: List[torch.Tensor], student: List[torch.Tensor],
               decay: float) -> None:
    """``teacher <- teacher * decay + student * (1 - decay)`` in place, in
    float32, as the jitted JAX step computes it: ``student * (1 - decay)``
    rounded, then the multiply-add with ``teacher * decay`` rounded once
    (XLA fuses it; the float64 sum is the same single rounding). Not
    ``lerp``, which rounds otherwise."""
    d = np.float32(decay)
    rest = torch._foreach_mul(student, float(np.float32(1.0) - d))
    for t, r in zip(teacher, rest):
        t.copy_(t.double().mul_(float(d)).add_(r.double()))
