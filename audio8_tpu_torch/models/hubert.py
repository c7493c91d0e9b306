"""HuBERT masked-prediction pretraining (``audio8_tpu/models/hubert.py``,
arXiv 2106.07447).

The encoder predicts offline k-means cluster ids (``cli.cluster_targets``
writes them, one per encoder frame) at span-masked frames. Logits are
cosine scores at every frame: ``final_proj`` of the context, normalised
in float32, against the normalised cluster embeddings, over
``logit_temp``; the masked/unmasked split is a weighting in the loss, so
every shape is static.

Parameters carry fairseq's HuBERT names (``feature_extractor``,
``layer_norm``, ``post_extract_proj``, ``mask_emb``, ``encoder``,
``final_proj``, ``label_embs_concat``): the body is the
``Wav2Vec2Model``'s, so a HuBERT checkpoint warm-starts the CTC model's
encoder like a wav2vec2 one, its two heads dropped.

Randomness: dropout seeds come from the trainer's ``generator`` (in
forward order, as every model of the port); the span masks take their
integer seeds as arguments (:class:`HubertSeeds`), as the pretraining
model does. The time mask applies at evaluation too (the validation
metric is masked accuracy), so evaluation takes a mask seed; the channel
mask applies in training only.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from audio8_tpu_torch.config import HubertPretrainConfig
from audio8_tpu_torch.models.wav2vec2 import (AudioTransformerEncoder,
                                              ConvFeatureExtractor,
                                              _l2_normalize, check_supported,
                                              downsample_lengths,
                                              init_weights)
from audio8_tpu_torch.nn.dropout import dropout
from audio8_tpu_torch.nn.layers import Dense, LayerNorm
from audio8_tpu_torch.ops.hashrand import draw_seed
from audio8_tpu_torch.ops.masks import span_mask
from audio8_tpu_torch.parallel.sharding import global_sum, row_offset


def ssl_encoder_config(cfg, **over):
    """The encoder config of a HuBERT or data2vec model: the JAX models
    pass neither ``fused_attention`` nor causal chunks to their encoder
    (its defaults: the XLA attention, no chunks); ``over`` sets what else
    the JAX model leaves at the encoder's defaults."""
    return dataclasses.replace(cfg, fused_attention=None,
                               causal_chunk_frames=0, **over)


class HubertSeeds(NamedTuple):
    """The span masks' integer seeds of one HuBERT forward: the time mask
    (drawn in evaluation too) and the channel mask (training with
    ``channel_masking > 0``)."""

    mask: int
    channel: int = 0

    @classmethod
    def draw(cls, generator: torch.Generator) -> "HubertSeeds":
        return cls(draw_seed(generator), draw_seed(generator))


class HubertPretrainModel(nn.Module):
    """(B, T) audio -> (logits f32 (B, T', K), time_mask (B, T') bool,
    pad_mask (B, T') bool or None). ``generator``: training mode (dropout
    seeds from it, the channel mask on). At construction, ``generator``
    gives the parameters the JAX package's random init; without it they
    are zeros and ones, waiting for ``load_state_dict``."""

    def __init__(self, cfg: HubertPretrainConfig,
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
        self.encoder = AudioTransformerEncoder(ssl_encoder_config(cfg), dtype)
        self.final_proj = Dense(cfg.d_model, cfg.final_dim, dtype=dtype)
        # the cluster codebook: cosine scores against its rows are the
        # logits (fairseq's label_embs_concat)
        self.label_embs_concat = nn.Parameter(
            torch.zeros(cfg.num_clusters, cfg.final_dim))
        if generator is not None:
            self.init_from(generator)

    def init_from(self, generator: torch.Generator) -> None:
        init_weights(self, generator, self.mask_emb)
        with torch.no_grad():
            self.label_embs_concat.uniform_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None,
                seeds: Optional[HubertSeeds] = None,
                generator: Optional[torch.Generator] = None):
        """``seeds``: the span masks' seeds, needed whenever a mask is
        drawn (the time mask in evaluation too)."""
        cfg = self.config
        if seeds is None and (cfg.timestep_masking > 0.0 or (
                generator is not None and cfg.channel_masking > 0.0)):
            raise ValueError("HuBERT draws its span masks from seeds: pass "
                             "HubertSeeds (evaluation masks too)")
        fx = self.feature_extractor(x, input_lengths)
        features = self.post_extract_proj(self.layer_norm(fx))
        features = dropout(features, cfg.dropout_input, generator)
        b, t, c = features.shape
        dev = features.device
        pad_mask = None
        if input_lengths is not None:
            frames = downsample_lengths(input_lengths, x.shape[1], t)
            pad_mask = (torch.arange(t, device=dev)[None, :]
                        < frames[:, None])
        if cfg.timestep_masking > 0.0:
            time_mask = span_mask(seeds.mask, b, t, cfg.timestep_masking,
                                  cfg.timestep_mask_len, dev, row_offset())
            features = torch.where(time_mask[..., None],
                                   self.mask_emb.to(features.dtype), features)
        else:
            time_mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
        if generator is not None and cfg.channel_masking > 0.0:
            cm = span_mask(seeds.channel, b, c, cfg.channel_masking,
                           cfg.channel_mask_len, dev, row_offset())
            features = torch.where(cm[:, None, :], torch.zeros(
                (), dtype=features.dtype, device=dev), features)
        context = self.encoder(features, pad_mask, generator)
        proj = _l2_normalize(self.final_proj(context).float())
        codes = _l2_normalize(self.label_embs_concat.float())
        logits = torch.matmul(proj, codes.t()) / cfg.logit_temp
        return logits, time_mask, pad_mask


def hubert_pretrain_loss(logits: torch.Tensor, time_mask: torch.Tensor,
                         pad_mask: Optional[torch.Tensor],
                         targets: torch.Tensor, target_lengths: torch.Tensor,
                         pred_masked_weight: float = 1.0,
                         pred_unmasked_weight: float = 0.0):
    """Masked-prediction cross-entropy over frame cluster ids (the JAX
    ``hubert_pretrain_loss``). ``targets`` (B, U) int, padded -1, is padded
    or sliced to T'; a frame counts when it has a label, lies inside the
    pad mask, and takes ``pred_masked_weight`` when masked and
    ``pred_unmasked_weight`` otherwise; both denominators clamp at 1.
    Returns ``(loss, metrics)`` with the masked accuracy (fairseq's
    correct_m / count_m) and the masked-frame count. In a data-parallel
    step the denominators and counts are the global batch's
    (``parallel/sharding.py:global_sum``)."""
    b, t, k = logits.shape
    u = targets.shape[1]
    targets = targets.long()
    if u < t:
        targets = nn.functional.pad(targets, (0, t - u), value=-1)
    else:
        targets = targets[:, :t]
    frames = torch.arange(t, device=logits.device)[None, :]
    has_label = (targets >= 0) & (
        frames < torch.clamp(target_lengths, max=t)[:, None])
    if pad_mask is not None:
        has_label = has_label & pad_mask
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.clamp(targets, 0, k - 1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    w = has_label * (pred_masked_weight * time_mask
                     + pred_unmasked_weight * (~time_mask))
    denom = torch.clamp(global_sum(w.sum()), min=1.0)
    loss = global_sum((nll * w).sum() / denom)
    m = has_label & time_mask
    correct = global_sum(((logits.argmax(dim=-1) == tgt) & m).sum())
    n_masked = global_sum(m.sum())
    metrics = {"acc_masked": correct / torch.clamp(n_masked, min=1),
               "n_masked": n_masked.float()}
    return loss, metrics
