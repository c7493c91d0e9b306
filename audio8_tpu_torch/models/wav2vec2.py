"""wav2vec 2.0 models (``audio8_tpu/models/wav2vec2.py``): the CTC
acoustic model and the contrastive pretraining model.

Structure map to the JAX package (and the fairseq names the parameters
carry, so fairseq checkpoints load by prefix, ``models/convert.py``):

  ConvFeatureExtractor     feature_extractor.conv_layers.{i}.0 (conv and
                           its bias), .conv_layers.0.2 (block-0 GroupNorm)
                           or .conv_layers.{i}.2.1 (layer mode)
  AudioTransformerEncoder  encoder.pos_conv.0 (or data2vec's
                           pos_conv.{i}.0), encoder.layer_norm,
                           encoder.layers.{i} (transformer or conformer)
  Wav2Vec2Encoder          + layer_norm, post_extract_proj, mask_emb
  Wav2Vec2AcousticModel    encoder (a Wav2Vec2Encoder) + proj (CTC head)
  Wav2Vec2PooledEncoder    encoder + [proj_layer] + reduction (the paired
                           model's audio tower; JAX names past the encoder)
  GumbelVectorQuantizer    quantizer.vars, quantizer.weight_proj
  Wav2Vec2Model            the Wav2Vec2Encoder's modules at the top level
                           + quantizer, project_q, final_proj
  wav2vec2_pretrain_loss   InfoNCE over sampled negatives + diversity

Every topology of ``EncoderConfig``: the group-norm or layer-norm
extractor (with or without conv bias), post-norm or pre-norm (stable
layer norm) transformer layers, data2vec's positional stack, WavLM's
gated position bias, conformer blocks, packed Q/K/V, flash (which off a
TPU is the JAX XLA attention), causal chunks, LayerDrop and the
Mixture-of-Experts FFN (``moe_experts``: every ``moe_every``-th layer,
``nn/moe.py``; the conformer ignores the MoE fields, as the JAX
conformer stack does, and builds dense blocks).
Training mode is a forward given a ``generator`` (the trainer's
``torch.Generator``): every dropout draws its integer seed from it, in
forward order, and runs the JAX package's hash randomness with that seed
(``dropout_input``, ``dropout_features``, the encoder and residual
dropouts, attention-probability dropout in the kernel). The acoustic
model's span masks draw their seeds from it too; the pretraining model
and loss take theirs as explicit arguments (:class:`PretrainSeeds`), so a
step's randomness can be given from outside. ``freeze_fx`` runs the
acoustic model's extractor under ``torch.no_grad()`` (the JAX
``stop_gradient``), and ``freeze`` its whole encoder, except where the
MoE aux loss trains the encoder (:func:`frozen_encoder`); the
pretraining model always trains its extractor.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from audio8_tpu_torch.config import (DIVERSITY_WGT, XE_WGT, AcousticConfig,
                                     EncoderConfig, PooledConfig,
                                     PretrainConfig)
from audio8_tpu_torch.nn.conformer import ConformerBlock
from audio8_tpu_torch.nn.dropout import dropout
from audio8_tpu_torch.nn.layers import (Conv1D, Dense, GroupNorm, LayerNorm,
                                        PositionalConv, StackedPositionalConv,
                                        gelu)
from audio8_tpu_torch.nn.pooling import Reduction
from audio8_tpu_torch.nn.transformer import (TransformerEncoderLayer,
                                             run_layers, wavlm_position_bias)
from audio8_tpu_torch.ops.hashrand import (draw_seed, hash_gumbel,
                                           hash_randint, row_base)
from audio8_tpu_torch.ops.masks import (compact_mask_indices, num_spans,
                                        span_mask)
from audio8_tpu_torch.parallel.sharding import global_sum, row_offset


def check_supported(cfg: EncoderConfig) -> None:
    """Raise for a config the port cannot run rather than computing
    something else silently."""
    if cfg.fused_attention not in (None, True, "block"):
        raise NotImplementedError(
            f"fused_attention={cfg.fused_attention!r} is not a setting of "
            "the JAX package (ROADMAP.md): None, True or 'block' "
            "(nn/transformer.py's dispatch table)")
    if cfg.extractor_mode not in ("group", "layer"):
        raise ValueError(f"extractor_mode {cfg.extractor_mode!r}: want "
                         "'group' or 'layer'")
    if cfg.encoder_type not in ("transformer", "conformer"):
        raise ValueError(f"encoder_type {cfg.encoder_type!r}: want "
                         "'transformer' or 'conformer'")


class _Block(nn.Module):
    """One extractor block; children named as fairseq's Sequential
    (``0`` = conv, ``2`` = GroupNorm on block 0 in group mode, ``2.1`` =
    the channel LayerNorm of every block in layer mode)."""


class ConvFeatureExtractor(nn.Module):
    """Strided conv stack: waveform (B, T) -> frames (B, T', C). Group
    mode: conv -> [GroupNorm on block 0] -> GELU; layer mode (the
    LV-60/XLS-R layout): conv -> channel LayerNorm (f32 statistics, then
    the cast) -> GELU on every block. ``conv_bias`` adds a bias after
    each conv."""

    def __init__(self, conv_features: Sequence[Tuple[int, int, int]],
                 dtype: torch.dtype = torch.float32, mode: str = "group",
                 conv_bias: bool = False):
        super().__init__()
        self.conv_features = [tuple(b) for b in conv_features]
        self.compute_dtype = dtype
        self.mode = mode
        self.conv_layers = nn.ModuleList()
        c_in = 1
        for i, (dim, k, stride) in enumerate(self.conv_features):
            block = _Block()
            block.add_module("0", Conv1D(c_in, dim, k, stride, dtype=dtype,
                                         use_bias=conv_bias))
            if mode == "layer":
                norm = _Block()
                norm.add_module("1", LayerNorm(dim, dtype))
                block.add_module("2", norm)
            elif i == 0:
                block.add_module("2", GroupNorm(dim, dim, dtype=dtype))
            self.conv_layers.append(block)
            c_in = dim

    def forward(self, x: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``input_lengths``: optional per-row valid sample counts. When
        given, the block-0 GroupNorm takes statistics over valid frames
        only (the JAX package's masked statistics); the layer mode's
        per-frame norms need no mask."""
        x = x[..., None].to(self.compute_dtype)
        for i, ((_, k, stride), block) in enumerate(
                zip(self.conv_features, self.conv_layers)):
            x = getattr(block, "0")(x)
            if self.mode == "layer":
                x = getattr(getattr(block, "2"), "1")(x)
            elif i == 0:
                mask = None
                if input_lengths is not None:
                    valid = ((input_lengths - k) // stride + 1).clamp_min(0)
                    mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                            < valid[:, None])
                x = getattr(block, "2")(x, mask)
            x = gelu(x)
        return x


def moe_aux_weight(cfg: EncoderConfig) -> float:
    """The weight of the MoE load-balance loss in the objective (the JAX
    ``train/steps.py:moe_aux_weight``), 0.0 for a dense config."""
    return float(cfg.moe_aux_weight) if cfg.moe_experts > 0 else 0.0


@contextlib.contextmanager
def frozen_encoder(cfg: EncoderConfig, freeze: bool):
    """The context an encoder runs in under ``freeze`` (no gradient into
    it; the caller detaches its output). JAX freezes by
    ``stop_gradient`` on the encoder's output, so a weighted MoE aux
    loss still trains the encoder: then the encoder runs with autograd
    and only its output is detached. Otherwise it runs under
    ``torch.no_grad()``."""
    if freeze and moe_aux_weight(cfg) <= 0.0:
        with torch.no_grad():
            yield
    else:
        yield


def causal_chunk_mask(t: int, chunk: int, left_chunks: int,
                      device=None) -> torch.Tensor:
    """(1, 1, T, T) block-causal mask: frame i attends to its own chunk
    and earlier ones (at most ``left_chunks`` back when >= 0)."""
    cid = torch.arange(t, device=device) // chunk
    ok = cid[None, :] <= cid[:, None]
    if left_chunks >= 0:
        ok &= cid[None, :] >= cid[:, None] - left_chunks
    return ok[None, None]


class AudioTransformerEncoder(nn.Module):
    """Positional embedding + transformer or conformer layers (fairseq
    ``TransformerEncoder``: ``pos_conv``, ``layer_norm``, ``layers.{i}``).

    Post-norm: ``layer_norm(x + pos_conv(x))``, dropout, layers.
    Pre-norm (stable layer norm): ``x + pos_conv(x)``, dropout, layers,
    then ``layer_norm`` (fairseq's ``encoder.layer_norm`` sits after the
    stack). ``pos_conv`` is the weight-normed conv (``pos_conv.0``) or
    data2vec's stack (``pos_conv_depth > 1``, ``pos_conv.{i}.0``); the
    conformer has none: dropout, blocks, ``layer_norm``. The layers run
    under LayerDrop in training, and with ``remat`` each is recomputed
    in the backward on its replayed seeds (:func:`run_layers`); under
    ``gated_rel_pos`` they share WavLM's bucketed position bias from
    layer 0's table. Causal chunks (``causal_chunk_frames``) AND a
    block-causal (1, 1, T, T) mask into the key mask, which sends
    attention to the composition."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg
        self.compute_dtype = dtype
        d_ff = cfg.d_ff or 4 * cfg.d_model
        if cfg.encoder_type == "conformer":
            self.layers = nn.ModuleList(
                ConformerBlock(cfg.num_heads, cfg.d_model, d_ff,
                               cfg.position_embeddings_type, cfg.rotary_base,
                               cfg.conv_depthwise_kernel_size,
                               cfg.conformer_activation, cfg.dropout,
                               cfg.attention_dropout, cfg.bf16_softmax,
                               dtype)
                for _ in range(cfg.num_layers))
        else:
            every = max(cfg.moe_every, 1)
            self.layers = nn.ModuleList(
                TransformerEncoderLayer(
                    cfg.num_heads, cfg.d_model, d_ff, dtype, cfg.dropout,
                    cfg.attention_dropout, cfg.fused_attention,
                    cfg.bf16_softmax, cfg.pre_norm, cfg.flash_attention,
                    cfg.gated_rel_pos,
                    cfg.rel_pos_buckets if cfg.gated_rel_pos and i == 0
                    else 0,
                    cfg.moe_experts if i % every == every - 1 else 0,
                    cfg.moe_top_k, cfg.moe_capacity_factor,
                    name=f"layer_{i}")
                for i in range(cfg.num_layers))
            if cfg.pos_conv_depth > 1:
                self.pos_conv = StackedPositionalConv(
                    cfg.d_model, cfg.pos_conv_depth, cfg.conv_pos_kernel,
                    cfg.conv_pos_groups, dtype)
            else:
                self.pos_conv = nn.Sequential(PositionalConv(
                    cfg.d_model, cfg.conv_pos_kernel, cfg.conv_pos_groups,
                    dtype=dtype))
        self.layer_norm = LayerNorm(cfg.d_model, dtype)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                return_hiddens: bool = False):
        """Zero padded frames, the positional embedding and norm as the
        layout says, dropout, then the layers with ``pad_mask`` as the
        attention key mask. ``return_hiddens``: ``(output, [each layer's
        output])``, the per-layer outputs taken before the pre-norm
        ``layer_norm`` (the data2vec teacher's); the conformer refuses it,
        as the JAX encoder asserts."""
        cfg = self.config
        if return_hiddens and cfg.encoder_type == "conformer":
            raise ValueError("return_hiddens: transformer stack only")
        hiddens = [] if return_hiddens else None
        if pad_mask is not None:
            x = torch.where(pad_mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
        mask = None
        if cfg.causal_chunk_frames > 0:
            mask = causal_chunk_mask(x.shape[1], cfg.causal_chunk_frames,
                                     cfg.causal_left_chunks, x.device)
        if cfg.encoder_type == "conformer":
            x = dropout(x, cfg.dropout, generator)
            if pad_mask is not None:
                kv = pad_mask[:, None, None, :]
                mask = kv if mask is None else mask & kv
            x = run_layers(self.layers, x, generator, cfg.layer_drop,
                           cfg.remat, mask=mask)
            return self.layer_norm(x)
        x = x + self.pos_conv(x)
        if not cfg.pre_norm:
            x = self.layer_norm(x)
        x = dropout(x, cfg.dropout, generator)
        bias = None
        if cfg.gated_rel_pos:
            bias = wavlm_position_bias(self.layers, x.shape[1],
                                       cfg.rel_pos_buckets,
                                       cfg.rel_pos_max_distance,
                                       self.compute_dtype)
        x = run_layers(self.layers, x, generator, cfg.layer_drop,
                       cfg.remat, hiddens=hiddens,
                       sequence_parallel=cfg.sequence_parallel,
                       key_valid=pad_mask, mask=mask, position_bias=bias)
        out = self.layer_norm(x) if cfg.pre_norm else x
        return (out, hiddens) if return_hiddens else out


def downsample_lengths(input_lengths: torch.Tensor, t_samples: int,
                       t_frames: int) -> torch.Tensor:
    """Sample lengths -> frame lengths with the reshape-all semantics: a
    frame is valid iff all ``ratio = T_samples // T'`` samples of its window
    are."""
    ratio = max(t_samples // max(t_frames, 1), 1)
    return torch.clamp(input_lengths // ratio, max=t_frames)


def init_weights(root: nn.Module, generator: torch.Generator,
                 mask_emb: nn.Parameter) -> None:
    """The JAX package's random init of a model holding a wav2vec2
    encoder: every submodule's own ``init_from`` in module order, then
    the encoder's mask embedding uniform in [0, 1)."""
    for m in root.modules():
        if hasattr(m, "init_from") and m is not root:
            m.init_from(generator)
    with torch.no_grad():
        mask_emb.uniform_(0.0, 1.0, generator=generator)


class Wav2Vec2Encoder(nn.Module):
    """Conv features -> LayerNorm -> projection -> (training-time dropout
    and masking) -> transformer."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported(cfg)
        self.config = cfg
        self.feature_extractor = ConvFeatureExtractor(
            cfg.conv_features, dtype, cfg.extractor_mode, cfg.conv_bias)
        self.layer_norm = LayerNorm(cfg.fx_dim, dtype)
        self.post_extract_proj = Dense(cfg.fx_dim, cfg.d_model, dtype=dtype)
        # replaces time-masked frames in training
        self.mask_emb = nn.Parameter(torch.zeros(cfg.d_model))
        self.encoder = AudioTransformerEncoder(cfg, dtype)

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
                           cfg.timestep_mask_len, dev, row_offset())
            features = torch.where(tm[..., None],
                                   self.mask_emb.to(features.dtype), features)
        if cfg.channel_masking > 0.0:
            cm = span_mask(draw_seed(generator), b, c, cfg.channel_masking,
                           cfg.channel_mask_len, dev, row_offset())
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
        init_weights(self, generator, self.encoder.mask_emb)

    def forward(self, x: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                freeze: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``generator``: training mode, seeds drawn from it. ``freeze``:
        no gradient into the encoder (the JAX ``stop_gradient`` on its
        output, :func:`frozen_encoder`)."""
        with frozen_encoder(self.config, freeze):
            encoded, pad_mask = self.encoder(x, input_lengths, generator)
        if freeze:
            encoded = encoded.detach()
        logits = self.proj(encoded).float()
        return torch.log_softmax(logits, dim=-1), pad_mask


class Wav2Vec2PooledEncoder(nn.Module):
    """Encoder + optional projection (``proj_layer`` to
    ``final_output_dim``) + utterance reduction -> (B, out_dim). The
    paired model's audio tower."""

    def __init__(self, cfg: PooledConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg
        self.encoder = Wav2Vec2Encoder(cfg, dtype)
        self.out_dim = cfg.final_output_dim or cfg.d_model
        if cfg.final_output_dim:
            self.proj_layer = Dense(cfg.d_model, cfg.final_output_dim,
                                    dtype=dtype)
        self.reduction = Reduction(cfg.reduction_type, self.out_dim,
                                   cfg.reduction_d_k, cfg.dropout, dtype)

    @property
    def output_dim(self) -> int:
        return self.out_dim

    def forward(self, x: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                freeze: bool = True):
        """``generator``: training mode. ``freeze``: no gradient into the
        encoder (the JAX ``stop_gradient`` on its output,
        :func:`frozen_encoder`)."""
        with frozen_encoder(self.config, freeze):
            encoded, pad_mask = self.encoder(x, input_lengths, generator)
        if freeze:
            encoded = encoded.detach()
        if self.config.final_output_dim:
            encoded = self.proj_layer(encoded)
        if pad_mask is None:
            pad_mask = torch.ones(encoded.shape[:2], dtype=torch.bool,
                                  device=encoded.device)
        return self.reduction(encoded, pad_mask, generator)


class GumbelVectorQuantizer(nn.Module):
    """Gumbel-softmax vector quantizer (the JAX ``GumbelVectorQuantizer``).

    ``vars`` (G*V, vq_dim/G), uniform [0, 1) init; ``weight_proj`` N(0, 1)
    weight, zero bias. Training (a ``gumbel_seed``) takes the hard
    straight-through Gumbel-softmax at ``temperature``; evaluation the
    argmax. The perplexity is fairseq's: per-group soft perplexity of the
    ``valid``-weighted average probabilities, summed over groups."""

    def __init__(self, input_dim: int, num_vars: int, num_groups: int,
                 vq_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if vq_dim % num_groups:
            raise ValueError(f"vq_dim {vq_dim} % num_groups {num_groups}")
        self.num_vars, self.num_groups, self.vq_dim = num_vars, num_groups, \
            vq_dim
        self.compute_dtype = dtype
        self.vars = nn.Parameter(torch.zeros(num_groups * num_vars,
                                             vq_dim // num_groups))
        self.weight_proj = Dense(input_dim, num_groups * num_vars,
                                 dtype=dtype)

    def init_from(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.vars.uniform_(0.0, 1.0, generator=generator)
            self.weight_proj.weight.copy_(torch.randn(
                self.weight_proj.weight.shape, generator=generator,
                device=generator.device))
            self.weight_proj.bias.zero_()

    def forward(self, x: torch.Tensor, temperature: float = 1.0,
                gumbel_seed: Optional[int] = None,
                valid: Optional[torch.Tensor] = None):
        """x (B, M, input_dim), valid optional (B, M) bool. Returns
        (quantized (B, M, vq_dim), perplexity scalar, codeword indices
        (B, M, G))."""
        b, m, _ = x.shape
        g, v = self.num_groups, self.num_vars
        logits = self.weight_proj(x).reshape(b, m, g, v).float()
        probs = torch.softmax(logits, dim=-1).reshape(b * m, g, v)
        if valid is None:
            avg_probs = probs.mean(dim=0)
        else:
            # the global batch's average in a data-parallel step
            w = valid.reshape(b * m, 1, 1).float()
            avg_probs = global_sum((probs * w).sum(dim=0)) / torch.clamp(
                global_sum(w.sum()), min=1.0)
        prob_ppl = torch.exp(
            -(avg_probs * torch.log(avg_probs + 1e-7)).sum(dim=-1)).sum()
        if gumbel_seed is not None:
            gumbels = hash_gumbel(logits.shape, gumbel_seed, logits.device,
                                  row_base(logits.shape, row_offset()))
            y_soft = torch.softmax((logits + gumbels) / temperature, dim=-1)
            index = y_soft.argmax(dim=-1)
            y_hard = nn.functional.one_hot(index, v).float()
            one_hot = y_hard - y_soft.detach() + y_soft  # straight-through
        else:
            index = logits.argmax(dim=-1)
            one_hot = nn.functional.one_hot(index, v).float()
        codebook = self.vars.float().reshape(g, v, -1)
        quantized = torch.einsum("bmgv,gvd->bmgd", one_hot,
                                 codebook).reshape(b, m, self.vq_dim)
        return quantized.to(self.compute_dtype), prob_ppl, index

    # the codebook utilities of the JAX quantizer (fairseq's
    # wav2vec2.py:499-533); nothing on the training path calls them

    def codebook_indices(self) -> torch.Tensor:
        """Every G-tuple of per-group codewords as flat row indices into
        ``vars``: (V**G * G,) int64, tuples in lexicographic order."""
        inds = torch.tensor(list(itertools.product(
            *[range(self.num_vars)] * self.num_groups)), dtype=torch.int64)
        return (inds + torch.arange(self.num_groups) * self.num_vars
                ).reshape(-1)

    def codebook(self) -> torch.Tensor:
        """(V**G, vq_dim) table of every composite codeword."""
        idx = self.codebook_indices().to(self.vars.device)
        return self.vars[idx].reshape(self.num_vars ** self.num_groups, -1)

    def sample_from_codebook(self, b: int, n: int,
                             generator: torch.Generator) -> torch.Tensor:
        """(b, n, vq_dim): ``b * n`` composite codewords drawn uniformly
        with replacement from ``generator`` (JAX draws them with
        ``jax.random.randint``, a stream this does not reproduce)."""
        idx = self.codebook_indices().reshape(-1, self.num_groups)
        cb_size = idx.shape[0]
        if n >= cb_size:
            raise ValueError(f"sample size {n} >= codebook size {cb_size}")
        sample = torch.randint(0, cb_size, (b * n,), generator=generator,
                               device=generator.device).cpu()
        rows = idx[sample].reshape(-1).to(self.vars.device)
        return self.vars[rows].reshape(b, n, -1)

    def to_codebook_index(self, indices: torch.Tensor) -> torch.Tensor:
        """(..., G) per-group indices -> (...,) composite codebook
        index."""
        res = torch.zeros(indices.shape[:-1], dtype=indices.dtype,
                          device=indices.device)
        for i in range(self.num_groups):
            res = res + indices[..., i] * (
                self.num_vars ** (self.num_groups - i - 1))
        return res


class PretrainSeeds(NamedTuple):
    """The integer seeds of one pretraining forward and loss: the time
    mask (drawn in evaluation too), the Gumbel noise (training), the
    channel mask (training with ``channel_masking > 0``) and the negative
    samples."""

    mask: int
    gumbel: int
    negatives: int
    channel: int = 0

    @classmethod
    def draw(cls, generator: torch.Generator) -> "PretrainSeeds":
        return cls(*(draw_seed(generator) for _ in range(4)))


class Wav2Vec2Model(nn.Module):
    """Contrastive pretraining model (the JAX ``Wav2Vec2Model``) over dense
    (un-padded) min-cropped batches, so block 0's GroupNorm is unmasked.

    Returns ``(context_masked (B, M, final_dim), targets_masked (B, M,
    final_dim), prob_ppl, valid (B, M))``: ``final_proj`` of the context
    and ``project_q`` of the quantized unmasked features at the first M
    masked frames of each row, M = num_spans(T', p, L) * L, and which of
    the M slots are real. ``generator``: when given, parameters get the
    JAX package's random init drawn from it; otherwise they are zeros and
    ones, waiting for ``load_state_dict``."""

    def __init__(self, cfg: PretrainConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        self.config = cfg
        self.feature_extractor = ConvFeatureExtractor(
            cfg.conv_features, dtype, cfg.extractor_mode, cfg.conv_bias)
        self.layer_norm = LayerNorm(cfg.fx_dim, dtype)
        self.post_extract_proj = Dense(cfg.fx_dim, cfg.d_model, dtype=dtype)
        self.mask_emb = nn.Parameter(torch.zeros(cfg.d_model))
        self.encoder = AudioTransformerEncoder(cfg, dtype)
        self.quantizer = GumbelVectorQuantizer(
            cfg.fx_dim, cfg.num_vq_vars, cfg.num_vq_groups, cfg.final_dim,
            dtype)
        self.project_q = Dense(cfg.final_dim, cfg.final_dim, dtype=dtype)
        self.final_proj = Dense(cfg.d_model, cfg.final_dim, dtype=dtype)
        if generator is not None:
            self.init_from(generator)

    def init_from(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if hasattr(m, "init_from") and m not in (self, self.quantizer):
                m.init_from(generator)
        self.quantizer.init_from(generator)  # after its Dense's LeCun init
        with torch.no_grad():
            self.mask_emb.uniform_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor, seeds: PretrainSeeds,
                generator: Optional[torch.Generator] = None,
                temperature: float = 2.0):
        """x (B, T) dense waveforms. ``generator``: training mode (dropout
        seeds from it, Gumbel noise from ``seeds.gumbel``); without it the
        quantizer takes the argmax. The time mask is drawn either way."""
        cfg = self.config
        train = generator is not None
        features = self.layer_norm(self.feature_extractor(x))
        unmasked = features
        features = self.post_extract_proj(features)
        b, t, c = features.shape
        dev = features.device
        features = dropout(features, cfg.dropout_input, generator)
        unmasked = dropout(unmasked, cfg.dropout_features, generator)
        time_mask = span_mask(seeds.mask, b, t, cfg.timestep_masking,
                              cfg.timestep_mask_len, dev, row_offset())
        features = torch.where(time_mask[..., None],
                               self.mask_emb.to(features.dtype), features)
        if train and cfg.channel_masking > 0.0:
            cm = span_mask(seeds.channel, b, c, cfg.channel_masking,
                           cfg.channel_mask_len, dev, row_offset())
            features = torch.where(cm[:, None, :], torch.zeros(
                (), dtype=features.dtype, device=dev), features)
        capacity = num_spans(t, cfg.timestep_masking,
                             cfg.timestep_mask_len) * cfg.timestep_mask_len
        idx, valid = compact_mask_indices(time_mask, capacity)
        y = torch.gather(unmasked, 1,
                         idx[..., None].expand(-1, -1, unmasked.shape[-1]))
        context = self.encoder(features, None, generator)
        quantized, prob_ppl, _ = self.quantizer(
            y, temperature, seeds.gumbel if train else None, valid)
        targets_masked = self.project_q(quantized)
        context_masked = self.final_proj(torch.gather(
            context, 1, idx[..., None].expand(-1, -1, context.shape[-1])))
        return context_masked, targets_masked, prob_ppl, valid


def sample_negative_indices(seed: int, batch: int, slots: int,
                            n_negatives: int, valid_counts: torch.Tensor,
                            row_offset: int = 0) -> torch.Tensor:
    """(B, M, N) in-utterance negative slot ids: uniform over the row's
    valid slots except the slot itself (draw from [0, vc - 1), shift the
    draws at or past the own slot up by one); rows with fewer than two
    valid slots clamp vc to 2. The rows are rows ``row_offset ..`` of the
    batch's draws (a data-parallel row block)."""
    vc = torch.clamp(valid_counts[:, None, None], min=2)
    r = hash_randint((batch, slots, n_negatives), seed, vc - 1,
                     row_offset * slots * n_negatives)
    own = torch.arange(slots, device=r.device)[None, :, None]
    r = r + (r >= own).to(r.dtype)
    return torch.minimum(r, vc - 1)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``x * rsqrt(max(|x|^2, eps^2))``: the clamped squared norm keeps the
    gradient finite at x = 0."""
    norm2 = (x * x).sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(norm2, min=eps * eps))


def wav2vec2_pretrain_loss(context_masked: torch.Tensor,
                           targets_masked: torch.Tensor,
                           prob_ppl: torch.Tensor, valid: torch.Tensor,
                           seed: int, n_vars: int, n_negatives: int = 100):
    """InfoNCE + diversity (the JAX ``wav2vec2_pretrain_loss``): cosine
    similarities of the masked-slot context to [its target; sampled
    negative targets], cross-entropy against index 0 averaged over valid
    slots, plus ``DIVERSITY_WGT * (n_vars - ppl) / n_vars``. ``seed``
    draws the negatives. Returns ``(loss, metrics)``. In a data-parallel
    step the slot average and the accuracy are the global batch's (sums
    over the ranks, ``parallel/sharding.py:global_sum``), as is
    ``prob_ppl``."""
    b, m, _ = context_masked.shape
    neg_idx = sample_negative_indices(seed, b, m, n_negatives,
                                      valid.sum(dim=-1), row_offset())
    c_hat = _l2_normalize(context_masked.float())
    t_hat = _l2_normalize(targets_masked.float())
    sims = torch.bmm(c_hat, t_hat.transpose(1, 2))  # (B, M, M)
    pos = torch.diagonal(sims, dim1=1, dim2=2)
    # the JAX "gather" lookup; its "onehot" mode is a TPU scheduling choice
    negs = torch.gather(sims, 2, neg_idx)
    logits = torch.cat([pos[..., None], negs], dim=2)
    xe = torch.logsumexp(logits, dim=-1) - logits[..., 0]
    w = valid.float()
    denom = torch.clamp(global_sum(w.sum()), min=1.0)
    xe_loss = global_sum((xe * w).sum() / denom)
    diversity = DIVERSITY_WGT * (n_vars - prob_ppl) / n_vars
    loss = XE_WGT * xe_loss + diversity
    correct = global_sum(((logits.argmax(dim=-1) == 0).float() * w).sum()
                         / denom)
    return loss, {"contrastive_loss": xe_loss, "diversity_loss": diversity,
                  "code_perplexity": prob_ppl, "accuracy": correct}


class Wav2Vec2Loss:
    """Negative sampling + InfoNCE bundled, the interface of the JAX
    ``Wav2Vec2Loss``: call with the model outputs and a seed."""

    def __init__(self, n_vars: int, n_negatives: int = 100):
        self.n_vars = n_vars
        self.n_negatives = n_negatives

    def __call__(self, context_masked, targets_masked, prob_ppl, valid, seed):
        return wav2vec2_pretrain_loss(context_masked, targets_masked,
                                      prob_ppl, valid, seed, self.n_vars,
                                      self.n_negatives)


def create_loss(n_vars: int, n_negatives: int = 100) -> Wav2Vec2Loss:
    return Wav2Vec2Loss(n_vars, n_negatives)


def create_model(config: Optional[PretrainConfig] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> Wav2Vec2Model:
    return Wav2Vec2Model(config or PretrainConfig(**kwargs), dtype, generator)
