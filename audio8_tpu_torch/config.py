"""Typed configuration of the port (``audio8_tpu/config.py``).

The port keeps its own copy of the configuration it reads, with the JAX
package's field names and defaults, so a config built for one package
means the same in the other. Left out: the ``lane_aligned_*`` helpers
(128-lane TPU tiling, ROADMAP "Not to port").
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

# Per-sample-rate conv feature stacks: (channels, kernel, stride). 16 kHz
# has total stride 320 (receptive field 400 samples); 8 kHz 160.
CONV_FEATURES = {
    16: [(512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
         (512, 2, 2), (512, 2, 2)],
    8: [(512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 2, 2),
        (512, 2, 2)],
}

# Pretraining constants (``audio8_tpu/config.py``): Gumbel temperature
# anneal and the loss weights
START_TEMP = 2.0
END_TEMP = 0.5
TEMP_DECAY_FACTOR = 0.999995
XE_WGT = 0.1
DIVERSITY_WGT = 10.0


def conv_output_length(length: int, conv_features) -> int:
    """Exact output frame count of the strided conv stack for an input of
    ``length`` samples."""
    for _, k, s in conv_features:
        length = (length - k) // s + 1
    return length


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Wav2Vec2Encoder hyperparameters. Every field of the JAX
    ``EncoderConfig`` is here with its default; the port runs every
    topology, the Mixture-of-Experts FFN (``moe_*``) included."""

    sample_rate: int = 16
    d_model: int = 768
    num_heads: int = 12
    num_layers: int = 12
    dropout: float = 0.1
    # attention-probability dropout; None follows `dropout`
    attention_dropout: Optional[float] = None
    d_ff: Optional[int] = None
    dropout_input: float = 0.0
    dropout_features: float = 0.0
    timestep_masking: float = 0.5
    channel_masking: float = 0.1
    timestep_mask_len: int = 10
    channel_mask_len: int = 64
    layer_drop: float = 0.0
    freeze_fx: bool = True
    conv_pos_kernel: int = 128
    conv_pos_groups: int = 16
    pos_conv_depth: int = 1
    causal_chunk_frames: int = 0
    causal_left_chunks: int = -1
    gated_rel_pos: bool = False
    rel_pos_buckets: int = 320
    rel_pos_max_distance: int = 800
    encoder_type: str = "transformer"
    position_embeddings_type: str = "relative"
    conv_depthwise_kernel_size: int = 31
    rotary_base: float = 10000.0
    conformer_activation: str = "swish"
    flash_attention: bool = False
    bf16_softmax: bool = True
    packed_qkv: bool = False
    # None: the JAX XLA attention, which the port runs as its core kernel
    # in "xla" semantics; True: the core in the TPU kernel's semantics
    # where the JAX gate admits the input (T <= 1024, d_head <= 128), else
    # "xla"; "block": the attention block (projections and core in one
    # call) under the gate, else the core in "xla" semantics
    # (nn/transformer.py's table). bf16_softmax is read by "xla" under
    # bf16 compute: the logits are rounded to bf16 before the softmax.
    fused_attention: object = None
    remat: bool = False
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_every: int = 2
    moe_aux_weight: float = 0.01
    sequence_parallel: bool = False
    pre_norm: bool = False
    extractor_mode: str = "group"
    conv_bias: bool = False
    custom_conv_features: Optional[Tuple[Tuple[int, int, int], ...]] = None

    @property
    def conv_features(self) -> List[Tuple[int, int, int]]:
        if self.custom_conv_features is not None:
            return [tuple(b) for b in self.custom_conv_features]
        return CONV_FEATURES[self.sample_rate]

    @property
    def fx_dim(self) -> int:
        return self.conv_features[-1][0]


@dataclasses.dataclass(frozen=True)
class AcousticConfig(EncoderConfig):
    """CTC acoustic model."""

    num_labels: int = 32


@dataclasses.dataclass(frozen=True)
class PretrainConfig(EncoderConfig):
    """``Wav2Vec2Model`` contrastive pretraining: the quantizer's geometry,
    the Gumbel temperature anneal and the pretraining defaults, which
    differ from :class:`EncoderConfig`'s (input and feature dropout 0.1,
    time masking 0.65, no channel masking)."""

    num_vq_vars: int = 320
    num_vq_groups: int = 2
    final_dim: int = 256
    start_temp: float = START_TEMP
    end_temp: float = END_TEMP
    temp_decay_factor: float = TEMP_DECAY_FACTOR
    dropout_input: float = 0.1
    dropout_features: float = 0.1
    timestep_masking: float = 0.65
    channel_masking: float = 0.0
    n_negatives: int = 100


@dataclasses.dataclass(frozen=True)
class HubertPretrainConfig(EncoderConfig):
    """HuBERT masked-prediction pretraining (``models/hubert.py``):
    fairseq hubert-base's defaults (mask probability 0.8 in spans of 10,
    logit temperature 0.1, the loss on masked frames only)."""

    num_clusters: int = 100
    final_dim: int = 256
    logit_temp: float = 0.1
    pred_masked_weight: float = 1.0
    pred_unmasked_weight: float = 0.0
    dropout_input: float = 0.1
    timestep_masking: float = 0.80
    channel_masking: float = 0.0


@dataclasses.dataclass(frozen=True)
class Data2VecPretrainConfig(EncoderConfig):
    """data2vec-audio masked regression (``models/data2vec.py``): the
    student regresses an EMA teacher's instance-normalised average of its
    top-k layer outputs at masked frames; fairseq data2vec_audio base's
    defaults."""

    average_top_k_layers: int = 8
    ema_decay: float = 0.999
    ema_end_decay: float = 0.9999
    ema_anneal_steps: int = 30_000
    dropout_input: float = 0.0
    timestep_masking: float = 0.65
    channel_masking: float = 0.0


@dataclasses.dataclass(frozen=True)
class PooledConfig(EncoderConfig):
    """Pooled utterance encoder: the paired model's audio tower."""

    reduction_type: str = "sha"
    reduction_d_k: int = 64
    final_output_dim: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class TransducerConfig(EncoderConfig):
    """RNN-T (transducer) ASR: the wav2vec2 encoder, an LSTM prediction
    network and an additive joint (``models/transducer.py``)."""

    vocab_size: int = 0
    pred_layers: int = 2
    pred_dim: int = 512
    pred_embed_dim: int = 256
    pred_dropout: float = 0.1
    d_joint: int = 512


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """The paired model's text tower."""

    vocab_size: int = 0
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 8
    dropout: float = 0.1
    d_ff: int = 2048
    rpr_k: Optional[int] = 8
    reduction_type: str = "max"
    reduction_d_k: int = 64
    encoder_type: str = "transformer"  # or 'bow'


@dataclasses.dataclass(frozen=True)
class TextLMConfig:
    """The causal (decoder-only) text LM of n-best rescoring
    (``models/text.py:CausalTextLM``, ``cli/train_lm.py``)."""

    vocab_size: int = 0
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 6
    dropout: float = 0.1
    d_ff: int = 2048
    rpr_k: Optional[int] = 8  # relative attention: any length at eval
    block_len: int = 512      # packed training block (tokens)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """The seq2seq model's text decoder."""

    vocab_size: int = 0
    d_model: int = 768
    num_heads: int = 4
    num_layers: int = 2
    dropout: float = 0.1
    d_ff: Optional[int] = None
    layer_drop: float = 0.0
    max_len: int = 1200
