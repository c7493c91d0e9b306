"""The port's streaming RNN-T decode (``serve.TransducerStreamer``) on
the CPU, as ``tests/test_transducer_streaming.py`` holds JAX's: the
streamer's ids, fed in uneven pieces, equal one ``decode_frames`` run
over the offline-stitched encoder features (``ChunkedTranscriber`` over
the encoder), for a stream shorter than a chunk, one sample past it and
several chunks; the stable mid-stream prefix never changes; a finished
stream refuses more audio until ``reset``, and a short stream flushes
through the masked window. The model has the 16 kHz conv geometry at 32
channels.
"""
import numpy as np
import pytest
import torch

from audio8_tpu_torch.config import TransducerConfig
from audio8_tpu_torch.models.transducer import Transducer
from audio8_tpu_torch.ops.metrics import postproc_letters
from audio8_tpu_torch.serve import ChunkedTranscriber, TransducerStreamer
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

CHUNK, CONTEXT = 32_000, 4_000
FX = ((32, 10, 5),) + ((32, 3, 2),) * 4 + ((32, 2, 2),) * 2


@pytest.fixture(scope="module")
def stack():
    cfg = TransducerConfig(vocab_size=10, d_model=32, num_heads=2,
                           num_layers=1, d_ff=64, pred_layers=2, pred_dim=32,
                           pred_embed_dim=16, d_joint=32, dropout=0.0,
                           pred_dropout=0.0, timestep_masking=0.0,
                           channel_masking=0.0, custom_conv_features=FX)
    model = Transducer(cfg, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.joint.out.bias[Offsets.GO] += 0.5  # blanks and labels mix
    model.eval()

    @torch.inference_mode()
    def encode(signal, lengths):
        enc, frames = model.encode(signal, lengths)
        return enc.float(), frames

    @torch.inference_mode()
    def decode_init():
        return model.decode_init(1)

    @torch.inference_mode()
    def decode_frames(enc, n_frames, tokens, n, pred_out, carry):
        return model.decode_frames(enc, n_frames, tokens, n, pred_out,
                                   carry, 4)

    return cfg, encode, decode_init, decode_frames


def _single_pass(stitched, decode_init, decode_frames, budget=512):
    tokens = torch.full((1, budget), Offsets.PAD, dtype=torch.int32)
    n = torch.zeros((1,), dtype=torch.int32)
    tokens, n, _, _ = decode_frames(
        torch.from_numpy(stitched[None]),
        torch.tensor([len(stitched)], dtype=torch.int32), tokens, n,
        *decode_init())
    return tokens[0, :int(n[0])].tolist()


@pytest.mark.parametrize("n", [20_000, CHUNK + 1, 100_000])
def test_streamer_matches_offline_stitch(stack, n):
    cfg, encode, decode_init, decode_frames = stack
    wav = np.random.default_rng(n).normal(size=n).astype(np.float32)
    offline = ChunkedTranscriber(encode, cfg.conv_features,
                                 chunk_samples=CHUNK,
                                 context_samples=CONTEXT, batch_size=1)
    want = _single_pass(offline.log_probs(wav), decode_init, decode_frames)
    st = TransducerStreamer(encode, decode_init, decode_frames,
                            cfg.conv_features, chunk_samples=CHUNK,
                            context_samples=CONTEXT, window_frames=37,
                            max_output_len=512)
    i = 0
    for size in (1_000, 7, 25_000, 3_333, 50_000, 40_000):
        st.feed(wav[i:i + size])
        i += size
        if i >= n:
            break
    assert st.finish().tolist() == want and len(want) > 0


def test_streamer_partials_and_lifecycle(stack):
    cfg, encode, decode_init, decode_frames = stack
    wav = np.random.default_rng(7).normal(size=80_000).astype(np.float32)
    i2v = {i: ch for i, ch in enumerate("_^$#ABCDE|")}
    st = TransducerStreamer(encode, decode_init, decode_frames,
                            cfg.conv_features, chunk_samples=CHUNK,
                            context_samples=CONTEXT, window_frames=25,
                            max_output_len=512)
    st.feed(wav[:40_000])
    ids_mid, n_mid = st.tokens_so_far()
    assert n_mid > 0 and isinstance(st.text_so_far(i2v), str)
    st.feed(wav[40_000:])
    final = st.finish().tolist()
    assert final[:n_mid] == ids_mid  # the stable prefix never changes
    assert st.finish().tolist() == final
    with pytest.raises(RuntimeError):
        st.feed(wav[:10])
    st.reset()
    assert st.tokens_so_far() == ([], 0)
    st.feed(wav[:20_000])
    assert st.finish_text(i2v) == postproc_letters(
        [i2v[i] for i in _single_pass(ChunkedTranscriber(
            encode, cfg.conv_features, chunk_samples=CHUNK,
            context_samples=CONTEXT, batch_size=1).log_probs(wav[:20_000]),
            decode_init, decode_frames)])
