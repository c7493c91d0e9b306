"""The port's ``serve.StreamingTranscriber`` against the JAX package's on
the same weights: the stable prefix after every feed (lengths equal,
log-probs within the 1e-4 that ``tests/test_torch_serve.py`` holds the
chunked path to), the final log-probs within 1e-6 of the port's offline
``ChunkedTranscriber`` on dispatches of as many rows (JAX's own bound,
``tests/test_streaming.py``; 1e-5 on other row counts),
the stable prefix a prefix of the final, O(chunk) retained samples, and
the beam decoder through ``finish_text``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu import serve as jax_serve
from audio8_tpu.config import AcousticConfig, conv_output_length
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu_torch import serve
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.ops.beam import PrefixBeamSearch
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

CFG = AcousticConfig(
    num_labels=8, d_model=32, num_heads=2, num_layers=1, d_ff=64,
    dropout=0.0, timestep_masking=0.0, channel_masking=0.0,
    custom_conv_features=((32, 10, 5), (32, 3, 2), (32, 3, 2), (32, 3, 2),
                          (32, 3, 2), (32, 2, 2), (32, 2, 2)))
CHUNK, CONTEXT = 32_000, 4_000
JAX_TOL = 1e-4      # port vs JAX log-probs (f32 sum orders)
OFFLINE_TOL = 1e-6  # the stream vs the offline stitching, one package
# the port's CPU forward of a row moves by a few 1e-6 with the rows of its
# dispatch (oneDNN blocks other sums): the stream's one-row dispatches vs
# the offline transcriber's two-row ones
BATCH_TOL = 1e-5
I2V = {i: c for i, c in enumerate("_|abcdef")}


@pytest.fixture(scope="module")
def forwards():
    jm = JaxModel(config=CFG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8000), jnp.float32))["params"]

    @jax.jit
    def jax_forward(signal, lengths):
        lp, mask = jm.apply({"params": params}, signal, lengths)
        return lp, jnp.sum(mask, axis=-1)

    model = Wav2Vec2AcousticModel(CFG)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))

    @torch.inference_mode()
    def torch_forward(signal, lengths):
        lp, mask = model(signal, lengths)
        return lp, mask.sum(-1)

    return jax_forward, torch_forward


def _wav(n, seed):
    return (np.random.default_rng(seed).normal(size=n) * 0.1).astype(
        np.float32)


def _pieces(n, sizes):
    i = 0
    while i < n:
        for sz in sizes:
            yield i, min(i + sz, n)
            i += sz
            if i >= n:
                return


@pytest.mark.parametrize("n", [20_000, CHUNK, CHUNK + 1, 100_000, 97_531])
def test_stream_matches_jax_after_every_feed_and_offline(forwards, n):
    jax_forward, torch_forward = forwards
    wav = _wav(n, seed=n)
    jst = jax_serve.StreamingTranscriber(jax_forward, CFG.conv_features,
                                         CHUNK, CONTEXT)
    tst = serve.StreamingTranscriber(torch_forward, CFG.conv_features,
                                     CHUNK, CONTEXT)
    for a, b in _pieces(n, [1_000, 7, 25_000, 3_333]):
        jst.feed(wav[a:b])
        tst.feed(wav[a:b])
        mine, theirs = tst.log_probs_so_far(), jst.log_probs_so_far()
        assert mine.shape == theirs.shape
        np.testing.assert_allclose(mine, theirs, atol=JAX_TOL, rtol=0)
        assert len(tst._tail) <= CHUNK + 25_000
    final = tst.finish()
    np.testing.assert_allclose(final, jst.finish(), atol=JAX_TOL, rtol=0)
    assert len(final) == conv_output_length(n, CFG.conv_features)
    for batch, tol in ((1, OFFLINE_TOL), (2, BATCH_TOL)):
        offline = serve.ChunkedTranscriber(torch_forward, CFG.conv_features,
                                           CHUNK, CONTEXT, batch_size=batch)
        np.testing.assert_allclose(final, offline.log_probs(wav), atol=tol,
                                   rtol=tol)


def test_stable_prefix_is_prefix_of_final(forwards):
    _, torch_forward = forwards
    st = serve.StreamingTranscriber(torch_forward, CFG.conv_features,
                                    CHUNK, CONTEXT)
    wav = _wav(90_000, seed=3)
    st.feed(wav[:70_000])
    stable = st.log_probs_so_far()
    assert len(stable) > 0
    st.feed(wav[70_000:])
    np.testing.assert_array_equal(st.finish()[:len(stable)], stable)


def test_bounded_buffer(forwards):
    _, torch_forward = forwards
    st = serve.StreamingTranscriber(torch_forward, CFG.conv_features,
                                    CHUNK, CONTEXT)
    for _ in range(10):
        st.feed(np.zeros(20_000, np.float32))
        assert len(st._tail) <= CHUNK + 20_000
    assert st.samples_fed == 200_000


def test_text_lifecycle_and_beam(forwards):
    jax_forward, torch_forward = forwards
    wav = _wav(50_000, seed=5)
    st = serve.StreamingTranscriber(torch_forward, CFG.conv_features,
                                    CHUNK, CONTEXT)
    assert st.text_so_far(I2V) == ""
    st.feed(wav)
    offline = serve.ChunkedTranscriber(torch_forward, CFG.conv_features,
                                       CHUNK, CONTEXT)
    assert st.finish_text(I2V) == offline.transcribe(wav, I2V)
    decoder = PrefixBeamSearch(list(I2V.values()), beam=4)
    assert st.finish_text(I2V, decoder) == offline.transcribe(wav, I2V,
                                                               decoder)
    jst = jax_serve.StreamingTranscriber(jax_forward, CFG.conv_features,
                                         CHUNK, CONTEXT)
    jst.feed(wav)
    assert st.finish_text(I2V) == jst.finish_text(I2V)
    with pytest.raises(RuntimeError, match="finished"):
        st.feed(wav)
    st.reset()
    assert st.samples_fed == 0 and st.finish().shape == (0, 1)


def test_stream_rides_the_batcher(forwards):
    _, torch_forward = forwards
    batcher = serve.MicroBatcher(torch_forward, CHUNK, batch_size=2)
    try:
        st = serve.StreamingTranscriber(torch_forward, CFG.conv_features,
                                        CHUNK, CONTEXT, batcher=batcher)
        wav = _wav(70_000, seed=9)
        st.feed(wav)
        got = st.finish()
        assert batcher.rows == len(st._chunk_starts(len(wav)))
        offline = serve.ChunkedTranscriber(torch_forward, CFG.conv_features,
                                           CHUNK, CONTEXT, batch_size=2)
        np.testing.assert_allclose(got, offline.log_probs(wav),
                                   atol=OFFLINE_TOL, rtol=OFFLINE_TOL)
    finally:
        batcher.close()
