"""The port's serving path vs ``audio8_tpu.serve`` driven by the JAX model
on the same weights: stitched frame counts, log-probs and greedy text for
audio shorter and longer than one chunk, with and without the
cross-request ``MicroBatcher``; and the port's HTTP server round trip."""
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu import serve as jax_serve
from audio8_tpu.config import AcousticConfig, conv_output_length
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu_torch import serve
from audio8_tpu_torch.cli.serve import TranscribeService, make_server
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

# CONV_FEATURES[16]'s kernels and strides (total stride 320) at width 32
CFG = AcousticConfig(
    num_labels=8, d_model=32, num_heads=2, num_layers=1, d_ff=64,
    dropout=0.0, timestep_masking=0.0, channel_masking=0.0,
    custom_conv_features=((32, 10, 5), (32, 3, 2), (32, 3, 2), (32, 3, 2),
                          (32, 3, 2), (32, 2, 2), (32, 2, 2)))
CHUNK, CONTEXT = 32_000, 4_000
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
    return np.random.default_rng(seed).normal(size=n).astype(np.float32) * .1


@pytest.mark.parametrize("n", [20_000, 100_000])
@pytest.mark.parametrize("batched", [False, True])
def test_chunked_matches_jax(forwards, n, batched):
    jax_forward, torch_forward = forwards
    jb = tb = None
    if batched:
        jb = jax_serve.MicroBatcher(jax_forward, CHUNK, batch_size=2)
        tb = serve.MicroBatcher(torch_forward, CHUNK, batch_size=2)
    try:
        jct = jax_serve.ChunkedTranscriber(
            jax_forward, CFG.conv_features, CHUNK, CONTEXT, 2, batcher=jb)
        tct = serve.ChunkedTranscriber(
            torch_forward, CFG.conv_features, CHUNK, CONTEXT, 2, batcher=tb)
        wav = _wav(n, seed=n)
        lp_j, lp_t = jct.log_probs(wav), tct.log_probs(wav)
        if batched:
            assert tb.dispatches > 0 and tb.rows == len(jct._chunk_starts(n))
        assert len(lp_t) == len(lp_j) == conv_output_length(
            n, CFG.conv_features)
        np.testing.assert_allclose(lp_t, lp_j, atol=1e-4)
        assert tct.transcribe(wav, I2V) == jct.transcribe(wav, I2V)
    finally:
        for b in (jb, tb):
            if b is not None:
                b.close()


def test_batcher_propagates_errors():
    def broken(signal, lengths):
        raise RuntimeError("device fell over")

    b = serve.MicroBatcher(broken, 100, batch_size=2)
    try:
        with pytest.raises(RuntimeError, match="fell over"):
            b.submit(np.zeros(50, np.float32))
    finally:
        b.close()


def _wav_bytes(wav):
    buf = io.BytesIO()
    wavfile.write(buf, 16_000, (wav * 32767).astype(np.int16))
    return buf.getvalue()


def _request(port, path, data=None):
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    with opener.open(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_round_trip(forwards):
    _, torch_forward = forwards
    batcher = serve.MicroBatcher(torch_forward, CHUNK, batch_size=2)
    ct = serve.ChunkedTranscriber(torch_forward, CFG.conv_features, CHUNK,
                                  CONTEXT, 2, batcher=batcher)
    service = TranscribeService(ct, I2V, info={"model": "tiny"})
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    try:
        status, body = _request(port, "/healthz")
        assert status == 200 and body["ok"] and body["model"] == "tiny"
        wav = _wav(50_000, seed=7)
        status, body = _request(port, "/transcribe", _wav_bytes(wav))
        assert status == 200
        seen = (wav * 32767).astype(np.int16).astype(np.float32) / 32768.0
        assert body["text"] == ct.transcribe(seen, I2V)
        assert body["audio_seconds"] == pytest.approx(50_000 / 16_000,
                                                      abs=1e-3)
        _, health = _request(port, "/healthz")
        assert health["batcher"]["dispatches"] >= 1
        for path, data, code in (("/nope", None, 404),
                                 ("/transcribe", b"", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _request(port, path, data)
            assert e.value.code == code
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        batcher.close()
    assert not thread.is_alive()
