"""The port's serving surface beyond greedy ``/transcribe``, against the
JAX package's ``cli/serve.py`` on the same weights (fairseq CTC ids:
blank ``<s>`` = 0, ``|`` the word bar):

* ``/transcribe`` with ``--beam 4`` and a Kneser-Ney trigram ARPA
  (``ops/ngram.py``) and timestamps: the JAX ``TranscribeService``'s
  text and words (times equal, confidences within 1e-3: they are
  ``exp`` of mean log-probs that differ by 1e-5, rounded to 4 places);
* ``/stream``: chunked s16 PCM in, ndjson partials out, the final line
  with the text ``/transcribe`` gives on the same samples; an unknown
  ``X-Audio-Format`` is a 400;
* ``/metrics``: the JAX server's exposition text, line for line, after
  the same requests (the seconds' values aside);
* 4 concurrent beam+LM decodes equal the serial ones.
"""
import contextlib
import io
import json
import re
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu import serve as jax_serve
from audio8_tpu.cli import serve as jax_cli
from audio8_tpu.config import AcousticConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.ops.beam import PrefixBeamSearch as JaxBeam
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch import serve
from audio8_tpu_torch.cli import serve as cli
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.ops.beam import PrefixBeamSearch
from audio8_tpu_torch.ops.ngram import train_kneser_ney
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

VOCAB = ["<s>", "<pad>", "</s>", "<unk>", "|", "a", "b", "c", "d", "e"]
I2V = dict(enumerate(VOCAB))
CFG = AcousticConfig(
    num_labels=len(VOCAB), d_model=32, num_heads=2, num_layers=1, d_ff=64,
    dropout=0.0, timestep_masking=0.0, channel_masking=0.0,
    custom_conv_features=((32, 10, 5), (32, 3, 2), (32, 3, 2), (32, 3, 2),
                          (32, 3, 2), (32, 2, 2), (32, 2, 2)))
CHUNK, CONTEXT = 32_000, 4_000
CONF_TOL = 1e-3
SECONDS = [0.9, 2.3, 4.1, 6.4]  # the requests: one or several chunks


@pytest.fixture(autouse=True)
def _fairseq_ids():
    saved = (Offsets.PAD, Offsets.GO, list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()  # the JAX conftest restores its own
    yield
    Offsets.PAD, Offsets.GO = saved[:2]
    Offsets.VALUES[:] = saved[2]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
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

    rng = np.random.default_rng(0)
    words = ["".join(rng.choice(list("abcde"), size=rng.integers(1, 4)))
             for _ in range(30)]
    sentences = [list(rng.choice(words, size=rng.integers(2, 8)))
                 for _ in range(200)]
    lm = str(tmp_path_factory.mktemp("lm") / "lm.arpa")
    train_kneser_ney(sentences, 3).write_arpa(lm)
    return jax_forward, torch_forward, lm


def _wav(seconds, seed):
    wav = np.random.default_rng(seed).normal(size=int(seconds * 16_000))
    return (wav * 0.1).astype(np.float32)


def _wav_bytes(wav):
    buf = io.BytesIO()
    wavfile.write(buf, 16_000, (wav * 32767).astype(np.int16))
    return buf.getvalue()


def _jax_service(jax_forward, lm):
    batcher = jax_serve.MicroBatcher(jax_forward, CHUNK, batch_size=2)
    ct = jax_serve.ChunkedTranscriber(jax_forward, CFG.conv_features, CHUNK,
                                      CONTEXT, 2, batcher=batcher)
    decoder = JaxBeam(VOCAB, alpha=0.7, beta=5.0, beam=4, lm_file=lm)
    return jax_cli.TranscribeService(ct, I2V, decoder, timestamps=True,
                                     info={"model": "tiny"})


def _port_service(torch_forward, lm, batch_wait_ms=2.0):
    batcher = None
    if batch_wait_ms > 0:
        batcher = serve.MicroBatcher(torch_forward, CHUNK, batch_size=2,
                                     max_wait_ms=batch_wait_ms)
    ct = serve.ChunkedTranscriber(torch_forward, CFG.conv_features, CHUNK,
                                  CONTEXT, 2, batcher=batcher)
    decoder = PrefixBeamSearch(VOCAB, alpha=0.7, beta=5.0, beam=4,
                               lm_file=lm)
    return cli.TranscribeService(ct, I2V, decoder, timestamps=True,
                                 info={"model": "tiny", "beam": 4})


@contextlib.contextmanager
def running(make_server, service):
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        if service.transcriber.batcher is not None:
            service.transcriber.batcher.close()


def _open(port, path, data=None, headers=None):
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {})
    return opener.open(req, timeout=60)


def _post(port, path, data):
    with _open(port, path, data) as r:
        return json.loads(r.read())


def assert_same_words(mine, theirs):
    assert [(w["word"], w["start"], w["end"]) for w in mine] == \
        [(w["word"], w["start"], w["end"]) for w in theirs]
    for a, b in zip(mine, theirs):
        assert abs(a["confidence"] - b["confidence"]) <= CONF_TOL


def test_beam_lm_timestamps_match_jax(setup):
    jax_forward, torch_forward, lm = setup
    jax_service = _jax_service(jax_forward, lm)
    port_service = _port_service(torch_forward, lm)
    words = 0
    try:
        for i, s in enumerate(SECONDS):
            body = _wav_bytes(_wav(s, seed=i))
            mine = port_service.transcribe(body)
            theirs = jax_service.transcribe(body)
            words += len(mine["words"])
            assert mine["text"] == theirs["text"]
            assert mine["audio_seconds"] == theirs["audio_seconds"]
            assert_same_words(mine["words"], theirs["words"])
            assert all(0 <= w["start"] < w["end"] <= s + 0.02
                       for w in mine["words"])
    finally:
        jax_service.transcriber.batcher.close()
        port_service.transcriber.batcher.close()
    assert words > 0


def _chunked(pcm: bytes, block: int):
    for i in range(0, len(pcm), block):
        yield pcm[i:i + block]


@pytest.mark.parametrize("batch_wait_ms", [2.0, 0.0])
def test_stream_ndjson_final_equals_transcribe(setup, batch_wait_ms):
    _, torch_forward, lm = setup
    wav = _wav(5.3, seed=11)
    pcm = (np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes()
    service = _port_service(torch_forward, lm, batch_wait_ms)
    with running(cli.make_server, service) as port:
        want = _post(port, "/transcribe", _wav_bytes(wav))
        # urllib sends an iterable body with chunked transfer encoding
        with _open(port, "/stream", _chunked(pcm, 16_000),
                   {"Transfer-Encoding": "chunked"}) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(x) for x in r.read().splitlines() if x]
        assert all("error" not in x for x in lines)
        assert all(set(x) == {"partial"} for x in lines[:-1])
        assert len(lines) >= 2  # a partial once the first chunk is stable
        assert lines[-1] == {"text": want["text"], "final": True,
                             "audio_seconds": want["audio_seconds"]}
        f32 = wav.tobytes()
        with _open(port, "/stream", f32, {"X-Audio-Format": "f32"}) as r:
            final = json.loads(r.read().splitlines()[-1])
        assert final["final"] and final["audio_seconds"] == 5.3
        with pytest.raises(urllib.error.HTTPError) as e:
            _open(port, "/stream", pcm, {"X-Audio-Format": "u8"})
        assert e.value.code == 400


def _normalised_metrics(text: str) -> list:
    """The exposition lines with the seconds' sums blanked."""
    return [re.sub(r"(a8t_request_seconds_sum\{[^}]*\}) .*", r"\1 <s>", line)
            for line in text.splitlines()]


def test_metrics_equal_jax_exposition(setup):
    jax_forward, torch_forward, lm = setup
    bodies = [_wav_bytes(_wav(s, seed=20 + i))
              for i, s in enumerate(SECONDS[:2])]
    texts = {}
    for name, make, service in (
            ("jax", jax_cli.make_server, _jax_service(jax_forward, lm)),
            ("port", cli.make_server, _port_service(torch_forward, lm))):
        with running(make, service) as port:
            for body in bodies:
                _post(port, "/transcribe", body)
            with pytest.raises(urllib.error.HTTPError):
                _post(port, "/transcribe", b"")
            with _open(port, "/stream", (np.zeros(8_000, "<i2")).tobytes()
                       ) as r:
                r.read()
            with _open(port, "/metrics") as r:
                assert r.headers["Content-Type"].startswith("text/plain")
                texts[name] = r.read().decode()
    # one dispatch per request's chunk rows on both sides
    assert _normalised_metrics(texts["port"]) == \
        _normalised_metrics(texts["jax"])
    port_lines = texts["port"].splitlines()
    assert 'a8t_requests_total{route="/transcribe",code="200"} 2' in \
        port_lines
    assert 'a8t_requests_total{route="/transcribe",code="400"} 1' in \
        port_lines
    assert 'a8t_requests_total{route="/stream",code="200"} 1' in port_lines
    assert 'a8t_request_seconds_count{route="/transcribe"} 3' in port_lines


def test_concurrent_beam_decodes_equal_serial(setup):
    _, torch_forward, lm = setup
    bodies = [_wav_bytes(_wav(s, seed=40 + i)) for i, s in enumerate(SECONDS)]
    service = _port_service(torch_forward, lm)
    with running(cli.make_server, service) as port:
        serial = [_post(port, "/transcribe", b) for b in bodies]
        out = [None] * len(bodies)

        def send(i):
            out[i] = _post(port, "/transcribe", bodies[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        with _open(port, "/healthz") as r:
            health = json.loads(r.read())
    assert health["beam"] == 4
    assert [o["text"] for o in out] == [s["text"] for s in serial]
    assert [o["words"] for o in out] == [s["words"] for s in serial]
