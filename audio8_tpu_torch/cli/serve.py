"""HTTP transcription endpoint of the port (``a8t-serve`` on PyTorch).

Counterpart of ``audio8_tpu/cli/serve.py``: one process loads the model
on ``--device`` (the CUDA card by default; ``--device cpu`` asks for the
CPU), then serves

  GET  /healthz            -> {"ok": true, model info, batcher stats}
  GET  /metrics            -> Prometheus text: the JAX package's names
  POST /transcribe         -> {"text", "audio_seconds", "latency_ms"}
       (+ "words" under --timestamps); body: WAV or FLAC bytes
  POST /stream             -> ndjson: {"partial"} lines as audio arrives,
       then {"text", "final": true, "audio_seconds"}; body: raw mono
       PCM at the model's rate, chunked transfer encoding (or
       Content-Length), little-endian int16 by default, float32 with
       ``X-Audio-Format: f32``

Long audio rides the ``ChunkedTranscriber`` (fixed-size overlapped
chunks), ``/stream`` the ``StreamingTranscriber`` (the same stitched
frames, incremental, O(chunk) samples per stream). Concurrent requests
and streams share device batches through the ``MicroBatcher``
dispatcher; without it device work serializes behind a lock. Partials
decode greedily; the final text and ``/transcribe`` take the beam
search with ``--beam``/``--lm``, decoded on the request's thread
outside the device lock and the dispatcher. The native beam search
reads one loaded LM from several threads at once: it only reads it.
``--quantize int8`` serves int8 Dense weights (``ops/quant.py``);
``--exported`` serves a ``cli.export`` artifact instead of a checkpoint,
its chunk the smallest entry that covers ``--chunk_seconds``.

  python -m audio8_tpu_torch.cli.serve --checkpoint ctc.pt \\
      --dict_file dict.ltr.txt --beam 8 --lm lm.arpa --port 8000
  curl -s --data-binary @utt.wav localhost:8000/transcribe
  arecord -f S16_LE -r 16000 -t raw | curl -sN -T - \\
      -H 'Transfer-Encoding: chunked' localhost:8000/stream
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import threading
import time
from argparse import ArgumentParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        add_decoding_args, apply_preset,
                                        require_checkpoint)
from audio8_tpu_torch.cli.transcribe import (build_beam_decoder,
                                             check_timestamps, load_acoustic,
                                             load_exported_acoustic)
from audio8_tpu_torch.data.audio import SoundfileAudioReader
from audio8_tpu_torch.ops.align import timestamped_words
from audio8_tpu_torch.ops.metrics import postproc_bpe, postproc_letters
from audio8_tpu_torch.serve import (ChunkedTranscriber, MicroBatcher,
                                    StreamingTranscriber, decode_stitched)
from audio8_tpu_torch.utils import Offsets

logger = logging.getLogger("audio8_tpu_torch.serve")


class TranscribeService:
    """Request bytes -> text around one ``ChunkedTranscriber``.

    With a ``MicroBatcher`` the dispatcher thread serializes device work
    and concurrent requests share batches; without one, calls serialize
    through ``_lock``. The text decode (greedy or beam+LM) runs outside
    either."""

    def __init__(self, transcriber: ChunkedTranscriber, index2vocab: dict,
                 decoder=None, sample_rate: int = 16_000, info: dict = None,
                 timestamps: bool = False, postproc=None):
        self.transcriber = transcriber
        self.index2vocab = index2vocab
        self.decoder = decoder
        self.sample_rate = sample_rate
        self.info = dict(info or {})
        self.timestamps = timestamps
        self.postproc = postproc
        self._lock = threading.Lock()
        self._reader = SoundfileAudioReader()

    def decode_bytes(self, data: bytes, content_type: str = "") -> np.ndarray:
        """WAV or FLAC bytes -> float32 waveform."""
        if not data:
            raise ValueError("empty request body")
        is_flac = data[:4] == b"fLaC" or "flac" in content_type.lower()
        fd, path = tempfile.mkstemp(suffix=".flac" if is_flac else ".wav")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            return np.asarray(self._reader.read(path), np.float32)
        finally:
            os.unlink(path)

    def log_probs(self, wav: np.ndarray) -> np.ndarray:
        with self.stream_lock():
            return self.transcriber.log_probs(wav)

    def transcribe(self, data: bytes, content_type: str = "") -> dict:
        wav = self.decode_bytes(data, content_type)
        t0 = time.perf_counter()
        lp = self.log_probs(wav)
        text = decode_stitched(lp, self.index2vocab, self.decoder,
                               postproc=self.postproc)
        out = {"text": text,
               "audio_seconds": round(len(wav) / self.sample_rate, 3),
               "latency_ms": round((time.perf_counter() - t0) * 1e3, 1)}
        if self.timestamps:
            frame_sec = self.transcriber.stride / self.sample_rate
            out["words"] = timestamped_words(lp, self.index2vocab,
                                             Offsets.GO, frame_sec)
        return out

    def health(self) -> dict:
        out = {"ok": True, **self.info}
        b = self.transcriber.batcher
        if b is not None:
            out["batcher"] = {"dispatches": b.dispatches, "rows": b.rows}
        return out

    def new_stream(self) -> StreamingTranscriber:
        """A fresh per-request stream on the one-shot endpoint's device
        path and batcher."""
        t = self.transcriber
        return StreamingTranscriber(t.forward, t.conv_features,
                                    chunk_samples=t.chunk,
                                    context_samples=t.context,
                                    batcher=t.batcher, device=t.device)

    def final_text(self, st: StreamingTranscriber, lock=None) -> str:
        """Flush a finished stream to its final text (the beam decoder
        here; partials stay greedy). ``lock`` guards the device flush
        only."""
        with lock or contextlib.nullcontext():
            lp = st.finish()
        return decode_stitched(lp, self.index2vocab, self.decoder,
                               postproc=self.postproc)

    def stream_lock(self):
        """The device guard of a feed: a real lock only without a
        ``MicroBatcher``. With one, a feed holding a shared lock would
        keep other requests from filling its batch."""
        if self.transcriber.batcher is not None:
            return contextlib.nullcontext()
        return self._lock


def pcm_to_float(data: bytes, fmt: str) -> np.ndarray:
    """Raw little-endian PCM bytes -> float32 waveform in [-1, 1]."""
    if fmt == "f32":
        return np.frombuffer(data, "<f4").astype(np.float32)
    return np.frombuffer(data, "<i2").astype(np.float32) / 32768.0


class Metrics:
    """Thread-safe request counters in Prometheus text format at ``GET
    /metrics``, under the JAX package's names, so that one scrape config
    serves both packages. A request is counted before its response is
    written: a client holding a response sees it in the next scrape.
    ``a8t_request_seconds`` is service time (read, decode, transcribe);
    for ``/stream`` it covers the whole stream."""

    def __init__(self, batcher=None):
        self._lock = threading.Lock()
        self.batcher = batcher
        self.requests = {}   # (route, code) -> count
        self.seconds = {}    # route -> [sum, count]
        self.audio_seconds = 0.0

    def observe(self, route: str, code: int, elapsed: float,
                audio_seconds: float = 0.0) -> None:
        with self._lock:
            key = (route, code)
            self.requests[key] = self.requests.get(key, 0) + 1
            s = self.seconds.setdefault(route, [0.0, 0])
            s[0] += elapsed
            s[1] += 1
            self.audio_seconds += audio_seconds

    def render(self) -> str:
        with self._lock:
            lines = ["# TYPE a8t_requests_total counter"]
            for (route, code), n in sorted(self.requests.items()):
                lines.append(f'a8t_requests_total{{route="{route}",'
                             f'code="{code}"}} {n}')
            lines.append("# TYPE a8t_request_seconds summary")
            for route, (tot, cnt) in sorted(self.seconds.items()):
                lines.append(f'a8t_request_seconds_sum{{route="{route}"}} '
                             f"{tot:.6f}")
                lines.append(f'a8t_request_seconds_count{{route="{route}"}} '
                             f"{cnt}")
            lines.append("# TYPE a8t_audio_seconds_total counter")
            lines.append(f"a8t_audio_seconds_total {self.audio_seconds:.3f}")
        b = self.batcher
        if b is not None:
            lines += ["# TYPE a8t_batcher_dispatches_total counter",
                      f"a8t_batcher_dispatches_total {b.dispatches}",
                      "# TYPE a8t_batcher_rows_total counter",
                      f"a8t_batcher_rows_total {b.rows}"]
        return "\n".join(lines) + "\n"


def make_server(service: TranscribeService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer serving ``service`` (port 0 = ephemeral);
    its counters are the server's ``metrics``."""
    metrics = Metrics(service.transcriber.batcher)

    class Handler(BaseHTTPRequestHandler):
        # the chunked /stream response needs HTTP/1.1; _send always sets
        # Content-Length, so keep-alive stays correct
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, payload: dict):
            if code >= 400:
                # an error may leave request-body bytes unread
                self.close_connection = True
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/health"):
                self._send(200, service.health())
            elif self.path == "/metrics":
                body = metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            t0 = time.perf_counter()
            if self.path == "/stream":
                audio_sec, code = self._stream()
                metrics.observe("/stream", code, time.perf_counter() - t0,
                                audio_sec)
                return
            if self.path != "/transcribe":
                self._send(404, {"error": f"no route {self.path}"})
                return
            audio_sec = 0.0
            try:
                n = int(self.headers.get("Content-Length", 0))
                code, payload = 200, service.transcribe(
                    self.rfile.read(n), self.headers.get("Content-Type", ""))
                audio_sec = payload["audio_seconds"]
            except (ValueError, KeyError) as e:
                code, payload = 400, {"error": str(e)}
            except Exception as e:  # noqa: BLE001 - keep the server alive
                logger.exception("transcribe failed")
                code, payload = 500, {"error": f"{type(e).__name__}: {e}"}
            metrics.observe("/transcribe", code, time.perf_counter() - t0,
                            audio_sec)
            self._send(code, payload)

        def _body_blocks(self):
            """Request-body byte blocks, decoding chunked transfer
            encoding by hand (http.server does not)."""
            if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                while True:
                    size = int(self.rfile.readline().split(b";")[0], 16)
                    if size == 0:
                        while self.rfile.readline() not in (b"\r\n", b"\n",
                                                            b""):
                            pass  # trailers
                        return
                    yield self.rfile.read(size)
                    self.rfile.readline()  # the chunk's closing CRLF
            else:
                left = int(self.headers.get("Content-Length", 0))
                while left > 0:
                    block = self.rfile.read(min(left, 65536))
                    if not block:
                        return
                    left -= len(block)
                    yield block

        def _emit(self, payload: dict):
            line = (json.dumps(payload) + "\n").encode()
            self.wfile.write(b"%x\r\n" % len(line) + line + b"\r\n")
            self.wfile.flush()

        def _stream(self):
            """Serve one /stream request; returns (audio seconds, code)."""
            fmt = self.headers.get("X-Audio-Format", "s16").lower()
            if fmt not in ("s16", "f32"):
                self._send(400, {"error": f"unknown X-Audio-Format {fmt}"})
                return 0.0, 400
            width = 4 if fmt == "f32" else 2
            st = service.new_stream()
            lock = service.stream_lock()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                partial, leftover = "", b""
                for block in self._body_blocks():
                    data = leftover + block
                    usable = len(data) - len(data) % width
                    leftover = data[usable:]
                    with lock:
                        st.feed(pcm_to_float(data[:usable], fmt))
                    text = st.text_so_far(service.index2vocab,
                                          postproc=service.postproc)
                    if text != partial:
                        partial = text
                        self._emit({"partial": text})
                text = service.final_text(st, lock)
                self._emit({"text": text, "final": True,
                            "audio_seconds": round(
                                st.samples_fed / service.sample_rate, 3)})
                code = 200
            except Exception as e:  # noqa: BLE001 - keep the server alive
                logger.exception("stream failed")
                self._emit({"error": f"{type(e).__name__}: {e}",
                            "final": True})
                code = 500
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
            # a failed stream may leave body bytes unread
            self.close_connection = True
            return st.samples_fed / service.sample_rate, code

        def log_message(self, fmt, *a):  # route to logging, not stderr
            logger.info("%s %s", self.address_string(), fmt % a)

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.metrics = metrics
    return srv


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint",
                   help="fairseq fine-tuned wav2vec2 CTC .pt or HF dir")
    p.add_argument("--dict_file",
                   help="fairseq dict.ltr.txt or HF vocab.json")
    add_decoding_args(p, max_decode_len=8_000)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--target_type", choices=["ltr", "bpe"], default="ltr",
                   help="unit type the checkpoint was trained on")
    p.add_argument("--chunk_seconds", type=float, default=30.0)
    p.add_argument("--context_seconds", type=float, default=2.0)
    p.add_argument("--batch", type=int, default=4,
                   help="chunk batch per device dispatch")
    p.add_argument("--batch_wait_ms", type=float, default=2.0,
                   help="max wait for co-batching concurrent requests; "
                        "0 disables the cross-request MicroBatcher")
    add_common_model_args(p)
    args = apply_preset(p.parse_args(argv))
    require_checkpoint(args, "serve")
    return args


def build_service(args) -> TranscribeService:
    """Model, batcher, transcriber and decoder from the flags, warmed up
    with one second of silence."""
    check_timestamps(args)
    art = None
    if args.exported:
        cfg, forward, vocab_list, index2vocab, device, art = \
            load_exported_acoustic(args)
        sr = art.sample_rate
        # the artifact records the real sizes; the flags' defaults would
        # misreport them on /healthz
        dims = dict(d_model=art.meta.get("d_model"),
                    num_layers=art.meta.get("num_layers"))
    else:
        cfg, forward, vocab_list, index2vocab, device = load_acoustic(args)
        sr = args.target_sample_rate
        dims = dict(d_model=args.d_model, num_layers=args.num_layers)
    chunk = int(args.chunk_seconds * sr)
    if art is not None:
        chunk = art.entry_samples(chunk)  # the entry table is the menu
    batcher = None
    if args.batch_wait_ms > 0:
        batcher = MicroBatcher(forward, chunk, batch_size=args.batch,
                               max_wait_ms=args.batch_wait_ms, device=device)
    ct = ChunkedTranscriber(forward, cfg.conv_features, chunk_samples=chunk,
                            context_samples=int(args.context_seconds * sr),
                            batch_size=args.batch, batcher=batcher,
                            device=device)
    postproc = postproc_bpe if args.target_type == "bpe" else postproc_letters
    service = TranscribeService(
        ct, index2vocab, build_beam_decoder(args, vocab_list), sample_rate=sr,
        timestamps=args.timestamps, postproc=postproc,
        info={"model": "wav2vec2-ctc" + ("" if art is None
                                         else " (exported)"),
              "beam": args.beam, **dims, "device": str(device),
              "quantize": (args.quantize if art is None
                           else art.meta.get("quantize", "none")),
              "chunk_seconds": round(ct.chunk / sr, 3)})
    logger.info("warming up (%d-sample chunk forward on %s)", chunk, device)
    service.log_probs(np.zeros(sr, np.float32))
    return service


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    service = build_service(args)
    srv = make_server(service, args.host, args.port)
    logger.info("serving on %s:%d", *srv.server_address)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    finally:
        srv.server_close()
        if service.transcriber.batcher is not None:
            service.transcriber.batcher.close()
    return srv


if __name__ == "__main__":
    main()
