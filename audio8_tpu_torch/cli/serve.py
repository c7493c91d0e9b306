"""HTTP transcription endpoint of the port (``a8t-serve`` on PyTorch).

Counterpart of ``audio8_tpu/cli/serve.py``: one process loads the model
on ``--device`` (the CUDA card by default; ``--device cpu`` asks for the
CPU), then serves

  GET  /healthz            -> {"ok": true, model info, batcher stats}
  POST /transcribe         -> {"text", "audio_seconds", "latency_ms"}
       body: WAV bytes

Long audio rides the ``ChunkedTranscriber`` (fixed-size overlapped
chunks); concurrent requests share device batches through the
``MicroBatcher`` dispatcher, and without it device work serializes
behind a lock. ``/stream``, ``/metrics``, beam/LM decoding and timestamps
are not ported yet (ROADMAP.md).

  python -m audio8_tpu_torch.cli.serve --checkpoint ctc.pt \\
      --dict_file dict.ltr.txt --port 8000
  curl -s --data-binary @utt.wav localhost:8000/transcribe
"""
from __future__ import annotations

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
from audio8_tpu_torch.cli.transcribe import load_acoustic
from audio8_tpu_torch.data.audio import SoundfileAudioReader
from audio8_tpu_torch.ops.metrics import postproc_bpe, postproc_letters
from audio8_tpu_torch.serve import (ChunkedTranscriber, MicroBatcher,
                                    decode_stitched)

logger = logging.getLogger("audio8_tpu_torch.serve")


class TranscribeService:
    """Request bytes -> text around one ``ChunkedTranscriber``.

    With a ``MicroBatcher`` the dispatcher thread serializes device work
    and concurrent requests share batches; without one, calls serialize
    through ``_lock``. The greedy text decode runs outside either."""

    def __init__(self, transcriber: ChunkedTranscriber, index2vocab: dict,
                 sample_rate: int = 16_000, info: dict = None, postproc=None):
        self.transcriber = transcriber
        self.index2vocab = index2vocab
        self.sample_rate = sample_rate
        self.info = dict(info or {})
        self.postproc = postproc
        self._lock = threading.Lock()
        self._reader = SoundfileAudioReader()

    def decode_bytes(self, data: bytes) -> np.ndarray:
        """WAV bytes -> float32 waveform."""
        if not data:
            raise ValueError("empty request body")
        fd, path = tempfile.mkstemp(suffix=".wav")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            return np.asarray(self._reader.read(path), np.float32)
        finally:
            os.unlink(path)

    def log_probs(self, wav: np.ndarray) -> np.ndarray:
        if self.transcriber.batcher is not None:
            return self.transcriber.log_probs(wav)
        with self._lock:
            return self.transcriber.log_probs(wav)

    def transcribe(self, data: bytes) -> dict:
        wav = self.decode_bytes(data)
        t0 = time.perf_counter()
        lp = self.log_probs(wav)
        text = decode_stitched(lp, self.index2vocab, postproc=self.postproc)
        return {"text": text,
                "audio_seconds": round(len(wav) / self.sample_rate, 3),
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 1)}

    def health(self) -> dict:
        out = {"ok": True, **self.info}
        b = self.transcriber.batcher
        if b is not None:
            out["batcher"] = {"dispatches": b.dispatches, "rows": b.rows}
        return out


def make_server(service: TranscribeService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer serving ``service`` (port 0 = ephemeral)."""

    class Handler(BaseHTTPRequestHandler):
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
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/transcribe":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                code, payload = 200, service.transcribe(self.rfile.read(n))
            except (ValueError, KeyError) as e:
                code, payload = 400, {"error": str(e)}
            except Exception as e:  # noqa: BLE001 - keep the server alive
                logger.exception("transcribe failed")
                code, payload = 500, {"error": f"{type(e).__name__}: {e}"}
            self._send(code, payload)

        def log_message(self, fmt, *a):  # route to logging, not stderr
            logger.info("%s %s", self.address_string(), fmt % a)

    return ThreadingHTTPServer((host, port), Handler)


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint",
                   help="fairseq fine-tuned wav2vec2 CTC .pt")
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
    """Model, batcher and transcriber from the flags, warmed up with one
    second of silence."""
    cfg, forward, _, index2vocab, device = load_acoustic(args)
    sr = args.target_sample_rate
    chunk = int(args.chunk_seconds * sr)
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
        ct, index2vocab, sample_rate=sr, postproc=postproc,
        info={"model": "wav2vec2-ctc", "d_model": args.d_model,
              "num_layers": args.num_layers, "device": str(device),
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
