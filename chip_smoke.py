#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``audio8_tpu_torch``) on one CUDA card.

Drives the port's serving path at full wav2vec2-base width with seeded
random weights and holds every hand-written kernel on it against its plain
PyTorch version. Phases, each printing one JSON line:

1. build   - compile the CUDA kernels from ``audio8_tpu_torch/csrc``;
2. kernel  - each kernel vs its plain version at the serving path's shapes
             (30 s chunks, batch 4), float32 and bfloat16; then small
             ragged shapes and misaligned pointers, which reach every
             variant of each kernel;
3. model   - the full-width model's forward on the card (through the
             kernels) vs the same weights on the CPU (plain versions);
4. serve   - the ``a8t-serve`` path (parse_args -> load_acoustic ->
             make_server) on 127.0.0.1 answers concurrent requests of about
             3, 12, 31 and 65 s; the kernels' launch counts over that run;
5. timing  - each kernel vs its plain version (CUDA events, median);

then a ``kernels`` line, the card's name and power limit from nvidia-smi,
and, last, ``{"ok": true, "device": {...}}``. Any failed check raises, so
the exit code is non-zero and the last line is not printed. Without a CUDA
card it exits with code 2 and prints no result.

    python3 chip_smoke.py
"""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0  # weights, inputs and audio are all drawn from it
SR = 16_000
CHUNK_BATCH = 4
# (T_in, C_in, C_out) of the four k3s2 extractor layers on a 30 s chunk
CONV_SHAPES = [(95_999, 512, 512), (47_999, 512, 512), (23_999, 512, 512),
               (11_999, 512, 512)]
ATTN_SHAPE = (CHUNK_BATCH, 12, 1499, 64)
ATTN_LENGTHS = [1499, 1003, 0, 377]  # ragged, with a zero-length filler row
# max_abs_err <= TOL[dtype] * max(1, max|plain|). float32: only the order
# of the f32 sums differs. bfloat16: outputs are rounded to bf16 (2^-8
# relative) and the attention kernel rounds exp(s - m) to bf16 where the
# TPU kernel and the plain version round the normalised probabilities.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -5}
MODEL_TOL = 1e-3  # float32 log-probs, 12 layers, card vs CPU sum orders
LETTERS = "| E T A O N I H S R D L U M W C F G Y P B V K ' X J Q Z".split()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    return ((a.float() - b.float()).abs().max().item(),
            b.float().abs().max().item())


def phase_build() -> None:
    from audio8_tpu_torch.ops import _ext

    t0 = time.perf_counter()
    libs = _ext.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(os.path.relpath(p, HERE) for p in libs.values())})


def conv_inputs(shape, dtype, gen):
    t_in, c_in, c_out = shape
    x = torch.randn(CHUNK_BATCH, t_in, c_in, device="cuda", generator=gen)
    w = torch.randn(3, c_in, c_out, device="cuda", generator=gen)
    return x.to(dtype), (w / np.sqrt(3 * c_in)).to(dtype)


def attn_inputs(dtype, gen):
    q, k, v = (torch.randn(ATTN_SHAPE, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    t = ATTN_SHAPE[2]
    kv = (torch.arange(t, device="cuda")[None, :]
          < torch.tensor(ATTN_LENGTHS, device="cuda")[:, None])
    return q, k, v, kv


def misaligned(a: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``a`` whose data pointer is 2 bytes off a
    16-byte boundary: the kernels' generic (non-vector) variants."""
    buf = torch.empty(a.numel() + 8, dtype=a.dtype, device=a.device)
    out = buf[1:1 + a.numel()].view(a.shape)
    out.copy_(a)
    return out


def phase_variants(gen) -> None:
    """Small ragged shapes and misaligned pointers reach every variant of
    each kernel (tensor-core, vectorised SIMT and generic SIMT)."""
    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_plain)
    from audio8_tpu_torch.ops.conv import conv1d_k3s2, conv1d_k3s2_plain

    for dtype in (torch.float32, torch.bfloat16):
        for shape, skew in (((2, 101, 40, 72), False), ((2, 37, 6, 10), False),
                            ((2, 101, 40, 72), True)):
            b, t, c_in, c_out = shape
            x = torch.randn(b, t, c_in, device="cuda", generator=gen)
            w = torch.randn(3, c_in, c_out, device="cuda", generator=gen)
            x, w = x.to(dtype), (w / np.sqrt(3 * c_in)).to(dtype)
            if skew:
                x, w = misaligned(x), misaligned(w)
            err, scale = max_err(conv1d_k3s2(x, w), conv1d_k3s2_plain(x, w))
            tol = TOL[dtype] * max(1.0, scale)
            emit({"phase": "variant", "kernel": "conv_k3s2_fwd",
                  "dtype": str(dtype), "shape": list(shape),
                  "misaligned": skew, "max_abs_err": err, "tol": tol})
            check(err <= tol, f"conv_k3s2_fwd variant {shape} {dtype}: {err}")
        for shape, skew in (((3, 2, 130, 16), False), ((2, 2, 200, 128), False),
                            ((3, 2, 130, 32), True)):
            b, h, t, dh = shape
            q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            if skew:
                q, k, v = misaligned(q), misaligned(k), misaligned(v)
            kv = (torch.arange(t, device="cuda")[None, :]
                  < torch.tensor([t, t // 3, 0][:b], device="cuda")[:, None])
            for rate in (0.0, 0.1):
                err, scale = max_err(
                    attention_core(q, k, v, kv, dh ** -0.5, rate, 7),
                    attention_core_plain(q, k, v, kv, dh ** -0.5, rate, 7))
                tol = TOL[dtype] * max(1.0, scale)
                emit({"phase": "variant", "kernel": "attention_fwd",
                      "dtype": str(dtype), "shape": list(shape), "rate": rate,
                      "misaligned": skew, "max_abs_err": err, "tol": tol})
                check(err <= tol,
                      f"attention_fwd variant {shape} {dtype}: {err}")


def phase_kernels(gen) -> dict:
    """Each kernel vs its plain version; returns the float32 max errors."""
    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_plain)
    from audio8_tpu_torch.ops.conv import conv1d_k3s2, conv1d_k3s2_plain

    worst = {"conv_k3s2_fwd": 0.0, "attention_fwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in CONV_SHAPES:
            x, w = conv_inputs(shape, dtype, gen)
            y = conv1d_k3s2(x, w)
            torch.cuda.synchronize()
            err, scale = max_err(y, conv1d_k3s2_plain(x, w))
            tol = TOL[dtype] * max(1.0, scale)
            emit({"phase": "kernel", "kernel": "conv_k3s2_fwd",
                  "dtype": str(dtype), "shape": [CHUNK_BATCH, *shape],
                  "max_abs_err": err, "tol": tol})
            check(bool(torch.isfinite(y).all()) and err <= tol,
                  f"conv_k3s2_fwd {dtype} {shape}: {err} > {tol}")
            if dtype == torch.float32:
                worst["conv_k3s2_fwd"] = max(worst["conv_k3s2_fwd"], err)
        q, k, v, kv = attn_inputs(dtype, gen)
        for rate, seed in ((0.0, 0), (0.1, 1234)):
            o = attention_core(q, k, v, kv, 0.125, rate, seed)
            torch.cuda.synchronize()
            err, scale = max_err(o, attention_core_plain(q, k, v, kv, 0.125,
                                                         rate, seed))
            tol = TOL[dtype] * max(1.0, scale)
            emit({"phase": "kernel", "kernel": "attention_fwd",
                  "dtype": str(dtype), "shape": list(ATTN_SHAPE),
                  "key_lengths": ATTN_LENGTHS, "rate": rate, "seed": seed,
                  "max_abs_err": err, "tol": tol})
            check(bool(torch.isfinite(o).all()) and err <= tol,
                  f"attention_fwd {dtype} rate {rate}: {err} > {tol}")
            if dtype == torch.float32:
                worst["attention_fwd"] = max(worst["attention_fwd"], err)
    return worst


def base_config(num_labels: int):
    from audio8_tpu.config import AcousticConfig

    return AcousticConfig(num_labels=num_labels, timestep_masking=0.0,
                          channel_masking=0.0)


def phase_model(seed: int):
    """Full-width model: card (kernels) vs CPU (plain versions), f32."""
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    cfg = base_config(4 + len(LETTERS))
    cpu = Wav2Vec2AcousticModel(cfg, generator=torch.Generator().manual_seed(seed))
    gpu = Wav2Vec2AcousticModel(cfg).cuda()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(2, 4 * SR)) * 0.1).astype(np.float32))
    lens = torch.tensor([4 * SR, 41_000])
    with torch.inference_mode():
        lp_gpu, mask_gpu = gpu(x.cuda(), lens.cuda())
        torch.cuda.synchronize()
        lp_cpu, mask_cpu = cpu(x, lens)
    check(torch.equal(mask_gpu.cpu(), mask_cpu), "pad masks differ")
    valid = mask_cpu
    err = (lp_gpu.cpu() - lp_cpu).abs()[valid].max().item()
    agree = (lp_gpu.cpu().argmax(-1) == lp_cpu.argmax(-1))[valid].float().mean().item()
    emit({"phase": "model", "config": "wav2vec2-base d768 h12 L12 ff3072",
          "params": sum(p.numel() for p in cpu.parameters()),
          "input": [2, 4 * SR], "lengths": lens.tolist(),
          "log_probs_shape": list(lp_gpu.shape), "max_abs_err": err,
          "tol": MODEL_TOL, "argmax_agreement": agree})
    check(bool(torch.isfinite(lp_gpu).all()), "non-finite GPU log-probs")
    check(err <= MODEL_TOL, f"model GPU vs CPU {err} > {MODEL_TOL}")
    return cpu


def wav_bytes(wav: np.ndarray) -> bytes:
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, SR, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


def synthetic_speechlike(seconds: float, rng) -> np.ndarray:
    """Noise bursts under a few drifting tones: audio of a plausible
    level and spectrum, made from the seed."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    sig = sum(0.05 * np.sin(2 * np.pi * (f + 20 * np.sin(t)) * t)
              for f in rng.uniform(120, 900, size=4))
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2
    return (sig * envelope + 0.02 * rng.normal(size=n)).astype(np.float32)


def post(port: int, path: str, data: bytes | None = None):
    # no proxy: the server is on this machine's loopback
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    with opener.open(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def phase_serve(cpu_model, seed: int, tmp: str) -> dict:
    """The serving entry point end to end; returns the launch counts of
    the requests' run."""
    from audio8_tpu_torch.cli.serve import build_service, make_server, parse_args
    from audio8_tpu_torch.models.convert import save_fairseq_ctc
    from audio8_tpu_torch.ops.attention import attention_core
    from audio8_tpu_torch.ops.conv import conv1d_k3s2

    ckpt = os.path.join(tmp, "ctc.pt")
    save_fairseq_ctc(cpu_model, ckpt)
    dict_file = os.path.join(tmp, "dict.ltr.txt")
    with open(dict_file, "w") as fh:
        fh.writelines(f"{c} {1000 - i}\n" for i, c in enumerate(LETTERS))
    args = parse_args(["--checkpoint", ckpt, "--dict_file", dict_file,
                       "--host", "127.0.0.1", "--port", "0",
                       "--batch", str(CHUNK_BATCH)])
    service = build_service(args)
    srv = make_server(service, args.host, args.port)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    port = srv.server_address[1]
    rng = np.random.default_rng(seed + 1)
    seconds = [3.1, 12.4, 31.0, 65.3]
    bodies = [wav_bytes(synthetic_speechlike(s, rng)) for s in seconds]
    results = [None] * len(bodies)

    def send(i):
        t0 = time.perf_counter()
        results[i] = post(port, "/transcribe", bodies[i]) + (
            time.perf_counter() - t0,)

    try:
        batcher = service.transcriber.batcher
        dispatches0 = batcher.dispatches
        conv1d_k3s2.launches = 0
        attention_core.launches = 0
        t0 = time.perf_counter()
        clients = [threading.Thread(target=send, args=(i,))
                   for i in range(len(bodies))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {"conv_k3s2_fwd": conv1d_k3s2.launches,
                    "attention_fwd": attention_core.launches}
        status, health = post(port, "/healthz")
        check(status == 200 and health["ok"], "healthz")
        for s, res in zip(seconds, results):
            check(res is not None and res[0] == 200
                  and isinstance(res[1].get("text"), str),
                  f"request of {s} s: {res}")
        dispatches = batcher.dispatches - dispatches0
        check(dispatches > 0, "the micro-batcher never dispatched")
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched by the served requests")
        emit({"phase": "serve", "requests_s": seconds,
              "latency_ms": [round(r[2] * 1e3, 1) for r in results],
              "server_latency_ms": [r[1]["latency_ms"] for r in results],
              "wall_s": wall, "audio_s_per_s": sum(seconds) / wall,
              "dispatches": dispatches, "batch": CHUNK_BATCH,
              "chunk_s": health["chunk_seconds"], "launches": launches,
              "texts_len": [len(r[1]["text"]) for r in results]})

        # the served path vs the CPU model on the first request's audio
        from audio8_tpu.data.audio import read_wav
        path = os.path.join(tmp, "req0.wav")
        with open(path, "wb") as f:
            f.write(bodies[0])
        wav, _ = read_wav(path)
        lp_served = service.log_probs(wav)
        chunk = service.transcriber.chunk
        sig = torch.zeros(1, chunk)
        sig[0, :len(wav)] = torch.from_numpy(wav)
        with torch.inference_mode():
            lp_cpu, _ = cpu_model(sig, torch.tensor([len(wav)]))
        lp_cpu = lp_cpu[0, :len(lp_served)].numpy()
        err = float(np.abs(lp_served - lp_cpu).max())
        agree = float((lp_served.argmax(-1) == lp_cpu.argmax(-1)).mean())
        emit({"phase": "serve_vs_cpu", "audio_s": seconds[0],
              "frames": len(lp_served), "max_abs_err": err, "tol": MODEL_TOL,
              "argmax_agreement": agree})
        check(err <= MODEL_TOL, f"served log-probs vs CPU {err}")
    finally:
        srv.shutdown()
        srv.server_close()
        service.transcriber.batcher.close()
        server.join(timeout=10)
    return launches


def median_ms(fn, reps: int = 5, inner: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def phase_timing(gen) -> dict:
    """Kernel vs plain, in turns (plain, kernel, kernel, plain)."""
    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_plain)
    from audio8_tpu_torch.ops.conv import conv1d_k3s2, conv1d_k3s2_plain

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        convs = [conv_inputs(s, dtype, gen) for s in CONV_SHAPES]
        q, k, v, kv = attn_inputs(dtype, gen)
        cases = {
            "conv_k3s2_fwd": (lambda: [conv1d_k3s2(x, w) for x, w in convs],
                              lambda: [conv1d_k3s2_plain(x, w)
                                       for x, w in convs]),
            "attention_fwd": (lambda: attention_core(q, k, v, kv, 0.125),
                              lambda: attention_core_plain(q, k, v, kv,
                                                           0.125)),
        }
        for name, (kern, plain) in cases.items():
            p1 = median_ms(plain)
            k1 = median_ms(kern)
            k2 = median_ms(kern)
            p2 = median_ms(plain)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            emit({"phase": "timing", "kernel": name, "dtype": str(dtype),
                  "what": ("the four k3s2 layers of one batch of 30 s chunks"
                           if name == "conv_k3s2_fwd" else
                           "one layer's attention core"),
                  "ms": ms, "plain_ms": plain_ms, "ms_runs": [k1, k2],
                  "plain_ms_runs": [p1, p2]})
            out[(name, dtype)] = (ms, plain_ms)
        del convs, q, k, v, kv
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import audio8_tpu_torch  # noqa: F401 - fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    phase_build()
    worst = phase_kernels(gen)
    phase_variants(gen)
    cpu_model = phase_model(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_serve(cpu_model, SEED, tmp)
    times = phase_timing(gen)
    check("jax" not in sys.modules, "jax was imported")

    replaces = {
        "conv_k3s2_fwd": "audio8_tpu/ops/pallas/conv_kernel.py:107",
        "attention_fwd": "audio8_tpu/ops/pallas/attention_kernel.py:96",
    }
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"audio8_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": worst[name],
         "ms": times[(name, torch.float32)][0],
         "plain_ms": times[(name, torch.float32)][1]}
        for name in ("conv_k3s2_fwd", "attention_fwd")]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
