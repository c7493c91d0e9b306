"""Where the time of one serving dispatch goes on the card.

Runs the port's ``Wav2Vec2AcousticModel`` forward on one ``(batch, chunk)``
block as the ``MicroBatcher`` dispatches it (seeded random weights, ragged
lengths with one zero-length filler row) and prints one JSON line:

* ``forward_ms``: the whole forward (CUDA events, median of 5);
* ``stage_ms``: each stage of the forward run alone on its real input,
  in the forward's order (CUDA events, median of 5), and their sum;
* ``device_idle_share``: the share of one traced forward's window in
  which no kernel ran (``torch.profiler``, union of kernel intervals).

    python -m audio8_tpu_torch.profile [--bf16]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from audio8_tpu.config import AcousticConfig
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.nn.transformer import ffn
from audio8_tpu_torch.ops.attention import attention_core

# the a8t-serve defaults: 30 s chunks, batch 4
BATCH, CHUNK, SEED = 4, 480_000, 0


def median_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def busy_union(intervals) -> float:
    """Total length covered by (start, end) intervals, in their unit."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def stage_times(model, sig, lengths) -> dict:
    """Each stage of ``model``'s forward timed alone on its real input."""
    enc = model.encoder
    fx = enc.feature_extractor
    out = {}
    x = sig[..., None].to(fx.compute_dtype)
    for i, ((_, k, stride), block) in enumerate(
            zip(fx.conv_features, fx.conv_layers)):
        conv = getattr(block, "0")
        kind = "conv_k3s2_fwd" if (k, stride) == (3, 2) else "conv_cudnn"
        out[f"fx{i}.{kind}"] = median_ms(lambda: conv(x))
        x = conv(x)
        if i == 0:
            valid = ((lengths - k) // stride + 1).clamp_min(0)
            mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                    < valid[:, None])
            norm = getattr(block, "2")
            out["fx0.group_norm_masked"] = median_ms(lambda: norm(x, mask))
            x = norm(x, mask)
        out[f"fx{i}.gelu"] = median_ms(lambda: F.gelu(x))
        x = F.gelu(x)
    proj = lambda: enc.post_extract_proj(enc.layer_norm(x))
    out["layer_norm+post_extract_proj"] = median_ms(proj)
    h = proj()
    frames = torch.clamp(lengths // (sig.shape[1] // h.shape[1]),
                         max=h.shape[1])
    kv = torch.arange(h.shape[1], device=h.device)[None, :] < frames[:, None]
    tenc = enc.encoder
    out["pos_conv"] = median_ms(lambda: tenc.pos_conv(h))
    h = tenc.layer_norm(h + tenc.pos_conv(h))
    layer = tenc.layers[0]
    attn = layer.self_attn
    n = len(tenc.layers)
    q, k_, v = (attn._split(p(h)) for p in (attn.q_proj, attn.k_proj,
                                            attn.v_proj))
    core_ms = median_ms(lambda: attention_core(q, k_, v, kv,
                                               attn.d_head ** -0.5))
    attn_ms = median_ms(lambda: attn(h, kv))
    ffn_ms = median_ms(lambda: ffn(h, layer.fc1, layer.fc2))
    layer_ms = median_ms(lambda: layer(h, kv))
    out[f"layers.attention_fwd x{n}"] = n * core_ms
    out[f"layers.qkvo_proj+head_split x{n}"] = n * (attn_ms - core_ms)
    out[f"layers.ffn x{n}"] = n * ffn_ms
    out[f"layers.residual+layer_norms x{n}"] = n * (layer_ms - attn_ms
                                                    - ffn_ms)
    out["head+log_softmax"] = median_ms(
        lambda: torch.log_softmax(model.proj(h).float(), dim=-1))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cfg = AcousticConfig(num_labels=32, timestep_masking=0.0,
                         channel_masking=0.0)
    model = Wav2Vec2AcousticModel(
        cfg, dtype, generator=torch.Generator().manual_seed(SEED))
    model = model.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sig = torch.randn(BATCH, CHUNK, device="cuda", generator=gen) * 0.1
    lengths = torch.tensor([CHUNK - 16_000 * i for i in range(BATCH)],
                           device="cuda").clamp_min(0)
    lengths[-1] = 0

    with torch.inference_mode():
        forward_ms = median_ms(lambda: model(sig, lengths))
        stages = stage_times(model, sig, lengths)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            model(sig, lengths)
            torch.cuda.synchronize()
    intervals = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    out = {
        "profile": "wav2vec2-base forward, one serving dispatch",
        "dtype": str(dtype), "batch": BATCH, "chunk_samples": CHUNK,
        "lengths": lengths.tolist(), "forward_ms": forward_ms,
        "stage_ms": stages, "stage_sum_ms": sum(stages.values()),
        "device_idle_share": 1.0 - busy_union(intervals) / window,
        "kernel_launches": len(intervals),
        "forward_audio_s_per_s": float(lengths.sum()) / 16_000
        / (forward_ms / 1e3),
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
