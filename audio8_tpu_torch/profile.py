"""Where the time of one serving dispatch, or of one training or
pretraining step, goes on the card.

Default: the port's ``Wav2Vec2AcousticModel`` forward on one ``(batch,
chunk)`` block as the ``MicroBatcher`` dispatches it (seeded random
weights, ragged lengths with one zero-length filler row). One JSON line:

* ``forward_ms``: the whole forward (CUDA events, median of 5);
* ``stage_ms``: each stage of the forward run alone on its real input,
  in the forward's order (CUDA events, median of 5), and their sum;
* ``device_idle_share``: the share of one traced forward's window in
  which no kernel ran (``torch.profiler``, union of kernel intervals).

``--train``: one unfrozen CTC fine-tuning micro-step of the same model
with dropout and masking on, on a batch of 15, 12.5, 10 s rows and a
padding row (the ``cli.train`` defaults), through ``make_ctc_steps``:
``step_ms`` (grad + update), ``stage_ms`` (forward, CTC, backward, the
12 attention backwards alone, AdamW), the kernel time by group and the
device idle share of one traced step.

``--pretrain``: one contrastive pretraining step (``make_pretrain_steps``,
dropout and masking on) of the full-width ``Wav2Vec2Model`` on the batch
``cli.pretrain`` forms at its defaults from 4-15 s audio: 20 rows of
71 428 samples. ``step_ms``, ``stage_ms`` (forward, loss, backward, the
extractor's four k3s2 backwards alone, AdamW), kernel time by group and
the device idle share of one traced step.

``--fused_attention block`` (with ``--train`` or ``--pretrain``): the
same step with the model's ``fused_attention="block"``: the attention
block kernels run each layer (the rows are at most 1024 frames), and the
stage timed alone is the 12 layers' block backward instead of the core's.
The counterpart of the JAX package's ``tools/exp_attn_block.py``.

    python -m audio8_tpu_torch.profile [--bf16] [--train | --pretrain]
        [--fused_attention {core,block}] [--reps N]
"""
from __future__ import annotations

import argparse
import json
import re

import numpy as np
import torch
import torch.nn.functional as F

from audio8_tpu_torch.config import AcousticConfig
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


# The callers of the TMA-fed GEMM (csrc/tma_gemm.cuh), by the recipe of
# its A operand, which names the kernel's first operand type: each recipe
# has one caller
GEMM_CALLERS = {"TmaPaddedRows": "attention_block_gemm",
                "TmaHeadCols": "attention_block_gemm",
                "TmaRowCols": "attention_block_gemm",
                "TmaHeadRows": "attention_block_gemm",
                "TmaTapCols": "conv_k3s2_fwd",
                "TmaShiftRows": "conv_k3s2_dgrad",
                "TmaTapRows": "conv_k3s2_wgrad"}
_GEMM_A = re.compile(r"wgmma_gemm_kernel<\d+,\s*(?:\w+::)*(\w+)")


def gemm_caller(name: str):
    """The kernel whose product a traced kernel of the TMA-fed GEMM ran
    (``GEMM_CALLERS``, by the A recipe in its name), or None for any other
    kernel."""
    m = _GEMM_A.search(name)
    return GEMM_CALLERS.get(m.group(1)) if m else None


def kernel_groups(prof) -> dict:
    """Device ms by kernel family, from profiler events, and the five
    largest kernels of the rest by name. The TMA-fed GEMM's launches go to
    their caller's group (:func:`gemm_caller`); the attention block's
    group also holds its GEMMs on the other routes (``blockgemm::``:
    mma.sync, SIMT) and its bias partials, the conv's groups their own
    kernels; ``ctc`` holds the CTC sweep and gradient launches
    (``ctc_...``); ``matmul`` holds cuBLAS's kernels, whose Hopper bf16
    GEMMs are named ``nvjet_...``."""
    groups = {"conv_k3s2_wgrad": ("wgrad_f32_kernel", "wgrad_bf16_mma_kernel",
                                  "Wgrad<", "sum_splits_kernel"),
              "conv_k3s2_fwd": "conv_k3s2",
              "attention_block_gemm": ("blockgemm", "bias_partials_kernel"),
              "attention_fwd": "attention_fwd",
              "attention_bwd": ("attention_bwd", "rowdot_kernel",
                                "dq_reduce_kernel"),
              "ctc": "ctc_", "adamw": "adamw_kernel",
              "conv_k3s2_dgrad": ("dgrad_f32_kernel", "dgrad_bf16_mma_kernel",
                                  "Dgrad<"),
              "dropout": ("dropout_kernel", "dropout_vec_kernel"),
              "library_conv": ("dgrad", "wgrad", "fprop", "conv"),
              "matmul": ("gemm", "cutlass", "sm90_", "ampere", "nvjet")}
    out = {k: 0.0 for k in groups}
    out["other"] = 0.0
    other = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        caller = gemm_caller(e.name)
        if caller is not None:
            out[caller] += ms
            continue
        for name, keys in groups.items():
            if any(k in e.name for k in ((keys,) if isinstance(keys, str)
                                         else keys)):
                out[name] += ms
                break
        else:
            out["other"] += ms
            other[e.name] = other.get(e.name, 0.0) + ms
    out["other_top5"] = {k[:90]: v for k, v in sorted(
        other.items(), key=lambda kv: -kv[1])[:5]}
    # the attention backward's three launches: D, the fused pass, dq
    out["attention_bwd_parts"] = {
        part: sum((e.time_range.end - e.time_range.start) / 1e3
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and key in e.name)
        for part, key in (("rowdot", "rowdot_kernel"),
                          ("fused_pass", "attention_bwd_"),
                          ("dq_reduce", "dq_reduce_kernel"))}
    return out


def idle_share(prof) -> float:
    intervals = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    return 1.0 - busy_union(intervals) / window


def block_bwd_alone(x, attn, key_valid, rate: float):
    """A callable that runs one layer's attention-block backward kernel
    on ``x`` (the forward kernel's residuals made once)."""
    from audio8_tpu_torch.ops.attention_block import (_forward_kernel,
                                                      attention_block_bwd)

    weights = [t.to(x.dtype) for m in (attn.q_proj, attn.k_proj, attn.v_proj,
                                       attn.out_proj)
               for t in (m.weight.detach(), m.bias.detach())]
    scale = attn.d_head ** -0.5
    _, residuals = _forward_kernel(x, weights, key_valid, attn.num_heads,
                                   scale, rate, 7, True)
    dy = torch.randn_like(x)
    return lambda: attention_block_bwd(x, weights, residuals, attn.num_heads,
                                       scale, rate, 7, dy)


def train_profile(dtype, fused=None, reps: int = 5) -> dict:
    """One unfrozen micro-step: stages alone, then one traced step."""
    from audio8_tpu_torch.ops.attention import attention_core_bwd
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_ctc_steps
    from audio8_tpu_torch.utils import Offsets

    Offsets.remap_fairseq_ctc()
    model = Wav2Vec2AcousticModel(
        AcousticConfig(num_labels=32, fused_attention=fused), dtype,
        generator=torch.Generator().manual_seed(SEED)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = 240_000
    lengths = torch.tensor([n, 200_000, 160_000, 0], device="cuda")
    sig = torch.randn(4, n, device="cuda", generator=gen) * 0.1
    sig = sig * (torch.arange(n, device="cuda")[None] < lengths[:, None])
    tl = torch.tensor([210, 175, 140, 0], device="cuda")
    tok = torch.randint(4, 32, (4, 256), device="cuda", generator=gen)
    tok[torch.arange(256, device="cuda")[None] >= tl[:, None]] = Offsets.PAD
    batch = {"signal": sig, "signal_lengths": lengths, "token_ids": tok,
             "token_lengths": tl}
    state = TrainState(model, create_optimizer(create_lrs(1e-4, 100)))
    grad_fn, update_fn, _ = make_ctc_steps(model)
    seeds = torch.Generator().manual_seed(SEED)

    def step():
        _, grads, bsz, _ = grad_fn(batch, seeds, freeze=False)
        update_fn(state, grads, bsz)

    def forward():
        return model(sig, lengths, generator=seeds, freeze=False)

    from audio8_tpu_torch.ops.ctc import ctc_loss

    lp, mask = forward()
    frames = mask.sum(-1)
    loss = ctc_loss(lp, frames, tok, tl, blank=Offsets.GO)
    _, grads, bsz, _ = grad_fn(batch, seeds, freeze=False)
    # one layer's attention backward at this batch's shape, alone
    attn = model.encoder.encoder.layers[0].self_attn
    t = lp.shape[1]
    q, k, v, do = (torch.randn(4, 12, t, 64, device="cuda", generator=gen)
                   .to(dtype) for _ in range(4))
    kv = torch.arange(t, device="cuda")[None] < frames[:, None]
    from audio8_tpu_torch.ops.attention import _forward_kernel

    # the default path's semantics ("xla": fused_attention=None)
    _, stats, o32 = _forward_kernel(q, k, v, kv, attn.d_head ** -0.5, 0.1, 7,
                                    with_stats=True, xla=True,
                                    bf16_softmax=True)
    if fused == "block":
        attn_name = "attention_block_bwd x12 (alone)"
        attn_bwd = block_bwd_alone(
            torch.randn(4, t, 768, device="cuda", generator=gen).to(dtype),
            attn, kv, 0.1)
    else:
        attn_name = "attention_bwd x12 (alone)"

        def attn_bwd():
            attention_core_bwd(q, k, v, o32, stats, kv, attn.d_head ** -0.5,
                               0.1, 7, do, xla=True, bf16_softmax=True)
    fwd_ms = median_ms(forward)
    stages = {
        "forward (autograd graph)": fwd_ms,
        "ctc_loss fwd": median_ms(lambda: ctc_loss(
            lp.detach(), frames, tok, tl, blank=Offsets.GO)),
        "backward (fwd+bwd minus fwd)": median_ms(
            lambda: forward()[0].sum().backward()) - fwd_ms,
        attn_name: 12 * median_ms(attn_bwd),
        "adamw (apply_gradients)": median_ms(
            lambda: state.apply_gradients(grads, 1.0, 25.0)),
    }
    for prm in model.parameters():
        prm.grad = None
    step_ms = median_ms(step, reps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    audio_s = float(lengths.sum()) / 16_000
    return {"profile": "wav2vec2-base CTC fine-tuning, one unfrozen "
            "micro-step (grad + update)", "dtype": str(dtype),
            "fused_attention": fused,
            "lengths": lengths.tolist(), "frames": t, "step_ms": step_ms,
            "stage_ms": stages, "kernel_ms_by_group": kernel_groups(prof),
            "device_idle_share": idle_share(prof),
            "train_audio_s_per_s": audio_s / (step_ms / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": float(loss.detach()),
            "device": torch.cuda.get_device_name(0)}


def pretrain_profile(dtype, fused=None, reps: int = 5) -> dict:
    """One pretraining step: stages alone, then one traced step."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import (PretrainSeeds,
                                                  Wav2Vec2Model,
                                                  wav2vec2_pretrain_loss)
    from audio8_tpu_torch.ops.conv import (conv1d_k3s2_dgrad,
                                           conv1d_k3s2_wgrad)
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    cfg = PretrainConfig(fused_attention=fused)
    model = Wav2Vec2Model(cfg, dtype,
                          generator=torch.Generator().manual_seed(SEED)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, n = 20, 71_428
    sig = torch.randn(rows, n, device="cuda", generator=gen) * 0.1
    state = TrainState(model, create_optimizer(create_lrs(2e-4, 100),
                                               weight_decay=0.01))
    train_step, _ = make_pretrain_steps(model)
    seeds = torch.Generator().manual_seed(SEED)
    fixed = PretrainSeeds.draw(seeds)
    n_vars = cfg.num_vq_vars * cfg.num_vq_groups

    def step():
        train_step(state, sig, PretrainSeeds.draw(seeds), seeds)

    def forward():
        return model(sig, fixed, generator=seeds)

    def loss_of(out):
        return wav2vec2_pretrain_loss(*out, fixed.negatives, n_vars)[0]

    out = forward()
    loss = loss_of(out)
    # the extractor's four k3s2 layers' backward at this batch, alone
    convs, t = [], n
    for (c_out, k, stride), block in zip(cfg.conv_features,
                                         model.feature_extractor.conv_layers):
        if (k, stride) == (3, 2):
            w = getattr(block, "0").weight.to(dtype).permute(2, 1, 0) \
                .contiguous()
            x = torch.randn(rows, t, w.shape[1], device="cuda",
                            generator=gen).to(dtype)
            dy = torch.randn(rows, (t - 3) // 2 + 1, c_out, device="cuda",
                             generator=gen).to(dtype)
            convs.append((x, w, dy))
        t = (t - k) // stride + 1
    fwd_ms = median_ms(forward)
    stages = {
        "forward (autograd graph)": fwd_ms,
        "loss": median_ms(lambda: loss_of([o.detach() for o in out])),
        "backward (fwd+loss+bwd minus fwd)": median_ms(
            lambda: loss_of(forward()).backward()) - fwd_ms,
        "conv_k3s2 dgrad+wgrad x4 (alone)": median_ms(
            lambda: [(conv1d_k3s2_dgrad(dy, w, x.shape[1]),
                      conv1d_k3s2_wgrad(x, dy)) for x, w, dy in convs]),
        "adamw (apply_gradients)": median_ms(
            lambda: state.apply_gradients(
                [torch.zeros_like(p) for p in state.params], None, 1.0)),
    }
    if fused == "block":
        stages["attention_block_bwd x12 (alone)"] = 12 * median_ms(
            block_bwd_alone(torch.randn(rows, t, cfg.d_model, device="cuda",
                                        generator=gen).to(dtype),
                            model.encoder.layers[0].self_attn, None, 0.1))
    for prm in model.parameters():
        prm.grad = None
    del convs
    torch.cuda.reset_peak_memory_stats()
    step_ms = median_ms(step, reps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    return {"profile": "wav2vec2-base contrastive pretraining, one step",
            "dtype": str(dtype), "fused_attention": fused, "rows": rows,
            "samples": n,
            "frames": t, "masked_slots": out[3].shape[1], "step_ms": step_ms,
            "stage_ms": stages, "kernel_ms_by_group": kernel_groups(prof),
            "device_idle_share": idle_share(prof),
            "train_audio_s_per_s": rows * n / 16_000 / (step_ms / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": float(loss.detach()),
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="one CTC training micro-step instead of a "
                           "serving dispatch")
    mode.add_argument("--pretrain", action="store_true",
                      help="one contrastive pretraining step")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions behind the headline median "
                         "(forward_ms, step_ms)")
    ap.add_argument("--fused_attention", choices=("core", "block"),
                    default="core",
                    help="the model's fused_attention for --train or "
                         "--pretrain: the attention core, or the attention "
                         "block")
    args = ap.parse_args(argv)
    if args.fused_attention == "block" and not (args.train or args.pretrain):
        ap.error("--fused_attention block needs --train or --pretrain (a "
                 "30 s serving chunk is past the block's 1024 frames)")
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.train or args.pretrain:
        fused = "block" if args.fused_attention == "block" else None
        out = (train_profile if args.train else pretrain_profile)(
            dtype, fused, args.reps)
        print(json.dumps(out), flush=True)
        return out
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
        forward_ms = median_ms(lambda: model(sig, lengths), args.reps)
        stages = stage_times(model, sig, lengths)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            model(sig, lengths)
            torch.cuda.synchronize()
    out = {
        "profile": "wav2vec2-base forward, one serving dispatch",
        "dtype": str(dtype), "batch": BATCH, "chunk_samples": CHUNK,
        "lengths": lengths.tolist(), "forward_ms": forward_ms,
        "stage_ms": stages, "stage_sum_ms": sum(stages.values()),
        "device_idle_share": idle_share(prof),
        "kernel_launches": sum(
            e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events()),
        "forward_audio_s_per_s": float(lengths.sum()) / 16_000
        / (forward_ms / 1e3),
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
