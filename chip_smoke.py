#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``audio8_tpu_torch``) on one CUDA card.

Drives the port's serving path, its CTC fine-tuning path, its
contrastive pretraining path, its seq2seq path and its paired audio-text
path at full wav2vec2-base width with seeded random weights, the
trainers' remat, SGD, augmentation and profiler flags, KenLM binaries
written by the port and the text tower's warm start, the
pretraining path again through the attention block
(``fused_attention="block"``), the public large layouts (LV-60, HuBERT,
data2vec, WavLM, conformer) and HuggingFace checkpoints, and holds every
hand-written kernel against its plain PyTorch version. Phases, each printing JSON lines:

1. build    - compile the CUDA kernels from ``audio8_tpu_torch/csrc``,
              with each kernel's registers and spills from ptxas;
2. kernel   - each kernel vs its plain version at its path's shapes
              (serving: 30 s chunks, batch 4; CTC training, extractor
              frozen or not, and the attention block: 15 s rows, batch
              4, a zero-length row), float32 and bfloat16
              where the kernel takes both, the attention core in both
              semantics ("xla", the default paths', and "kernel", the TPU
              kernel's), its backward also for bitwise-equal repeats and
              its f32 gradient copies, and the bf16 logit rounding of
              "xla" (``bf16_softmax``) at a limit that a kernel without
              it fails; then small ragged shapes, every head dim and
              misaligned pointers, which reach every variant of each
              kernel; the attention block's GEMMs, the core forward and
              the conv dgrad and wgrad on each of their three routes
              (wgmma fed by TMA, mma.sync, SIMT) and the conv forward on
              its four (those and the generic SIMT kernel), the route
              read from the profiler's kernel names and held to the
              rule, wgmma at wav2vec2-base's shapes in bf16, the wgmma
              core at T 1 to 222 with a zero-length row and dropout, the
              wgmma conv forward at T_out 30 to 299 and 1 to 20 rows,
              the wgmma conv dgrad at T_in 41 to 261 (T_out below 64, the
              tail row a tile's last, C_in != C_out, one row,
              misaligned), CTC at T 1 and 2, at input lengths far below T
              and at the state limit (2U + 1 = 2047), and repeated
              backward (attention, CTC), dgrad and wgrad calls bitwise
              equal;
3. model    - the full-width model's forward on the card (through the
              kernels) vs the same weights on the CPU (plain versions);
4. serve    - the ``a8t-serve`` path (parse_args -> load_acoustic ->
              make_server) on 127.0.0.1 answers concurrent requests of
              about 3, 12, 31 and 65 s; the kernels' launch counts over
              that run; then the same requests with ``--bf16`` under the
              profiler (``serve_bf16``): four conv forward launches per
              dispatch, all on the wgmma route by their kernel names,
              the transcripts' agreement with the f32 ones, and two of
              the served model's bf16 ``Dense`` layers held to the CPU's
              order (product rounded, then the bias added and rounded
              again; bitwise on exact integer sums);
5. train   - ``python -m audio8_tpu_torch.cli.train``'s entry point on a
              synthetic corpus: 6 optimizer steps of 2 micro-batches,
              the encoder frozen for 3 of them; step times, training
              audio-s/s and the kernels' launch counts over that run;
6. train_vs_cpu - one unfrozen full-width step, extractor included
              (dropout and masking off), on the card and on the CPU from
              the same weights: loss and gradient norm;
7. pretrain - ``python -m audio8_tpu_torch.cli.pretrain``'s entry point on
              a synthetic 4-15 s corpus at the JAX defaults (1 400 000-
              sample batches, 325 000-sample crops): 6 optimizer steps,
              step times, training audio-s/s, loss, code perplexity,
              accuracy, peak memory and the kernels' launch counts, then
              a validation pass; then 2 steps with ``--bf16`` under the
              profiler (``pretrain_bf16``): finite losses, four conv
              dgrad launches per step, every dgrad GEMM on the wgmma
              route by its kernel name, and two bf16 ``Dense`` layers
              held to the CPU as in serve_bf16; then ``restart_test``:
              ``cli.train --restart_from`` phase 7's pretrained
              ``checkpoint-step-5.pt`` (the encoder warm-starts the CTC
              model) for 3 steps on a corpus whose valid set is FLAC
              (written by ``flac_bytes``), step 1's loss held to a CPU
              model restarted from the same ``.pt`` on the same batch,
              then ``cli.test`` on the saved ``.pt``, greedy (its own
              per-utterance log-probs and transcripts held to a CPU
              ``cli.test`` run on the same files) and with ``--beam 8
              --lm`` a bigram ARPA: WER, CER, beam WER, and, as smoke
              readings of a 9-file set, the eval's audio-s/s and the
              beam's host ms per utterance (``--test-timing`` measures
              them);
8. pretrain_kernel - the conv backward, dropout, attention core
              backward and attention block kernels vs their plain
              versions at the shapes of the batches that phase 7 formed
              (each k3s2 layer's T_in, odd and even; the 768- and
              512-wide dropout inputs; the core's (B, 12, 222, 64) in
              both semantics; the block's (B, 222, 768)), float32 and
              bfloat16;
9. pretrain_vs_cpu - one full-width pretraining step (dropout off) on
              two rows of phase 7's length, on the card and on the CPU
              from the same weights and seeds: loss, contrastive loss,
              accuracy, gradient norm and how many Gumbel codeword
              indices agree;
10. pretrain_block - full-width ``make_pretrain_steps`` steps with
              ``fused_attention="block"`` at phase 7's batch shapes:
              step times, training audio-s/s, loss and launch counts (12
              block forwards and 12 block backwards per step, no core
              launch), then block and core steps in turns;
11. block_gate - eval forwards under "block": a 15 s row (749 frames)
              runs the block, a 30 s chunk (1499 frames) the core;
12. train_vs_cpu, pretrain_vs_cpu (phases 6 and 9, run here),
    block_vs_cpu - one pretraining step through the block, card vs CPU,
              with pretrain_vs_cpu's tolerances, and kernel_vs_cpu - the
              same step with ``fused_attention=True`` (the core in the TPU
              kernel's semantics on a model path) and every dropout at
              0.1, both sides fed the same seeds;
13. seq2seq - ``python -m audio8_tpu_torch.cli.train_seq2seq``'s entry
              point at full width (the wav2vec2-base encoder warm-started
              from phase 7's ``checkpoint-step-5.pt``, the default decoder
              of 768 wide, 4 heads, 2 layers, 3072, max_len 1200) on a
              letter corpus of 4-15 s rows: 6 steps of 2 micro-batches,
              the encoder frozen up to step 3, the launches of kernels 2,
              2b, 3, 4 and 5 (2b in each unfrozen micro-step and in no
              frozen one), a validation greedy and with a beam of 4 (ms
              per utterance), and the f32 and bf16 steps, frozen and
              unfrozen, timed on one batch with the device's idle share
              and the decoder's share of the step;
    paired  - ``python -m audio8_tpu_torch.cli.pretrain_paired`` at full
              width (the wav2vec2-base audio tower, the text tower 512
              wide, 8 heads, 8 layers, 2048, rpr_k 8, max reductions,
              output_dim 256) on BPE targets that ``cli.learn_bpe`` learned
              on the corpus: 6 steps of 8 rows, both towers unfrozen after
              step 3, the same launch checks and step timings;
    seq2seq_vs_cpu, paired_vs_cpu - each phase's trained weights on the
              card and the CPU: one unfrozen step (loss, gradient norm;
              paired also ``logit_scale`` after the step and
              ``clip_accuracy``), the greedy and beam-4 tokens (equal
              unless the CPU scores both choices within a tie margin),
              and one bf16 step each (the loss within 5e-3, the gradient
              norm within 2^-5);
    seq2seq_kernel, paired_kernel - kernels 2, 2b, 3, 4 and 5 against
              their plain versions, in float32 and bfloat16, at every
              shape the seq2seq and paired runs gave them (recorded at
              the layers' calls): each conv input, each attention shape
              with its key lengths and semantics (the backward where it
              ran), each dropout input (the residual streams of the
              encoders, the decoder and the text tower, and the decoder's
              and text tower's attention probabilities (B, H, T_q, T_k)),
              and AdamW over the runs' parameter shapes;
14. timing   - each kernel vs its plain version and the one PyTorch call
              that computes the same function, in turns, as device time
              (kernel durations traced by torch.profiler), with the least
              time the card could take (``bound_ms``); the attention
              backward at the training and the pretraining shapes in both
              semantics, split by launch; the attention block forward and
              backward split by launch (``launch_ms``: each GEMM, the
              core's launches, the bias partials and PyTorch's sums of the
              weight partials), with the GEMM route their kernels ran and
              the host's ms per call beside the CUDA-event ms; the core
              forward and the conv dgrad and wgrad likewise split by
              launch, with their routes and host ms, the dgrad also by
              layer beside cuDNN's;

15. serve_decode - (after the timing phase, on the serve phase's
              ``ctc.pt``) the serve phase's requests to ``--beam 8 --lm`` a trigram
              ARPA (``ops/ngram.py`` on 6 000 sentences) ``--timestamps
              true``: each text equal to a fresh CPU decoder's beam
              decode of the log-probs the request decoded (concurrent
              decodes share one loaded LM), word times inside the clip,
              ``/metrics`` counting exactly the requests sent; beam host
              ms per request;
    stream  - ``POST /stream`` of the 65 s request in 0.5 s s16 blocks,
              chunked, on that server: no error line, the final text
              equal to ``/transcribe``'s, the streamed log-probs (and a
              batch-1 ``StreamingTranscriber``'s without the batcher)
              within MODEL_TOL of the offline ones; time to the first
              partial and from the last byte to the final line;
    serve_int8 - ``--quantize int8`` in f32 and ``--bf16``: the
              quantized-layer count equals the CPU's, two int8 layers
              bitwise the CPU's (weight and activation codes, int32
              products, output), the texts' edit distance to f32's; the
              device ms of one (4, 30 s) dispatch, f32, bf16, int8 and
              int8 + bf16 in turns;
    transcribe_vad - ``cli.transcribe --vad true --timestamps true`` on
              two files with silences, card vs CPU: segments equal,
              log-probs within MODEL_TOL, rows equal unless a near tie;
    embed   - ``cli.embed --reduction_type mean`` on the pretraining
              phase's ``.pt`` over 16 files of 2-21 s,
              batch 8, card vs CPU: cosines >= 1 - 1e-4, unit norms, the
              ``--trials`` EER equal; utterances/s;
    inference_kernel - kernels 2 and 3 against their plain versions,
              f32 and bf16, at every shape those five runs gave them
              (recorded at the layers' calls);

They run after the timing phase because, run before it, they made the
timing phase's profiler traces come back empty more often and the phase
longer (PERF.md §6). ``--inference-first`` runs them after restart_test
instead, to compare.

16. topologies - each large public layout (``large-lv60``,
              ``hubert-large``, ``data2vec-large``, ``wavlm-large``,
              ``conformer-large-rope``, ``conformer-large-rel``: 24 layers
              of 1024, 16 heads, 4096) with seeded weights: one (4, 30 s)
              dispatch in f32 and in bf16 (CUDA-event ms), the card
              against the CPU on (1, 4 s) (f32 log-probs within
              MODEL_TOL), layer 0's first bf16 FFN ``Dense`` held to the
              CPU's two roundings; the core (kernel 2) runs in the
              transformer layouts and none in WavLM's and the
              conformer's (their attention is the composition, as JAX
              takes XLA); kernels 2 and 3 against their plain versions at
              every shape the dispatches gave them (16 heads);
    hf_golden - the seven HF golden fixtures of ``tests/fixtures/
              hf_golden`` written as ``save_pretrained`` directories
              (config.json and a ``model.safetensors`` written here),
              loaded through ``models/convert_hf.py:load_hf_dir`` onto the
              card: log-probs within 1e-3 of the ones ``transformers``
              computed; then ``cli.transcribe --checkpoint <dir>
              --dict_file vocab.json`` on the stable-LN one, card and CPU
              transcripts equal;
    lv60_train - ``cli.pretrain --preset large-lv60`` for 2 steps (conv
              bias and layer-mode norms through kernels 3b and 3c), then
              ``cli.train --preset large-lv60 --layer_drop 0.1
              --restart_from`` its ``.pt`` for 4 steps in f32 and in bf16,
              one unfrozen step card vs CPU (``lv60_vs_cpu``, the
              train_vs_cpu gates, LayerDrop off), and kernels 1, 2, 2b,
              3, 3b, 3c, 4 and 5 against their plain versions at every
              shape those runs gave them;
    lv60_block - pretraining steps of the LV-60 model through the
              attention block (``fused_attention="block"``, d_model 1024,
              pre-norm: 24 block forwards and backwards a step, no core
              launch), then the block against its plain versions at those
              shapes in f32 and bf16;

17. export - every ``a8t::`` custom op through ``torch.library.opcheck``
              on the card (the kernels' inputs of ``ops/samples.py``, f32
              and bf16); ``cli.export`` of the serve phase's ``ctc.pt``
              (full-width wav2vec2-base CTC) for the card with entries of
              5 s and 30 s, in f32 and bf16, and with the 30 s entry in
              ``--quantize int8``: each
              loaded artifact against the live forward on one (4, 30 s)
              batch and on a 3 s batch padded up (log-probs within
              1e-5 in f32 and int8 and 2^-5 in bf16, bitwise expected;
              argmax and greedy texts equal), one exported dispatch
              launching kernel 2 twelve times and kernel 3 four times,
              the (4, 30 s) dispatch's CUDA-event ms exported against
              live in turns (``export_timing``, f32 and bf16, with each
              side's traced device ms and costliest kernels), the three
              artifacts in a process with the port's ``models`` and
              ``nn`` blocked (its log-probs against this process's);
              then ``cli.transcribe``, ``cli.test``, ``cli.serve`` and
              ``cli.embed`` with ``--exported`` (``phase_export_clis``);

18. remat  - one full-width pretraining step at the pretraining cell's
              shape (20 rows of 71 428 samples, dropout 0.1, f32) without
              and with ``remat`` from the same weights and generator seed:
              the loss equal, the gradient norm within 1e-5, every
              gradient within 1e-2 of its leaf's scale, the generator's
              stream equal, kernel 2 and the layers' dropouts launched
              twice, the peak memory lower; each run's peak memory, step
              ms and launches; then ``cli.train --remat true --optim sgd``
              for 4 CTC steps (``remat_sgd``): kernels 1 and 2 in every
              micro-step, the recompute in the unfrozen ones, kernel 5
              never;
    augment - ``cli.train --speed_perturb 0.9 1.0 1.1 --noise_manifest``
              over synthetic noise clips with ``--profile_dir`` for 12
              steps: finite losses, both augmentations applied, the
              Chrome trace of the window after step 10 parsed, its
              ``ProfilerStep#`` spans and CUDA kernel events counted;
    kenlm_binary - ``cli.build_binary`` writes PROBING, TRIE and
              QUANT_TRIE binaries of the serve phase's trigram ARPA, and
              ``cli.test --beam 8 --lm`` decodes with each on the card:
              PROBING and TRIE transcripts equal the ARPA run's, the
              QUANT_TRIE WER difference and each LM's load seconds
              printed;
    warmstart - a ``.npz`` from the port's ``save_tlm_npz`` of a seeded
              text tower in the paired cell's text config, then
              ``cli.pretrain_paired --warmstart_text`` for 2 steps: every
              array loaded, nothing unexpected or missing, the frozen
              text tower equal to the file after the run, finite losses;

then a ``phase_seconds`` line (each phase's wall seconds and each phase's
retried profiler traces, ``trace_retries``), a ``kernels``
line, the card's name and power limit from nvidia-smi,
and, last, ``{"ok": true, "device": {...}}``. Any failed check raises, so
the exit code is non-zero and the last line is not printed. Without a CUDA
card it exits with code 2 and prints no result.

    python3 chip_smoke.py
    python3 chip_smoke.py --block-timing   # only the block's timing rows
    python3 chip_smoke.py --core-timing    # only rows 1, 2, 3, 3b, 3c, 6
    python3 chip_smoke.py --test-timing    # only cli.test's throughput
    python3 chip_smoke.py --freeze-timing  # frozen steps, two ways
    python3 chip_smoke.py --inference-first  # the full run, phases 15
                                             # before the timing phase
    python3 chip_smoke.py --topology-phases  # the build and phase 16 only
    python3 chip_smoke.py --export-phases    # the build and phase 17 only
    python3 chip_smoke.py --host-timing      # the wrappers' host cost
    python3 chip_smoke.py --trainer-phases   # the build and phase 18 only

``--block-timing`` builds the block's two sources and prints only the
attention block's timing rows (phase 14) in float32 and bfloat16, then
the card's name and power limit;
it drives only the wrappers that every tree of the port has had since
the block came, so a copy placed in another tree's root times that
tree's kernels (two trees in turns in one call). ``--core-timing`` does
the same for the CTC loss and gradient at the training shape (split
into the recursion and the gradient's launch), the conv forward of the
four k3s2 layers of (4, 30 s) (each layer beside cuDNN's), the
attention core's forward at the serving shape in both semantics, the
conv dgrad and wgrad of the four k3s2 layers of (4, 15 s) and the
block's forward, each row with its launch split, its route (read from the
kernels' names, and from the port's Python rule where the tree has
one) and the host's ms per call. ``--test-timing`` times ``cli.test``
on the card over 320 FLACs of 1.5-15 s against a trigram ARPA of
200 000 words: the greedy eval's audio-s/s (three runs after a warm-up),
the beam+LM decode (``--beam 8 --lm``) on a random model's log-probs,
and ``run_step``'s beam+LM decode of log-probs shaped like a trained
model's (``peaky_log_probs``), in host ms per utterance.
``--export-phases`` runs the build and phase 17 alone on a ``ctc.pt`` of
the model phase's weights (phase 17 took 144.6 s of a full run on an
H100 80GB HBM3 at 700 W). ``--host-timing`` prints the host us per
call of ``fused_dropout`` and ``attention_core`` and the wall ms of a
bf16 pretraining step; a copy placed in another tree's root times that
tree (two trees in turns in one call).
``--trainer-phases`` runs the build and phase 18 alone on fresh corpora
(it writes the train phase's corpus, the serve phase's ARPA and the
paired corpus itself).
``--freeze-timing`` times the frozen seq2seq and paired steps at full
width (random weights) in float32 and bfloat16 two ways, in turns: as
the port runs them, a frozen tower under ``torch.no_grad()``, and with
the frozen towers' graphs built and their outputs detached (the JAX
``stop_gradient`` written as ``.detach()``): the wall ms of 10 steps,
the device ms and idle share of two more in one trace, and the peak
memory of a step.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
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
# training path shapes: batch 4 of 15 s rows (749 frames), 14 letters/s
TRAIN_ATTN_SHAPE = (4, 12, 749, 64)
TRAIN_ATTN_LENGTHS = [749, 612, 0, 377]  # a padding row of a snapped batch
# the pretraining batches' core: 20 rows of 222 frames, no padding
PRETRAIN_ATTN_SHAPE = (20, 12, 222, 64)
CTC_SHAPE = (4, 749, 4 + len(LETTERS))
CTC_INPUT_LENGTHS = [749, 700, 601, 0]
CTC_TARGET_LENGTHS = [210, 195, 170, 0]
# card vs CPU, one full-width training step in float32
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-4, 1e-3
# (T_in, C_in, C_out) of the four k3s2 extractor layers on a 15 s row,
# batch 4 (179 984 output rows): the CTC trainer's unfrozen extractor and
# the timing rows; the pretraining batches' own shapes are checked after
# its run (phase_pretrain_path_kernels)
TRAIN_CONV_SHAPES = [(47_999, 512, 512), (23_999, 512, 512),
                     (11_999, 512, 512), (5_999, 512, 512)]
DROPOUT_SHAPE = (4, 749, 768)  # the encoder's residual stream, 15 s rows
DROPOUT_RATE, DROPOUT_SEED = 0.1, 3_000_000_007
# card vs CPU, one full-width pretraining step in float32: a Gumbel
# argmax near a tie may flip under rounding, so the codeword agreement
# is a share and the loss and norm tolerances allow for a few flips. The
# contrastive loss (the only term that sees the encoder) is held to
# CONTRASTIVE_RTOL when every codeword agrees, else to the loss's; the
# accuracy may differ by one masked slot's argmax.
PRETRAIN_LOSS_RTOL, PRETRAIN_GNORM_RTOL, CODE_AGREEMENT = 1e-3, 1e-2, 0.999
CONTRASTIVE_RTOL = 1e-4
# the attention block (kernels 6/6b): wav2vec2-base's 12 heads of 64
BLOCK_HEADS = 12
# (B, T, D, H, key lengths): each head dim, T to 1024, and H*dh = 48, whose
# dx product's 48-deep K segments send bf16 to the SIMT tile
BLOCK_VARIANTS = [
    (3, 37, 64, 4, [37, 12, 0]), (3, 130, 64, 2, [130, 7, 0]),
    (3, 130, 256, 2, [130, 64, 0]), (2, 1024, 768, 12, [1024, 3]),
    (3, 37, 48, 3, [37, 20, 0])]
# H100 SXM nominal peaks (dense): f32 without TF32, bf16, HBM3
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12


def wgrad_tol(rows: int, scale: float, dtype) -> float:
    """Bound on |kernel - plain| for wgrad, which writes f32 sums of exact
    products (a bf16 product is exact in f32) in both dtypes, so both
    bounds are at f32 level. float32: TOL, 1e-5 * max(1, max|plain|).
    bfloat16: the tensor cores' f32 accumulation rounds otherwise than
    the plain version's, and two f32 sums of ``rows`` terms in different
    orders agree to about sqrt(rows) * 2^-24 * max|sum|: four times that,
    and at least the float32 bound. A 64-row block skipped or added moves
    dW by about sqrt(64) times a product, hundreds of times either."""
    rel = TOL[torch.float32]
    if dtype == torch.bfloat16:
        rel = max(rel, 4.0 * math.sqrt(rows) * 2.0 ** -24)
    return rel * max(1.0, scale)


def sum_tol(rows: int, scale: float, dtype) -> float:
    """Bound on |kernel - plain| for the attention block's bias gradients,
    column sums over ``rows`` = B * T_pad rows of the core's f32 dq, dk,
    dv. Each summand agrees with the plain version's to about TOL of a
    row's size (the core sums in another order), and the differences add
    like a random walk, so the bound is TOL * sqrt(rows) for unit-size
    rows, and TOL * max|plain| where the sum is larger than that. dbk
    cancels to about zero (a softmax ignores a key bias), so only the
    first term holds it; a 64-row tile skipped or counted twice moves a
    sum by about sqrt(64) times a row's size, which is far outside."""
    return TOL[dtype] * max(math.sqrt(rows), scale)


def ctc_grad_tol(t: int, ll_max: float) -> float:
    """Bound on |kernel - plain| for the CTC gradient. gamma = alpha + beta
    - emit - ll cancels terms of size |ll|, and each of the 2T steps of
    the recursions rounds at that size, so two f32 evaluations in
    different orders agree to about sqrt(T) * 2^-24 * |ll| (times 2)."""
    return 2.0 * math.sqrt(t) * 2.0 ** -24 * max(1.0, ll_max)


PHASE_SECONDS: dict = {}  # wall seconds of each phase of a full run
# each phase's retried profiler traces (count_retry), and the phase running
TRACE_RETRIES: dict = {}
PHASE_NOW = {"name": None}


@contextlib.contextmanager
def timed(name: str):
    """Add the wall seconds of the block to ``PHASE_SECONDS[name]``."""
    t0 = time.perf_counter()
    PHASE_NOW["name"] = name
    try:
        yield
    finally:
        PHASE_NOW["name"] = None
        PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                               + time.perf_counter() - t0)


def count_retry() -> None:
    """One more retried (empty or unframed) trace in the running phase."""
    TRACE_RETRIES[PHASE_NOW["name"]] = (
        TRACE_RETRIES.get(PHASE_NOW["name"], 0) + 1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    return ((a.float() - b.float()).abs().max().item(),
            b.float().abs().max().item())


def phase_build() -> None:
    """Build every kernel; prints each kernel's registers and spills as
    ptxas reports them."""
    from audio8_tpu_torch.csrc.build import ptxas_report
    from audio8_tpu_torch.ops import _ext

    t0 = time.perf_counter()
    libs = _ext.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(os.path.relpath(p, HERE) for p in libs.values()),
          "ptxas": {src: ptxas_report(lib) for src, lib in libs.items()}})


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
    16-byte boundary: the kernels' generic (non-vector) variants, or the
    conv backward wrappers' aligned copy."""
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
            route = check_conv_fwd_route(x, w, lambda: conv1d_k3s2(x, w))
            err, scale = max_err(conv1d_k3s2(x, w), conv1d_k3s2_plain(x, w))
            tol = TOL[dtype] * max(1.0, scale)
            emit({"phase": "variant", "kernel": "conv_k3s2_fwd",
                  "dtype": str(dtype), "shape": list(shape),
                  "misaligned": skew, "route": route, "max_abs_err": err,
                  "tol": tol})
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
            route = check_attn_route(q, k, v, lambda: attention_core(
                q, k, v, kv, dh ** -0.5))
            for rate, xla in ((0.0, False), (0.1, False), (0.1, True)):
                sem = dict(xla=xla, bf16_softmax=True)
                err, scale = max_err(
                    attention_core(q, k, v, kv, dh ** -0.5, rate, 7, **sem),
                    attention_core_plain(q, k, v, kv, dh ** -0.5, rate, 7,
                                         **sem))
                tol = TOL[dtype] * max(1.0, scale)
                emit({"phase": "variant", "kernel": "attention_fwd",
                      "dtype": str(dtype), "shape": list(shape), "rate": rate,
                      "xla": xla, "misaligned": skew, "route": route,
                      "max_abs_err": err, "tol": tol})
                check(err <= tol,
                      f"attention_fwd variant {shape} {dtype}: {err}")
    phase_core_variants(gen)
    phase_conv_fwd_variants(gen)


# (B, T_in, C_in, C_out) of the bf16 conv forward's wgmma variants: T_out
# 30 (below one 64-row box), 128 (one M tile), 299 and 149 (ragged), 1 and
# 20 batch rows, 64 -> 128 and 512 -> 512 channels
CONV_FWD_VARIANTS = [(1, 61, 64, 128), (20, 257, 64, 128),
                     (4, 599, 512, 512), (20, 299, 512, 512),
                     (1, 257, 512, 512), (20, 61, 512, 512)]


def phase_conv_fwd_variants(gen) -> None:
    """bf16 through the conv forward's wgmma route (TMA-fed, M tiles on
    the padded (b, T_pad) grid) at T_out below, at and past one 128-row
    tile, against the plain version; a misaligned copy of the same inputs
    takes the generic route and must agree too."""
    from audio8_tpu_torch.ops.conv import conv1d_k3s2, conv1d_k3s2_plain

    for shape in CONV_FWD_VARIANTS:
        b, t, c_in, c_out = shape
        x = torch.randn(b, t, c_in, device="cuda", generator=gen)
        w = torch.randn(3, c_in, c_out, device="cuda", generator=gen)
        x, w = x.bfloat16(), (w / np.sqrt(3 * c_in)).bfloat16()
        for skew in (False, True):
            xs, ws = (misaligned(x), misaligned(w)) if skew else (x, w)
            route = check_conv_fwd_route(xs, ws,
                                         lambda: conv1d_k3s2(xs, ws))
            check(route == ("generic" if skew else "wgmma"),
                  f"bf16 conv forward {shape} misaligned={skew} took the "
                  f"{route} route")
            y = conv1d_k3s2(xs, ws)
            torch.cuda.synchronize()
            err, scale = max_err(y, conv1d_k3s2_plain(x, w))
            tol = TOL[torch.bfloat16] * max(1.0, scale)
            emit({"phase": "variant", "kernel": "conv_k3s2_fwd",
                  "dtype": "torch.bfloat16", "shape": list(shape),
                  "misaligned": skew, "route": route, "max_abs_err": err,
                  "tol": tol})
            check(bool(torch.isfinite(y).all()) and err <= tol,
                  f"conv_k3s2_fwd {route} variant {shape}: {err} > {tol}")


# (T, key lengths of the three batch rows) of the wgmma core's variants:
# one key, T below one tile, a ragged last tile, two query tiles, the
# pretraining frames; each with a zero-length row
CORE_VARIANTS = [(1, [1, 1, 0]), (65, [65, 20, 0]), (130, [130, 64, 0]),
                 (222, [222, 101, 0])]


def phase_core_variants(gen) -> None:
    """bf16 at head dims 64 and 128 through the wgmma core (TMA-fed) at
    T below, at and past one 64-key tile and two 128-query tiles, with a
    zero-length row (uniform over its keys), in both semantics with and
    without dropout, against the plain version."""
    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_plain)

    for dh in (64, 128):
        for t, lengths in CORE_VARIANTS:
            shape = (3, 2, t, dh)
            q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                       .bfloat16() for _ in range(3))
            kv = (torch.arange(t, device="cuda")[None, :]
                  < torch.tensor(lengths, device="cuda")[:, None])
            route = check_attn_route(q, k, v, lambda: attention_core(
                q, k, v, kv, dh ** -0.5))
            check(route == "wgmma", f"bf16 dh {dh} took the {route} core")
            for rate, xla in ((0.0, False), (0.0, True), (0.1, False),
                              (0.1, True)):
                sem = dict(xla=xla, bf16_softmax=True)
                o = attention_core(q, k, v, kv, dh ** -0.5, rate, 11, **sem)
                torch.cuda.synchronize()
                err, scale = max_err(o, attention_core_plain(
                    q, k, v, kv, dh ** -0.5, rate, 11, **sem))
                tol = TOL[torch.bfloat16] * max(1.0, scale)
                emit({"phase": "variant", "kernel": "attention_fwd",
                      "dtype": "torch.bfloat16", "shape": list(shape),
                      "key_lengths": lengths, "rate": rate, "xla": xla,
                      "route": route, "max_abs_err": err, "tol": tol})
                check(bool(torch.isfinite(o).all()) and err <= tol,
                      f"attention_fwd wgmma variant {shape} rate {rate} "
                      f"xla {xla}: {err} > {tol}")


def phase_kernels(gen) -> dict:
    """Each kernel vs its plain version; returns the float32 max errors."""
    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_plain)
    from audio8_tpu_torch.ops.conv import conv1d_k3s2, conv1d_k3s2_plain

    worst = {"conv_k3s2_fwd": 0.0, "attention_fwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in CONV_SHAPES:
            x, w = conv_inputs(shape, dtype, gen)
            route = check_conv_fwd_route(x, w, lambda: conv1d_k3s2(x, w))
            y = conv1d_k3s2(x, w)
            torch.cuda.synchronize()
            err, scale = max_err(y, conv1d_k3s2_plain(x, w))
            tol = TOL[dtype] * max(1.0, scale)
            emit({"phase": "kernel", "kernel": "conv_k3s2_fwd",
                  "dtype": str(dtype), "shape": [CHUNK_BATCH, *shape],
                  "route": route, "max_abs_err": err, "tol": tol})
            check(bool(torch.isfinite(y).all()) and err <= tol,
                  f"conv_k3s2_fwd {dtype} {shape}: {err} > {tol}")
            if dtype == torch.float32:
                worst["conv_k3s2_fwd"] = max(worst["conv_k3s2_fwd"], err)
        q, k, v, kv = attn_inputs(dtype, gen)
        route = check_attn_route(
            q, k, v, lambda: attention_core(q, k, v, kv, 0.125, xla=True))
        for (rate, seed), xla in ((r, x) for r in ((0.0, 0), (0.1, 1234))
                                  for x in (True, False)):
            sem = dict(xla=xla, bf16_softmax=True)
            o = attention_core(q, k, v, kv, 0.125, rate, seed, **sem)
            torch.cuda.synchronize()
            err, scale = max_err(o, attention_core_plain(q, k, v, kv, 0.125,
                                                         rate, seed, **sem))
            tol = TOL[dtype] * max(1.0, scale)
            emit({"phase": "kernel", "kernel": "attention_fwd",
                  "dtype": str(dtype), "shape": list(ATTN_SHAPE),
                  "key_lengths": ATTN_LENGTHS, "rate": rate, "seed": seed,
                  "xla": xla, "route": route, "max_abs_err": err,
                  "tol": tol})
            check(bool(torch.isfinite(o).all()) and err <= tol,
                  f"attention_fwd {dtype} rate {rate}: {err} > {tol}")
            if dtype == torch.float32:
                worst["attention_fwd"] = max(worst["attention_fwd"], err)
    check_logit_rounding(gen)
    return worst


def check_logit_rounding(gen) -> None:
    """``bf16_softmax`` under "xla": both kernels round the scaled bf16
    logits to bf16 before the softmax. Logits of size 4 (q, k ~ N(0, 4))
    make the rounding move each probability by about 1%. The forward's
    row max must be the max of the rounded logits, bitwise, on at least
    99% of the rows with a valid key (the two f32 sums may round to
    neighbouring bf16 values), where the unrounded max almost never is;
    the backward's f32 gradient copies must sit within a quarter of the
    mean distance between the plain f32 gradients with and without the
    rounding, which a kernel that skipped it would be away."""
    from audio8_tpu_torch.ops.attention import (NEG, _forward_kernel,
                                                attention_core_bwd,
                                                attention_core_bwd_f32)

    _, h, t, dh = PRETRAIN_ATTN_SHAPE
    b = 4
    shape = (b, h, t, dh)
    q, k = (2.0 * torch.randn(shape, device="cuda", generator=gen)
            for _ in range(2))
    v, do = (torch.randn(shape, device="cuda", generator=gen)
             for _ in range(2))
    q, k, v, do = (x.bfloat16() for x in (q, k, v, do))
    kv = (torch.arange(t, device="cuda")[None, :]
          < torch.tensor([t, 150, 0, 77], device="cuda")[:, None])
    sem = dict(xla=True, bf16_softmax=True)
    _, stats, o32 = _forward_kernel(q, k, v, kv, dh ** -0.5, 0.0, 0, True,
                                    **sem)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh ** -0.5
    neg = torch.tensor(NEG, device="cuda")
    rows = kv.any(-1)[:, None, None].expand(b, h, t).flatten()
    m = stats[:, 0][rows]
    share = {name: float((m == torch.where(kv[:, None, None, :], x, neg)
                          .amax(-1).flatten()[rows]).float().mean())
             for name, x in (("rounded", s.bfloat16().float()),
                             ("unrounded", s))}
    got = attention_core_bwd(q, k, v, o32, stats, kv, dh ** -0.5, 0.0, 0,
                             do, f32_copies=True, **sem)[3:]
    want = attention_core_bwd_f32(q, k, v, kv, dh ** -0.5, 0.0, 0, do,
                                  **sem)
    other = attention_core_bwd_f32(q, k, v, kv, dh ** -0.5, 0.0, 0, do,
                                   xla=True, bf16_softmax=False)
    errs = {}
    for name, g, w, o in zip(("dq32", "dk32", "dv32"), got, want, other):
        err, gap = [float((a - c).abs().mean()) for a, c in ((g, w), (w, o))]
        errs[name] = {"mean_err": err, "mean_gap": gap}
        check(gap > 0.0 and err <= gap / 4,
              f"bf16 logit rounding {name}: mean error {err} vs the "
              f"rounding's {gap}")
    emit({"phase": "kernel", "kernel": "attention_fwd+bwd",
          "check": "bf16_softmax logit rounding", "shape": list(shape),
          "row_max_equal_share": share, "grads": errs})
    check(share["rounded"] >= 0.99 and share["unrounded"] < 0.5,
          f"bf16 logit rounding, forward row max: {share}")


def attn_grads(q, k, v, kv, rate, seed, do, xla):
    """(dq, dk, dv) through the kernels (autograd) twice, and the plain
    backward on the same inputs."""
    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_bwd_plain)

    dh = q.shape[-1]
    sem = dict(xla=xla, bf16_softmax=True)
    runs = []
    for _ in range(2):
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = attention_core(qg, kg, vg, kv, dh ** -0.5, rate, seed, **sem)
        runs.append(torch.autograd.grad(out, (qg, kg, vg), do))
    torch.cuda.synchronize()
    with torch.no_grad():
        want = attention_core_bwd_plain(q, k, v, kv, dh ** -0.5, rate, seed,
                                        do, **sem)
    return runs, want


def check_f32_copies(q, k, v, kv, rate, seed, do, xla) -> dict:
    """The backward's f32 gradient copies (which the attention block's
    bias gradients sum) vs the plain f32 backward."""
    from audio8_tpu_torch.ops.attention import (_forward_kernel,
                                                attention_core_bwd,
                                                attention_core_bwd_f32)

    dh = q.shape[-1]
    sem = dict(xla=xla, bf16_softmax=True)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    _, stats, o32 = _forward_kernel(qc, kc, vc, kv, dh ** -0.5, rate, seed,
                                    True, **sem)
    got = attention_core_bwd(qc, kc, vc, o32, stats, kv, dh ** -0.5, rate,
                             seed, do, f32_copies=True, **sem)[3:]
    torch.cuda.synchronize()
    want = attention_core_bwd_f32(q, k, v, kv, dh ** -0.5, rate, seed, do,
                                  **sem)
    errs = {}
    for name, g, w in zip(("dq32", "dk32", "dv32"), got, want):
        err, scale = max_err(g, w)
        tol = TOL[q.dtype] * max(1.0, scale)
        check(bool(torch.isfinite(g).all()) and err <= tol,
              f"attention_bwd {name} {tuple(q.shape)}: {err} > {tol}")
        errs[name] = err
    return errs


def check_attn_bwd(phase, shape, lengths, dtype, gen,
                   skew: bool = False) -> float:
    """The backward kernel vs its plain version in both semantics, rates
    0 and 0.1: gradients within TOL, two calls bitwise equal, and (rate
    0.1) the f32 copies within TOL; returns the largest error."""
    b, h, t, dh = shape
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    if skew:
        q, k, v, do = (misaligned(x) for x in (q, k, v, do))
    kv = None if lengths is None else (
        torch.arange(t, device="cuda")[None, :]
        < torch.tensor(lengths, device="cuda")[:, None])
    worst = 0.0
    for xla in (True, False):
        for rate, seed in ((0.0, 0), (0.1, 4_000_000_000)):
            (got, again), want = attn_grads(q, k, v, kv, rate, seed, do, xla)
            errs = {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err, scale = max_err(g, w)
                tol = TOL[dtype] * max(1.0, scale)
                errs[name] = err
                check(bool(torch.isfinite(g).all()) and err <= tol,
                      f"attention_bwd {name} {shape} {dtype} rate {rate} "
                      f"xla {xla}: {err} > {tol}")
                worst = max(worst, err)
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            check(same, f"attention_bwd {shape} {dtype}: repeats differ")
            if rate > 0.0:
                errs.update(check_f32_copies(q, k, v, kv, rate, seed, do,
                                             xla))
            emit({"phase": phase, "kernel": "attention_bwd",
                  "dtype": str(dtype), "shape": list(shape),
                  "key_lengths": lengths, "rate": rate, "xla": xla,
                  "misaligned": skew, "max_abs_err": errs,
                  "tol_factor": TOL[dtype], "repeat_bitwise_equal": same})
    return worst


def block_inputs(b, t, d, dtype, gen):
    """x (B, T, D) and the block's weights and biases in the Dense layout
    (wq, bq, wk, bk, wv, bv, wo, bo), LeCun-scaled weights, biases of
    0.1: the sizes of a trained layer's."""
    x = torch.randn(b, t, d, device="cuda", generator=gen)
    weights = []
    for _ in range(4):
        w = torch.randn(d, d, device="cuda", generator=gen) / math.sqrt(d)
        weights += [w, 0.1 * torch.randn(d, device="cuda", generator=gen)]
    return x.to(dtype), [w.to(dtype) for w in weights]


BLOCK_GRADS = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")


# the GEMM routes check_block saw the block's kernels run
BLOCK_ROUTES_SEEN = set()


def check_block_route(b, t, d, heads, dtype, run) -> str:
    """The GEMM route of the block at this shape: the kernels' own rule
    (``a8t_attention_block_route``) and its Python mirror agree, and the
    kernels that ``run`` (a forward and backward) launches, read from the
    profiler's kernel names, are that route's only."""
    from audio8_tpu_torch.ops import _ext
    from audio8_tpu_torch.ops.attention_block import GEMM_ROUTES, gemm_route

    route = gemm_route(dtype, d, heads, d // heads)
    code = _ext.function("attention_block_fwd.cu", "route")(
        _ext.DTYPE_CODES[dtype], d, heads, d // heads)
    check(GEMM_ROUTES[code] == route, f"attention_block route {route} vs "
          f"the kernels' {GEMM_ROUTES[code]} at {(b, t, d, heads)} {dtype}")
    seen = {gemm_route_of(n) for n in traced_ms(run, budget=False)} - {None}
    check(seen == {route}, f"attention_block {(b, t, d, heads)} {dtype}: "
          f"GEMM kernels of {seen}, want {route}")
    BLOCK_ROUTES_SEEN.add(route)
    return route


# the routes the attention core's forward and the conv wgrad were seen
# to run (each checked once against the kernels' rule and the profiler)
ATTN_ROUTES_SEEN = set()
WGRAD_ROUTES_SEEN = set()
DGRAD_ROUTES_SEEN = set()
CONV_FWD_ROUTES_SEEN = set()


def check_kernel_route(seen, what, route, code, routes, run, route_of) -> str:
    """A kernel's route at one call: its Python mirror (``route``) equals
    the kernels' own rule (``routes[code]``), and, the first time a route
    is seen, the kernels that ``run`` launches, read from the profiler's
    kernel names, are that route's only."""
    check(routes[code] == route, f"{what}: route {route} vs the kernels' "
          f"{routes[code]}")
    if route not in seen:
        ran = {route_of(n) for n in traced_ms(run, budget=False)} - {None}
        check(ran == {route}, f"{what}: kernels of {ran}, want {route}")
        seen.add(route)
    return route


def check_attn_route(q, k, v, run) -> str:
    """:func:`check_kernel_route` for the attention core's forward."""
    from audio8_tpu_torch.ops import _ext
    from audio8_tpu_torch.ops.attention import FWD_ROUTES, attention_route

    aligned = all(a.data_ptr() % 16 == 0 for a in (q, k, v))
    dh = q.shape[-1]
    code = _ext.function("attention_fwd.cu", "route")(
        _ext.DTYPE_CODES[q.dtype], dh, int(aligned))
    return check_kernel_route(
        ATTN_ROUTES_SEEN, f"attention_fwd {tuple(q.shape)} {q.dtype} "
        f"aligned={aligned}", attention_route(q.dtype, dh, aligned), code,
        FWD_ROUTES, run, core_route_of)


def check_wgrad_route(x, dy, run) -> str:
    """:func:`check_kernel_route` for the conv wgrad."""
    from audio8_tpu_torch.ops import _ext
    from audio8_tpu_torch.ops.conv import WGRAD_ROUTES, wgrad_route

    c_in, c_out = x.shape[2], dy.shape[2]
    code = _ext.function("conv_k3s2_bwd.cu", "wgrad_route")(
        _ext.DTYPE_CODES[x.dtype], c_in, c_out)
    return check_kernel_route(
        WGRAD_ROUTES_SEEN, f"conv_k3s2_wgrad {tuple(x.shape)} -> {c_out} "
        f"{x.dtype}", wgrad_route(x.dtype, c_in, c_out), code, WGRAD_ROUTES,
        run, wgrad_route_of)


def check_dgrad_route(dy, w, run) -> str:
    """:func:`check_kernel_route` for the conv dgrad."""
    from audio8_tpu_torch.ops import _ext
    from audio8_tpu_torch.ops.conv import DGRAD_ROUTES, dgrad_route

    c_in, c_out = w.shape[1], dy.shape[2]
    code = _ext.function("conv_k3s2_bwd.cu", "dgrad_route")(
        _ext.DTYPE_CODES[dy.dtype], c_in, c_out)
    return check_kernel_route(
        DGRAD_ROUTES_SEEN, f"conv_k3s2_dgrad {tuple(dy.shape)} -> {c_in} "
        f"{dy.dtype}", dgrad_route(dy.dtype, c_in, c_out), code, DGRAD_ROUTES,
        run, dgrad_route_of)


def check_conv_fwd_route(x, w, run) -> str:
    """:func:`check_kernel_route` for the conv forward (its output, from
    ``torch.empty``, is aligned)."""
    from audio8_tpu_torch.ops import _ext
    from audio8_tpu_torch.ops.conv import FWD_ROUTES, fwd_route

    c_in, c_out = w.shape[1], w.shape[2]
    aligned = all(a.data_ptr() % 16 == 0 for a in (x, w))
    code = _ext.function("conv_k3s2_fwd.cu", "route")(
        _ext.DTYPE_CODES[x.dtype], c_in, c_out, int(aligned))
    return check_kernel_route(
        CONV_FWD_ROUTES_SEEN, f"conv_k3s2_fwd {tuple(x.shape)} -> {c_out} "
        f"{x.dtype} aligned={aligned}", fwd_route(x.dtype, c_in, c_out,
                                                  aligned), code, FWD_ROUTES,
        run, conv_fwd_route_of)


def check_block(phase, b, t, d, heads, lengths, dtype, gen) -> tuple:
    """The block's forward (with and without the backward's residuals)
    and its nine gradients, through the kernels, vs the plain versions on
    the same inputs, at rates 0 and 0.1; every row is compared, a
    zero-length row included; a second backward must be bitwise equal to
    the first, and the GEMM kernels must be the shape's route
    (:func:`check_block_route`). Returns the largest forward and gradient
    errors."""
    from audio8_tpu_torch.ops.attention_block import (
        attention_block, attention_block_bwd_plain, attention_block_plain)

    x, weights = block_inputs(b, t, d, dtype, gen)
    dy = torch.randn(b, t, d, device="cuda", generator=gen).to(dtype)
    kv = None if lengths is None else (
        torch.arange(t, device="cuda")[None, :]
        < torch.tensor(lengths, device="cuda")[:, None])
    scale = (d // heads) ** -0.5
    rows = b * ((t + 127) // 128 * 128)
    worst_fwd = worst_bwd = 0.0
    route = None
    for rate, seed in ((0.0, 0), (0.1, 3_000_000_019)):
        xs = [a.detach().requires_grad_() for a in (x, *weights)]
        out = attention_block(*xs, kv, heads, scale, rate, seed)
        got = torch.autograd.grad(out, xs, dy, retain_graph=True)
        again = torch.autograd.grad(out, xs, dy)
        check(all(torch.equal(g1, g2) for g1, g2 in zip(got, again)),
              f"attention_block_bwd {(b, t, d, heads)} {dtype} rate {rate}: "
              "repeated backward calls differ")
        if route is None:
            route = check_block_route(
                b, t, d, heads, dtype,
                lambda: torch.autograd.grad(attention_block(
                    *xs, kv, heads, scale, rate, seed), xs, dy))
        with torch.no_grad():
            evaluated = attention_block(x, *weights, kv, heads, scale, rate,
                                        seed)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = attention_block_plain(x, *weights, kv, heads, scale, rate,
                                         seed)
            want_g = attention_block_bwd_plain(x, *weights, kv, heads, scale,
                                               rate, seed, dy)
        errs = {}
        for name, g, w in zip(("out", "out_eval") + BLOCK_GRADS,
                              (out, evaluated, *got), (want, want, *want_g)):
            err, size = max_err(g, w)
            tol = (sum_tol(rows, size, dtype) if name in ("bq", "bk", "bv")
                   else TOL[dtype] * max(1.0, size))
            errs[name] = err
            check(g.shape == w.shape and bool(torch.isfinite(g).all())
                  and err <= tol, f"attention_block {name} {(b, t, d, heads)} "
                  f"{dtype} rate {rate}: {err} > {tol}")
        worst_fwd = max(worst_fwd, errs["out"], errs["out_eval"])
        worst_bwd = max(worst_bwd, *(errs[k] for k in BLOCK_GRADS))
        emit({"phase": phase, "kernel": "attention_block(+_bwd)",
              "dtype": str(dtype), "shape": [b, t, d, heads],
              "key_lengths": lengths, "rate": rate, "gemm_route": route,
              "max_abs_err": errs, "tol_factor": TOL[dtype],
              "bias_grad_rows": rows, "repeat_bitwise_equal": True})
    return worst_fwd, worst_bwd


def ctc_inputs(shape, input_lengths, target_lengths, gen):
    b, t, v = shape
    lp = torch.log_softmax(torch.randn(shape, device="cuda", generator=gen),
                           dim=-1)
    u = max(max(target_lengths), 1)
    tg = torch.randint(4, v, (b, u), device="cuda", generator=gen)
    return (lp, torch.tensor(input_lengths, device="cuda"), tg,
            torch.tensor(target_lengths, device="cuda"))


def check_ctc(phase, shape, input_lengths, target_lengths, gen) -> float:
    """Loss and gradient of the kernel vs the plain scan (autograd)."""
    from audio8_tpu_torch.ops.ctc import ctc_loss, ctc_loss_plain

    lp, il, tg, tl = ctc_inputs(shape, input_lengths, target_lengths, gen)
    lpk = lp.detach().requires_grad_()
    loss = ctc_loss(lpk, il, tg, tl, blank=0, reduction="none")
    w = torch.rand(shape[0], device="cuda", generator=gen)
    (grad,) = torch.autograd.grad((loss * w).sum(), lpk, retain_graph=True)
    (again,) = torch.autograd.grad((loss * w).sum(), lpk)
    torch.cuda.synchronize()
    check(torch.equal(grad, again),
          f"ctc_loss {shape}: repeated backward calls differ")
    lpp = lp.detach().requires_grad_()
    plain = ctc_loss_plain(lpp, il, tg, tl, 0)
    plain = torch.where(plain >= 5e29, torch.zeros_like(plain), plain)
    (pgrad,) = torch.autograd.grad((plain * w).sum(), lpp)
    l_err, l_scale = max_err(loss, plain)
    g_err, _ = max_err(grad, pgrad)
    l_tol = TOL[torch.float32] * max(1.0, l_scale)
    g_tol = ctc_grad_tol(shape[1], l_scale)
    emit({"phase": phase, "kernel": "ctc_loss", "shape": list(shape),
          "input_lengths": input_lengths, "target_lengths": target_lengths,
          "loss_max_abs_err": l_err, "loss_tol": l_tol,
          "grad_max_abs_err": g_err, "grad_tol": g_tol, "max_loss": l_scale,
          "repeat_bitwise_equal": True})
    check(bool(torch.isfinite(grad).all()) and l_err <= l_tol
          and g_err <= g_tol, f"ctc_loss {shape}: loss {l_err} grad {g_err}")
    return max(l_err, g_err)


def adamw_leaves(shapes, gen):
    p, g, m = ([torch.randn(s, device="cuda", generator=gen) for s in shapes]
               for _ in range(3))
    v = [torch.rand(s, device="cuda", generator=gen) for s in shapes]
    return p, g, m, v


def check_adamw(phase, shapes, gen, misalign=False) -> float:
    from audio8_tpu_torch.ops.adamw import adamw_update, adamw_update_plain

    p, g, m, v = adamw_leaves(shapes, gen)
    if misalign:
        p, g, m, v = ([misaligned(x) for x in xs] for xs in (p, g, m, v))
    copies = [[x.clone() for x in xs] for xs in (p, m, v)]
    scale = torch.tensor(0.37, device="cuda")
    args = (scale, 3e-4, 0.9, 0.98, 1e-6, 0.01, 1.0 / (1.0 - 0.9 ** 3),
            1.0 / (1.0 - 0.98 ** 3))
    adamw_update(p, g, m, v, *args)
    torch.cuda.synchronize()
    adamw_update_plain(copies[0], g, copies[1], copies[2], *args)
    worst, tol = 0.0, 0.0
    for got, want in zip((p, m, v), copies):
        for a, b in zip(got, want):
            err, scale_ = max_err(a, b)
            worst, tol = max(worst, err), max(tol, TOL[torch.float32]
                                              * max(1.0, scale_))
    emit({"phase": phase, "kernel": "adamw",
          "leaves": len(shapes), "elements": sum(x.numel() for x in p),
          "misaligned": misalign, "max_abs_err": worst, "tol": tol})
    check(worst <= tol, f"adamw {len(shapes)} leaves: {worst} > {tol}")
    return worst


def model_shapes():
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    model = Wav2Vec2AcousticModel(base_config(4 + len(LETTERS)))
    return [tuple(p.shape) for p in model.parameters()]


def phase_train_kernels(gen) -> dict:
    """The training path's kernels at its shapes; returns f32 max errors."""
    worst = {"attention_bwd": check_attn_bwd(
        "kernel", TRAIN_ATTN_SHAPE, TRAIN_ATTN_LENGTHS, torch.float32, gen)}
    check_attn_bwd("kernel", TRAIN_ATTN_SHAPE, TRAIN_ATTN_LENGTHS,
                   torch.bfloat16, gen)
    worst["ctc_loss"] = check_ctc("kernel", CTC_SHAPE, CTC_INPUT_LENGTHS,
                                  CTC_TARGET_LENGTHS, gen)
    worst["adamw"] = check_adamw("kernel", model_shapes(), gen)
    b, h, t, dh = TRAIN_ATTN_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        errs = check_block("kernel", b, t, h * dh, h, TRAIN_ATTN_LENGTHS,
                           dtype, gen)
        if dtype == torch.float32:
            worst["attention_block"], worst["attention_block_bwd"] = errs
        torch.cuda.empty_cache()
    return worst


# (shape, input lengths, target lengths) of the CTC kernel's variants: T =
# 1 and 2 (a feasible row, an empty target, an infeasible and a padding
# row), odd and even T with input lengths far below T, the training
# shape with rows of 40 and 5 frames, and U at the state limit (2U + 1 =
# 2047, 1023 and 1000 labels); labels repeat (drawn from V - 4 values)
CTC_VARIANTS = [((4, 1, 6), [1, 1, 1, 0], [1, 0, 2, 1]),
                ((4, 2, 6), [2, 2, 2, 0], [1, 0, 3, 1]),
                ((4, 37, 9), [37, 36, 4, 0], [5, 3, 2, 1]),
                ((4, 64, 9), [64, 63, 3, 64], [7, 0, 1, 20]),
                ((4, 749, 32), [749, 40, 5, 0], [210, 10, 2, 0]),
                ((2, 1400, 32), [1400, 1333], [1023, 1000])]


def phase_train_variants(gen) -> None:
    """Small ragged shapes: every head dim of the attention backward in
    both semantics (bf16 wgmma, f32 SIMT; misaligned inputs copied),
    CTC with an empty target, an infeasible row, a padding row and
    repeats, AdamW with odd sizes and misaligned leaves, and the attention
    block at every head dim, T = 37, 130 and 1024, with zero-length
    rows."""
    for dtype in (torch.float32, torch.bfloat16):
        for shape, lengths, skew in (((3, 2, 130, 16), [130, 43, 0], False),
                                     ((2, 2, 200, 128), [200, 66], False),
                                     ((3, 2, 65, 32), [1, 64, 65], False),
                                     ((3, 2, 130, 32), [130, 7, 0], True)):
            check_attn_bwd("variant", shape, lengths, dtype, gen, skew)
    check_ctc("variant", (5, 40, 7), [40, 33, 3, 0, 25], [6, 0, 6, 0, 3],
              gen)
    check_ctc("variant", (2, 1, 5), [1, 1], [1, 0], gen)
    for shape, lengths, labels in CTC_VARIANTS:
        check_ctc("variant", shape, lengths, labels, gen)
    check_adamw("variant", [(7,), (1,), (16385,), (3, 5, 2)], gen)
    check_adamw("variant", [(7,), (1000,)], gen, misalign=True)
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, d, h, lengths in BLOCK_VARIANTS:
            check_block("variant", b, t, d, h, lengths, dtype, gen)


def conv_bwd_inputs(b, t_in, c_in, c_out, dtype, gen, skew=False):
    t_out = (t_in - 3) // 2 + 1
    x = torch.randn(b, t_in, c_in, device="cuda", generator=gen)
    w = torch.randn(3, c_in, c_out, device="cuda", generator=gen)
    dy = torch.randn(b, t_out, c_out, device="cuda", generator=gen)
    x, w, dy = x.to(dtype), (w / np.sqrt(3 * c_in)).to(dtype), dy.to(dtype)
    if skew:
        x, w, dy = misaligned(x), misaligned(w), misaligned(dy)
    return x, w, dy


def check_conv_bwd(phase, b, t_in, c_in, c_out, dtype, gen,
                   skew: bool = False) -> dict:
    """dgrad and wgrad kernels vs their plain versions on one input; a
    second call of each must be bitwise equal to the first, and each must
    run the route its shape takes (:func:`check_dgrad_route`,
    :func:`check_wgrad_route`)."""
    from audio8_tpu_torch.ops.conv import (conv1d_k3s2_dgrad,
                                           conv1d_k3s2_dgrad_plain,
                                           conv1d_k3s2_wgrad,
                                           conv1d_k3s2_wgrad_plain)

    x, w, dy = conv_bwd_inputs(b, t_in, c_in, c_out, dtype, gen, skew)
    got = {"conv_k3s2_dgrad": conv1d_k3s2_dgrad(dy, w, t_in),
           "conv_k3s2_wgrad": conv1d_k3s2_wgrad(x, dy)}
    check(torch.equal(got["conv_k3s2_wgrad"], conv1d_k3s2_wgrad(x, dy)),
          f"conv_k3s2_wgrad {dtype} {(b, t_in, c_in, c_out)}: repeated "
          "calls differ")
    check(torch.equal(got["conv_k3s2_dgrad"], conv1d_k3s2_dgrad(dy, w, t_in)),
          f"conv_k3s2_dgrad {dtype} {(b, t_in, c_in, c_out)}: repeated "
          "calls differ")
    routes = {"conv_k3s2_wgrad": check_wgrad_route(
                  x, dy, lambda: conv1d_k3s2_wgrad(x, dy)),
              "conv_k3s2_dgrad": check_dgrad_route(
                  dy, w, lambda: conv1d_k3s2_dgrad(dy, w, t_in))}
    torch.cuda.synchronize()
    want = {"conv_k3s2_dgrad": conv1d_k3s2_dgrad_plain(dy, w, t_in),
            "conv_k3s2_wgrad": conv1d_k3s2_wgrad_plain(x, dy)}
    errs = {}
    rows = b * dy.shape[1]
    for name, g in got.items():
        err, scale = max_err(g, want[name])
        tol = (wgrad_tol(rows, scale, dtype) if name == "conv_k3s2_wgrad"
               else TOL[dtype] * max(1.0, scale))
        emit({"phase": phase, "kernel": name, "dtype": str(dtype),
              "shape": [b, t_in, c_in, c_out], "misaligned": skew,
              "max_abs_err": err, "tol": tol, "route": routes[name],
              "repeat_bitwise_equal": True})
        check(g.shape == want[name].shape and bool(torch.isfinite(g).all())
              and err <= tol,
              f"{name} {dtype} {(b, t_in, c_in, c_out)}: {err} > {tol}")
        errs[name] = err
    return errs


def check_dropout(phase, shape, dtype, gen, skew: bool = False) -> float:
    """Forward and backward (through autograd) of the dropout kernel vs
    the plain version: exactly equal."""
    from audio8_tpu_torch.ops.dropout import fused_dropout, hash_dropout

    x, dy = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
             for _ in range(2))
    if skew:
        x, dy = misaligned(x), misaligned(dy)
    xg = x.detach().requires_grad_()
    y = fused_dropout(xg, DROPOUT_RATE, DROPOUT_SEED)
    (dx,) = torch.autograd.grad(y, xg, dy)
    torch.cuda.synchronize()
    err_y, _ = max_err(y, hash_dropout(x, DROPOUT_RATE, DROPOUT_SEED))
    err_dx, _ = max_err(dx, hash_dropout(dy, DROPOUT_RATE, DROPOUT_SEED))
    kept = (y != 0).float().mean().item()
    emit({"phase": phase, "kernel": "dropout", "dtype": str(dtype),
          "shape": list(shape), "misaligned": skew, "rate": DROPOUT_RATE,
          "kept_share": kept, "max_abs_err": {"fwd": err_y, "bwd": err_dx},
          "tol": 0.0})
    check(err_y == 0.0 and err_dx == 0.0,
          f"dropout {shape} {dtype}: fwd {err_y} bwd {err_dx} != 0")
    return max(err_y, err_dx)


def phase_conv_bwd_kernels(gen) -> dict:
    """The conv backward and dropout kernels at the CTC trainer's shapes
    (the four k3s2 layers of (4, 15 s), unfrozen; the encoder's (4, 749,
    768) residual stream); returns the float32 max errors."""
    worst = {"conv_k3s2_dgrad": 0.0, "conv_k3s2_wgrad": 0.0, "dropout": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for t_in, c_in, c_out in TRAIN_CONV_SHAPES:
            errs = check_conv_bwd("kernel", 4, t_in, c_in, c_out, dtype, gen)
            if dtype == torch.float32:
                for k, e in errs.items():
                    worst[k] = max(worst[k], e)
            torch.cuda.empty_cache()
        err = check_dropout("kernel", DROPOUT_SHAPE, dtype, gen)
        if dtype == torch.float32:
            worst["dropout"] = err
    return worst


def phase_pretrain_variants(gen) -> None:
    """Odd and even T_in (dgrad's two tail paths), T_out below one tile,
    C_in != C_out (dgrad tiles straddling the dx[2t] | dx[2t+1] halves,
    and tiles wholly in the second half), misaligned pointers (the
    wrapper's aligned copy, with split wgrad), channel counts off the
    16-byte vectors (refused), and dropout at ragged sizes. The dgrad
    wgmma route (bf16, channels in multiples of 64) also at T_in 255
    (T_out + 1 = 128: the tail row is the M tile's last), 256 (even: the
    zero row dx[255]) and 41 (T_out below 64, where TMA fills the row t -
    1 = -1 and every row past T_out), 64 -> 192 and 192 -> 64 channels
    (128-wide N tiles, a ragged one), one batch row and a misaligned dy
    (the wrapper's copy)."""
    from audio8_tpu_torch.ops.conv import conv1d_k3s2_dgrad, conv1d_k3s2_wgrad

    for dtype in (torch.float32, torch.bfloat16):
        for b, t_in, c_in, c_out, skew in (
                (2, 261, 128, 64, False), (2, 260, 128, 64, False),
                (3, 9, 40, 72, False), (2, 10, 72, 40, False),
                (2, 101, 40, 72, False), (2, 2001, 40, 72, True),
                (2, 38, 16, 24, True), (2, 255, 64, 64, False),
                (2, 256, 64, 64, False), (3, 41, 64, 64, False),
                (2, 261, 64, 192, False), (2, 260, 192, 64, False),
                (1, 259, 128, 128, False), (2, 257, 128, 64, True)):
            check_conv_bwd("variant", b, t_in, c_in, c_out, dtype, gen, skew)
        x, w, dy = conv_bwd_inputs(2, 37, 6, 10, dtype, gen)
        for name, call in (("dgrad", lambda: conv1d_k3s2_dgrad(dy, w, 37)),
                           ("wgrad", lambda: conv1d_k3s2_wgrad(x, dy))):
            try:
                call()
            except ValueError:
                continue
            raise RuntimeError(f"check failed: conv_k3s2_{name} took 6 -> "
                               f"10 channels in {dtype}")
        for shape, skew in (((3, 37, 11), False), ((1, 5), False),
                            ((2, 749, 768), True), ((1031,), True)):
            check_dropout("variant", shape, dtype, gen, skew)


def pretrain_path_shapes(rows: int, samples: int):
    """(T_in, C_in, C_out) of each k3s2 layer of the pretraining model's
    extractor, and its output frame count, for a batch of ``rows`` x
    ``samples``."""
    from audio8_tpu_torch.config import PretrainConfig

    t, c_in, convs = samples, 1, []
    for c, k, s in PretrainConfig().conv_features:
        if (k, s) == (3, 2):  # the layers that run conv1d_k3s2
            convs.append((t, c_in, c))
        t, c_in = (t - k) // s + 1, c
    return convs, t


def phase_pretrain_path_kernels(batches, gen) -> dict:
    """dgrad, wgrad, dropout, the attention core backward and the
    attention block vs their plain versions at the shapes of the batches
    the pretraining run formed: every k3s2 layer's (B, T_in), the dropout
    inputs (B, frames, 768) of the encoder and (B, frames, 512) of the
    extractor's features, the core's (B, 12, frames, 64) and the block's
    (B, frames, 768); returns the float32 max errors."""
    from audio8_tpu_torch.config import PretrainConfig

    cfg = PretrainConfig()
    worst = {"conv_k3s2_dgrad": 0.0, "conv_k3s2_wgrad": 0.0, "dropout": 0.0,
             "attention_bwd": 0.0, "attention_block": 0.0,
             "attention_block_bwd": 0.0}
    for rows, samples in batches:
        convs, frames = pretrain_path_shapes(rows, samples)
        emit({"phase": "pretrain_kernel", "batch": [rows, samples],
              "k3s2_t_in": [t for t, _, _ in convs], "frames": frames})
        for dtype in (torch.float32, torch.bfloat16):
            errs = {}
            for t_in, c_in, c_out in convs:
                for k, e in check_conv_bwd("pretrain_kernel", rows, t_in,
                                           c_in, c_out, dtype, gen).items():
                    errs[k] = max(errs.get(k, 0.0), e)
            for width in (cfg.d_model, cfg.fx_dim):
                errs["dropout"] = max(errs.get("dropout", 0.0), check_dropout(
                    "pretrain_kernel", (rows, frames, width), dtype, gen))
            errs["attention_bwd"] = check_attn_bwd(
                "pretrain_kernel", (rows, cfg.num_heads, frames,
                                    cfg.d_model // cfg.num_heads), None,
                dtype, gen)
            errs["attention_block"], errs["attention_block_bwd"] = \
                check_block("pretrain_kernel", rows, frames, cfg.d_model,
                            cfg.num_heads, None, dtype, gen)
            if dtype == torch.float32:
                worst = {k: max(worst[k], e) for k, e in errs.items()}
            torch.cuda.empty_cache()
    return worst


def base_config(num_labels: int, **over):
    from audio8_tpu_torch.config import AcousticConfig

    return AcousticConfig(num_labels=num_labels, timestep_masking=0.0,
                          channel_masking=0.0, **over)


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


SERVE_SECONDS = [3.1, 12.4, 31.0, 65.3]  # the served requests' lengths


@contextlib.contextmanager
def serving(tmp: str, *flags: str):
    """The ``a8t-serve`` path (parse_args -> build_service -> make_server)
    on 127.0.0.1 over tmp's ``ctc.pt`` and ``dict.ltr.txt`` with the
    chunking defaults and ``flags``: yields the service and its port,
    and stops the server and the batcher after."""
    from audio8_tpu_torch.cli.serve import build_service, make_server, parse_args

    args = parse_args(["--checkpoint", os.path.join(tmp, "ctc.pt"),
                       "--dict_file", os.path.join(tmp, "dict.ltr.txt"),
                       "--host", "127.0.0.1", "--port", "0",
                       "--batch", str(CHUNK_BATCH), *flags])
    service = build_service(args)
    srv = make_server(service, args.host, args.port)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    try:
        yield service, srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        service.transcriber.batcher.close()
        server.join(timeout=10)


def serve_bodies(seed: int) -> list:
    """The served requests: WAV bytes of SERVE_SECONDS, from the seed."""
    rng = np.random.default_rng(seed + 1)
    return [wav_bytes(synthetic_speechlike(s, rng)) for s in SERVE_SECONDS]


def phase_serve(cpu_model, seed: int, tmp: str) -> tuple:
    """The serving entry point end to end; returns the launch counts of
    the requests' run and the served texts."""
    from audio8_tpu_torch.models.convert import save_fairseq_ctc

    save_fairseq_ctc(cpu_model, os.path.join(tmp, "ctc.pt"))
    with open(os.path.join(tmp, "dict.ltr.txt"), "w") as fh:
        fh.writelines(f"{c} {1000 - i}\n" for i, c in enumerate(LETTERS))
    seconds = SERVE_SECONDS
    bodies = serve_bodies(seed)
    results = [None] * len(bodies)

    def send(i):
        t0 = time.perf_counter()
        results[i] = post(port, "/transcribe", bodies[i]) + (
            time.perf_counter() - t0,)

    with serving(tmp) as (service, port):
        batcher = service.transcriber.batcher
        dispatches0 = batcher.dispatches
        reset_launches()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=send, args=(i,))
                   for i in range(len(bodies))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in read_launches().items()
                    if k in ("conv_k3s2_fwd", "attention_fwd")}
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
        from audio8_tpu_torch.data.audio import read_wav
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
    return launches, [r[1]["text"] for r in results]


def edit_distance(a: str, b: str) -> int:
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1,
                                       prev + (ca != cb))
    return row[-1]


def phase_serve_bf16(seed: int, tmp: str, f32_texts: list) -> None:
    """The serving entry point again with ``--bf16`` (the serve phase's
    checkpoint, dict and requests, the (4, 30 s) chunking defaults),
    traced by torch.profiler: the conv forward's launches must be four per
    dispatch, every one on the route its shape takes (wgmma at the
    extractor's 512 channels), read from the traced kernel names. The
    transcripts' agreement with the f32 ones is reported, not checked:
    bf16 rounds other values."""
    from audio8_tpu_torch.ops.conv import conv1d_k3s2, fwd_route

    bodies = serve_bodies(seed)
    results = [None] * len(bodies)

    def send(i):
        results[i] = post(port, "/transcribe", bodies[i])

    def run():
        """The requests under the profiler: (wall s, conv forward
        launches, dispatches, traced conv forward kernels by route)."""
        batcher = service.transcriber.batcher
        dispatches0 = batcher.dispatches
        reset_launches()
        t0 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            clients = [threading.Thread(target=send, args=(i,))
                       for i in range(len(bodies))]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        routes = {}
        for e in prof.events():
            route = conv_fwd_route_of(e.name)
            if e.device_type == torch.autograd.DeviceType.CUDA and route:
                routes[route] = routes.get(route, 0) + 1
        return (wall, conv1d_k3s2.launches,
                batcher.dispatches - dispatches0, routes)

    with serving(tmp, "--bf16") as (service, port):
        want = fwd_route(torch.bfloat16, *CONV_SHAPES[0][1:])
        # every run is shown and checked; a trace short of kernels (the
        # profiler now and then returns empty ones) is taken again, up to
        # three runs in all
        for attempt in range(3):
            wall, launches, dispatches, routes = run()
            for s_, res in zip(SERVE_SECONDS, results):
                check(res is not None and res[0] == 200
                      and isinstance(res[1].get("text"), str),
                      f"bf16 request of {s_} s: {res}")
            texts = [r[1]["text"] for r in results]
            cer = [edit_distance(a, b) / max(1, len(a))
                   for a, b in zip(f32_texts, texts)]
            emit({"phase": "serve_bf16", "attempt": attempt,
                  "requests_s": SERVE_SECONDS, "wall_s": wall,
                  "audio_s_per_s": sum(SERVE_SECONDS) / wall,
                  "dispatches": dispatches,
                  "conv_k3s2_fwd_launches": launches,
                  "conv_k3s2_fwd_routes_traced": routes,
                  "texts_equal_f32": [a == b
                                      for a, b in zip(f32_texts, texts)],
                  "char_diff_vs_f32": cer,
                  "texts_len": [len(t) for t in texts]})
            check(dispatches > 0 and launches == 4 * dispatches,
                  f"bf16 serving: {launches} conv forward launches in "
                  f"{dispatches} dispatches, want 4 per dispatch")
            if sum(routes.values()) >= launches:
                break
        check(routes == {want: launches},
              f"bf16 serving: conv forward kernels {routes}, want "
              f"{launches} on the {want} route")
    from audio8_tpu_torch.models.convert import load_fairseq_ctc
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    served = Wav2Vec2AcousticModel(base_config(4 + len(LETTERS)),
                                   torch.bfloat16)
    served.load_state_dict(load_fairseq_ctc(os.path.join(tmp, "ctc.pt")))
    layer = served.encoder.encoder.layers[0].cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = CHUNK_BATCH * ATTN_SHAPE[2]  # a dispatch's encoder rows
    check_dense_bf16("serve_bf16", "layers.0.fc1", layer.fc1, rows, gen)
    check_dense_bf16("serve_bf16", "layers.0.self_attn.q_proj",
                     layer.self_attn.q_proj, rows, gen)


def write_corpus(root: str, seed: int) -> None:
    """16 training and 4 validation WAVs of 4-15 s (noise under drifting
    tones) with random letter transcripts at about 14 letters per second,
    in the fairseq manifest layout, and the 32-label letter dict."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed + 2)
    with open(os.path.join(root, "dict.ltr.txt"), "w") as fh:
        fh.writelines(f"{c} {1000 - i}\n" for i, c in enumerate(LETTERS))
    for split, n in (("train", 16), ("valid", 4)):
        with open(os.path.join(root, f"{split}.tsv"), "w") as tf, \
                open(os.path.join(root, f"{split}.ltr"), "w") as lf:
            tf.write(root + "\n")
            for i in range(n):
                seconds = float(rng.uniform(4.0, 15.0))
                wav = synthetic_speechlike(seconds, rng)
                name = f"{split}{i}.wav"
                wavfile.write(os.path.join(root, name), SR,
                              (np.clip(wav, -1, 1) * 32767).astype(np.int16))
                tf.write(f"{name}\t{len(wav)}\n")
                letters = rng.choice(LETTERS[1:], size=int(14 * seconds))
                lf.write(" ".join(letters) + " |\n")


def counted() -> dict:
    """Kernel name -> the wrapper that counts its launches."""
    from audio8_tpu_torch.ops.adamw import adamw_update
    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_bwd)
    from audio8_tpu_torch.ops.attention_block import (attention_block,
                                                      attention_block_bwd)
    from audio8_tpu_torch.ops.conv import (conv1d_k3s2, conv1d_k3s2_dgrad,
                                           conv1d_k3s2_wgrad)
    from audio8_tpu_torch.ops.ctc import ctc_loss
    from audio8_tpu_torch.ops.dropout import fused_dropout

    return {"conv_k3s2_fwd": conv1d_k3s2, "conv_k3s2_dgrad": conv1d_k3s2_dgrad,
            "conv_k3s2_wgrad": conv1d_k3s2_wgrad,
            "attention_fwd": attention_core,
            "attention_bwd": attention_core_bwd, "ctc_loss": ctc_loss,
            "dropout": fused_dropout, "adamw": adamw_update,
            "attention_block": attention_block,
            "attention_block_bwd": attention_block_bwd}


def reset_launches() -> None:
    for fn in counted().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in counted().items()}


# the kernels each path runs (the CTC trainer's extractor is frozen by
# default, so its conv backward runs only in train_vs_cpu)
TRAIN_PATH = ("conv_k3s2_fwd", "attention_fwd", "attention_bwd", "ctc_loss",
              "dropout", "adamw")
PRETRAIN_PATH = ("conv_k3s2_fwd", "conv_k3s2_dgrad", "conv_k3s2_wgrad",
                 "attention_fwd", "attention_bwd", "dropout", "adamw")
BLOCK_PATH = ("conv_k3s2_fwd", "conv_k3s2_dgrad", "conv_k3s2_wgrad",
              "attention_block", "attention_block_bwd", "dropout", "adamw")
TRAIN_FLAGS = ["--target_tokens_per_batch", "700000", "--grad_accum", "2",
               "--train_steps", "6", "--unfreeze_enc_after_step", "2",
               "--warmup_steps", "2"]


def phase_train(tmp: str, seed: int) -> dict:
    """The CTC fine-tuning entry point at full width; returns the launch
    counts of its run."""
    from audio8_tpu_torch.cli.train import train
    from audio8_tpu_torch.models.convert import load_fairseq_ctc

    corpus = os.path.join(tmp, "corpus")
    os.makedirs(corpus)
    write_corpus(corpus, seed)
    basedir = os.path.join(tmp, "run")
    argv = ["--root_dir", corpus, "--train_dataset", "train.tsv",
            "--valid_dataset", "valid.tsv", "--basedir", basedir,
            "--device", "cuda", "--valid_steps", "2", *TRAIN_FLAGS]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(argv)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items() if k in TRAIN_PATH}
    log = state.log
    check(state.step == 6 and len(log) == 6, f"train took {state.step} steps")
    check([r["frozen"] for r in log] == [True] * 3 + [False] * 3,
          "freeze schedule")
    check(all(math.isfinite(r["loss"]) for r in log), "non-finite loss")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the training run")
    ckpt = os.path.join(basedir, "checkpoint-step-6.pt")
    keys = set(load_fairseq_ctc(ckpt))
    check(keys == set(state.model.state_dict()), "checkpoint keys")

    def rate(rows):
        return sum(r["audio_s"] for r in rows) / sum(r["seconds"]
                                                     for r in rows)

    emit({"phase": "train", "config": "wav2vec2-base d768 h12 L12 ff3072, "
          "32 labels, f32", "flags": TRAIN_FLAGS,
          "params": sum(p.numel() for p in state.params),
          "step_seconds": [r["seconds"] for r in log],
          "step_audio_s": [r["audio_s"] for r in log],
          "losses": [r["loss"] for r in log],
          # step 1 carries first-call set-up (cuBLAS handles, allocator)
          "audio_s_per_s_frozen": rate(log[1:3]),
          "audio_s_per_s_unfrozen": rate(log[3:]),
          "wall_s": wall, "launches": launches,
          "launches_per_step": {k: n / 6 for k, n in launches.items()},
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def phase_train_vs_cpu(seed: int, phase: str = "train_vs_cpu",
                       **over) -> None:
    """One unfrozen step, extractor included (``freeze_fx`` off: the conv
    backward kernels), on the card and on the CPU from the same weights
    (dropout and masking off): loss and gradient norm. ``over``: config
    fields of another model (phase ``lv60_vs_cpu``: the LV-60 layout at
    full width)."""
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_ctc_steps
    from audio8_tpu_torch.utils import Offsets

    Offsets.remap_fairseq_ctc()
    cfg = base_config(4 + len(LETTERS), dropout=0.0, freeze_fx=False, **over)
    cpu = Wav2Vec2AcousticModel(cfg, generator=torch.Generator().manual_seed(
        seed + 3))
    gpu = Wav2Vec2AcousticModel(cfg).cuda()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed + 3)
    lengths = np.array([48_000, 41_000])
    sig = np.zeros((2, 48_000), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = synthetic_speechlike(n / SR, rng)
    tl = np.array([42, 36])
    tok = np.full((2, 42), Offsets.PAD, np.int64)
    for i, n in enumerate(tl):
        tok[i, :n] = rng.integers(4, 4 + len(LETTERS), size=n)
    batch = {"signal": torch.from_numpy(sig),
             "signal_lengths": torch.from_numpy(lengths),
             "token_ids": torch.from_numpy(tok),
             "token_lengths": torch.from_numpy(tl)}
    out = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        dev = next(model.parameters()).device
        state = TrainState(model, create_optimizer(create_lrs(
            1e-4, 10, "constant", warmup_steps=0)))
        grad_fn, update_fn, _ = make_ctc_steps(model)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, grads, bsz, _ = grad_fn(b, torch.Generator(), freeze=False)
        _, gnorm = update_fn(state, grads, bsz)
        out[name] = (float(loss), float(gnorm))
    (l_g, n_g), (l_c, n_c) = out["cuda"], out["cpu"]
    l_rel, n_rel = abs(l_g - l_c) / abs(l_c), abs(n_g - n_c) / abs(n_c)
    emit({"phase": phase, "rows_s": (lengths / SR).tolist(),
          "config": over, "loss": [l_g, l_c], "gnorm": [n_g, n_c],
          "loss_rel_err": l_rel, "loss_rtol": TRAIN_LOSS_RTOL,
          "gnorm_rel_err": n_rel, "gnorm_rtol": TRAIN_GNORM_RTOL})
    check(l_rel <= TRAIN_LOSS_RTOL,
          f"{phase}: step loss card vs CPU {l_rel}")
    check(n_rel <= TRAIN_GNORM_RTOL,
          f"{phase}: step gnorm card vs CPU {n_rel}")


def write_pretrain_corpus(root: str, seed: int) -> None:
    """24 training and 4 validation WAVs of 4-15 s (noise under drifting
    tones) and their manifests."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed + 4)
    for split, n in (("train", 24), ("valid", 4)):
        with open(os.path.join(root, f"{split}.tsv"), "w") as tf:
            tf.write(root + "\n")
            for i in range(n):
                wav = synthetic_speechlike(float(rng.uniform(4.0, 15.0)), rng)
                name = f"{split}{i}.wav"
                wavfile.write(os.path.join(root, name), SR,
                              (np.clip(wav, -1, 1) * 32767).astype(np.int16))
                tf.write(f"{name}\t{len(wav)}\n")


PRETRAIN_FLAGS = ["--tokens_per_batch", "1400000", "--max_sample_len",
                  "325000", "--train_steps", "6", "--steps_per_checkpoint",
                  "3", "--warmup_steps", "2", "--num_train_workers", "4"]


def phase_pretrain(tmp: str, seed: int):
    """The pretraining entry point at full width; returns the launch
    counts of its run and the (rows, samples) of its batches."""
    from audio8_tpu_torch.cli import pretrain
    from audio8_tpu_torch.models.convert import load_fairseq_pretrained
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    corpus = os.path.join(tmp, "pretrain_corpus")
    os.makedirs(corpus)
    write_pretrain_corpus(corpus, seed)
    basedir = os.path.join(tmp, "pretrain_run")
    argv = ["--manifest_dir", corpus, "--basedir", basedir, "--device",
            "cuda", *PRETRAIN_FLAGS]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = pretrain.train(argv)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items()
                if k in PRETRAIN_PATH}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log = state.log
    check(state.step == 6 and len(log) == 6,
          f"pretrain took {state.step} steps")
    for key in ("loss", "code_perplexity", "accuracy", "grad_norm"):
        check(all(math.isfinite(r[key]) for r in log), f"non-finite {key}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the pretraining run")
    ckpts = sorted(f for f in os.listdir(basedir) if f.endswith(".pt"))
    check(ckpts == ["checkpoint-step-2.pt", "checkpoint-step-5.pt"],
          f"checkpoints {ckpts}")
    keys = set(load_fairseq_pretrained(os.path.join(basedir, ckpts[-1])))
    check(keys == set(state.model.state_dict()), "checkpoint keys")

    _, valid_set = pretrain._datasets(pretrain.parse_args(argv))
    _, eval_step = make_pretrain_steps(state.model)
    valid = pretrain.validate(eval_step, valid_set, 2,
                              torch.Generator().manual_seed(seed), state.step,
                              torch.device("cuda"), {})
    check(math.isfinite(valid["average_valid_loss"]), "non-finite valid loss")

    def rate(rows):
        return sum(r["audio_s"] for r in rows) / sum(r["seconds"]
                                                     for r in rows)

    batches = sorted({(r["rows"], r["samples"]) for r in log})
    emit({"phase": "pretrain", "config": "wav2vec2-base d768 h12 L12 ff3072, "
          "final_dim 256, 2x320 codewords, f32", "flags": PRETRAIN_FLAGS,
          "params": sum(p.numel() for p in state.params),
          "step_seconds": [r["seconds"] for r in log],
          "step_audio_s": [r["audio_s"] for r in log],
          "rows": [r["rows"] for r in log],
          "samples": [r["samples"] for r in log],
          "losses": [r["loss"] for r in log],
          "code_perplexity": [r["code_perplexity"] for r in log],
          "accuracy": [r["accuracy"] for r in log],
          "temperature": [r["temperature"] for r in log],
          # step 1 carries first-call set-up (cuBLAS handles, allocator)
          "audio_s_per_s": rate(log[1:]), "wall_s": wall,
          "valid_loss": valid["average_valid_loss"], "launches": launches,
          "launches_per_step": {k: n / 6 for k, n in launches.items()},
          "peak_memory_gb": peak})
    return launches, batches


PRETRAIN_BF16_STEPS = 2


def phase_pretrain_bf16(tmp: str) -> None:
    """The pretraining entry point again with ``--bf16`` (the pretrain
    phase's corpus and flags, 2 steps, no checkpoint), traced by
    torch.profiler: finite losses, four conv dgrad launches per step (one
    per k3s2 layer), every traced dgrad GEMM kernel on the route the
    extractor's 512 channels take (wgmma: two GEMM launches per dgrad, one
    per half of dx), read from the kernels' names."""
    from audio8_tpu_torch.cli import pretrain
    from audio8_tpu_torch.ops.conv import conv1d_k3s2_dgrad, dgrad_route

    flags = dict(zip(PRETRAIN_FLAGS[::2], PRETRAIN_FLAGS[1::2]))
    flags.update({"--train_steps": str(PRETRAIN_BF16_STEPS),
                  "--steps_per_checkpoint": "1000"})
    argv = ["--manifest_dir", os.path.join(tmp, "pretrain_corpus"),
            "--basedir", os.path.join(tmp, "pretrain_bf16_run"), "--device",
            "cuda", "--bf16", *(a for kv in flags.items() for a in kv)]
    reset_launches()
    t0 = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state = pretrain.train(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items()
                if k in PRETRAIN_PATH}
    routes = {}
    for e in prof.events():
        route = dgrad_route_of(e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and route:
            routes[route] = routes.get(route, 0) + 1
    log = state.log
    want = dgrad_route(torch.bfloat16, 512, 512)
    emit({"phase": "pretrain_bf16", "steps": len(log),
          "step_seconds": [r["seconds"] for r in log],
          "rows": [r["rows"] for r in log],
          "samples": [r["samples"] for r in log],
          "losses": [r["loss"] for r in log], "wall_s": wall,
          "launches": launches, "conv_k3s2_dgrad_kernels_traced": routes})
    check(state.step == PRETRAIN_BF16_STEPS and len(log) == state.step,
          f"bf16 pretrain took {state.step} steps")
    check(all(math.isfinite(r["loss"]) for r in log),
          "bf16 pretrain: non-finite loss")
    check(conv1d_k3s2_dgrad.launches == 4 * PRETRAIN_BF16_STEPS,
          f"bf16 pretrain: {conv1d_k3s2_dgrad.launches} conv dgrad launches "
          f"in {PRETRAIN_BF16_STEPS} steps, want 4 per step")
    check(set(routes) == {want},
          f"bf16 pretrain: conv dgrad kernels {routes}, want {want} only")
    frames = 222 * max(r["rows"] for r in log)  # the batches' encoder rows
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    check_dense_bf16("pretrain_bf16", "final_proj", state.model.final_proj,
                     frames, gen)
    check_dense_bf16("pretrain_bf16", "layers.0.fc2",
                     state.model.encoder.layers[0].fc2, frames, gen)


# a bf16 Dense rounds its product, then the bias sum, each to bf16: the
# card and the CPU may each land one bf16 ulp (2^-7 relative) apart per
# rounding, from the order of their f32 sums
DENSE_BF16_TOL = 2.0 ** -6


def check_dense_bf16(phase: str, name: str, dense, rows: int, gen) -> None:
    """A bf16 ``Dense`` of the path (its weights) on the card against the
    same module's plain order on the CPU: normal inputs of ``rows`` rows
    within ``DENSE_BF16_TOL`` of max(1, max|plain|); then small integer
    inputs and weights, whose f32 sums are exact in any order, bitwise
    equal to the CPU's two roundings and not to one rounding of product
    plus bias (``F.linear`` with the bias), which a card path that rounds
    once would give."""
    import copy

    from audio8_tpu_torch.nn.layers import Dense

    x = torch.randn(rows, dense.in_features, generator=gen, device="cuda")
    with torch.no_grad():
        got = dense(x).float().cpu()
        plain = copy.deepcopy(dense).cpu()(x.cpu()).float()
    err = (got - plain).abs().max().item()
    limit = DENSE_BF16_TOL * max(1.0, plain.abs().max().item())
    cpu_gen = torch.Generator().manual_seed(rows)
    ints = Dense(dense.in_features, dense.out_features, dtype=torch.bfloat16)
    with torch.no_grad():
        ints.weight.copy_(torch.randint(-15, 16, ints.weight.shape,
                                        generator=cpu_gen).float())
        ints.bias.copy_(torch.randn(ints.bias.shape, generator=cpu_gen) * 64)
        xi = torch.randint(-15, 16, (rows, dense.in_features),
                           generator=cpu_gen).float()
        want = ints(xi)
        once = torch.nn.functional.linear(xi.bfloat16(),
                                          ints.weight.bfloat16(),
                                          ints.bias.bfloat16())
        card = ints.cuda()(xi.cuda()).cpu()
    emit({"phase": phase, "check": "dense_bf16", "module": name,
          "shape": [rows, dense.in_features, dense.out_features],
          "max_abs_err": err, "tol": limit,
          "exact_sums_bitwise": torch.equal(card, want),
          "exact_sums_equal_one_rounding":
              (card == once).float().mean().item()})
    check(err <= limit, f"{phase}: bf16 {name} card vs CPU {err} > {limit}")
    check(torch.equal(card, want),
          f"{phase}: bf16 {name} with exact sums differs from the CPU's "
          "two roundings")
    check(not torch.equal(want, once),
          f"{phase}: bf16 {name}: the check cannot tell the orders apart")


def flac_bytes(pcm: np.ndarray, sr: int = SR, block: int = 4096) -> bytes:
    """16-bit PCM ((n,) or (n, channels)) as a FLAC stream of VERBATIM
    subframes: every field byte-aligned, the CRCs left zero (the port's
    decoder does not check them)."""
    pcm = np.asarray(pcm, np.int16)
    pcm = pcm[:, None] if pcm.ndim == 1 else pcm
    n, ch = pcm.shape
    info = (block.to_bytes(2, "big") * 2 + bytes(6)
            + ((sr << 44) | ((ch - 1) << 41) | (15 << 36) | n).to_bytes(
                8, "big") + bytes(16))
    out = [b"fLaC", bytes([0x80]) + len(info).to_bytes(3, "big"), info]
    for i, start in enumerate(range(0, n, block)):
        blk = pcm[start:start + block]
        if i >= 128:
            raise ValueError("one-byte frame numbers: at most 128 blocks")
        out.append(bytes([0xFF, 0xF8, 0x70, ((ch - 1) << 4) | 0x08, i])
                   + (len(blk) - 1).to_bytes(2, "big") + bytes(1))
        out += [bytes([0x02]) + blk[:, c].astype(">i2").tobytes()
                for c in range(ch)]
        out.append(bytes(2))
    return b"".join(out)


RESTART_WORDS = ["THE", "CAT", "SAT", "ON", "A", "MAT", "DOG", "RAN", "TO",
                 "HIM"]


def write_restart_corpus(root: str, seed: int) -> None:
    """8 training WAVs of 2-4 s and RESTART_VALID validation FLACs, the
    first of 3 s and the rest of 1.5-3 s, with transcripts of
    RESTART_WORDS, the 32-label letter dict, and a bigram ARPA over the
    words (``words.arpa``)."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed + 5)
    with open(os.path.join(root, "dict.ltr.txt"), "w") as fh:
        fh.writelines(f"{c} {1000 - i}\n" for i, c in enumerate(LETTERS))
    for split, n, (lo, hi) in (("train", 8, (2.0, 4.0)),
                               ("valid", RESTART_VALID, (1.5, 3.0))):
        with open(os.path.join(root, f"{split}.tsv"), "w") as tf, \
                open(os.path.join(root, f"{split}.ltr"), "w") as lf:
            tf.write(root + "\n")
            for i in range(n):
                seconds = (hi if split == "valid" and i == 0
                           else float(rng.uniform(lo, hi)))
                wav = synthetic_speechlike(seconds, rng)
                pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
                name = f"{split}{i}." + ("wav" if split == "train" else "flac")
                if split == "train":
                    wavfile.write(os.path.join(root, name), SR, pcm)
                else:
                    with open(os.path.join(root, name), "wb") as f:
                        f.write(flac_bytes(pcm))
                tf.write(f"{name}\t{len(pcm)}\n")
                words = rng.choice(RESTART_WORDS,
                                   size=max(1, int(len(pcm) / SR * 2)))
                lf.write(" ".join(" ".join(w) + " |" for w in words) + "\n")
    unigrams = "".join(f"-1.0\t{w}\t-0.3\n" for w in RESTART_WORDS)
    bigrams = "".join(f"-0.5\t{a} {b}\n" for a, b in zip(
        RESTART_WORDS, RESTART_WORDS[1:]))
    with open(os.path.join(root, "words.arpa"), "w") as f:
        f.write(f"\\data\\\nngram 1={len(RESTART_WORDS) + 1}\n"
                f"ngram 2={len(RESTART_WORDS) - 1}\n\n\\1-grams:\n"
                f"-2.0\t<unk>\n{unigrams}\n\\2-grams:\n{bigrams}\n"
                "\\end\\\n")


# cli.test's batches of the valid set: the 3 s file and the next six
# (7 rows of 48 000 samples fill the budget; snapped to 8, one padding
# row), then the last two
RESTART_VALID, RESTART_TEST_BATCH = 9, ["--target_tokens_per_batch",
                                        "336000"]
RESTART_FLAGS = ["--train_steps", "3", "--grad_accum", "1",
                 "--unfreeze_enc_after_step", "1", "--warmup_steps", "2",
                 "--target_tokens_per_batch", "320000", "--valid_steps", "1",
                 "--steps_per_checkpoint", "3", "--num_train_workers", "2"]


def phase_restart_test(tmp: str, seed: int) -> dict:
    """Pretrain -> fine-tune -> test at full width: ``cli.train
    --restart_from`` the pretrain phase's ``checkpoint-step-5.pt`` (its
    encoder warm-starts the CTC model; the head keeps its seeded init)
    for 3 steps on a corpus whose valid set is FLAC, then ``cli.test`` on
    the saved ``.pt``, greedy and ``--beam 8 --lm`` an ARPA. The first
    step's loss is held to a CPU model restarted from the same ``.pt`` on
    the same batch and the same generator (TRAIN_LOSS_RTOL). The greedy
    ``cli.test`` run's own outputs (``keep_outputs``: its batching, the
    padding row its snapped batch carries, its ``num_real`` slicing) are
    held to a CPU ``cli.test`` run on the same ``.pt`` and files under
    the serve phase's rule: per utterance, log-probs within MODEL_TOL and
    equal greedy transcripts unless a frame's top two log-probs on the
    CPU lie within twice the error. Returns the launch counts of the
    train and test runs and the wall seconds of its parts."""
    from audio8_tpu_torch.cli import test as test_cli
    from audio8_tpu_torch.cli import train as train_cli
    from audio8_tpu_torch.cli.common import resolve_restart
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                                   resume_path)
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)

    walls = {}
    t_phase = time.perf_counter()
    pretrained = os.path.join(tmp, "pretrain_run", "checkpoint-step-5.pt")
    corpus = os.path.join(tmp, "restart_corpus")
    os.makedirs(corpus)
    write_restart_corpus(corpus, seed)
    basedir = os.path.join(tmp, "restart_run")
    first = {}
    real = train_cli.make_ctc_steps

    def recording(model, **kw):
        """make_ctc_steps whose fused step keeps its first batch and
        loss."""
        grad_fn, update_fn, eval_fn = real(model, **kw)
        step = grad_fn.train_step

        def train_step(state, batch, generator, freeze=True):
            if not first:
                first["batch"] = {k: v.cpu() for k, v in batch.items()}
            out = step(state, batch, generator, freeze=freeze)
            if "loss" not in first:
                first["loss"] = float(out[1])
            return out

        grad_fn.train_step = train_step
        return grad_fn, update_fn, eval_fn

    argv = ["--root_dir", corpus, "--train_dataset", "train.tsv",
            "--valid_dataset", "valid.tsv", "--basedir", basedir,
            "--device", "cuda", "--restart_from", pretrained, *RESTART_FLAGS]
    walls["corpus"] = time.perf_counter() - t_phase
    reset_launches()
    train_cli.make_ctc_steps = recording
    try:
        t0 = time.perf_counter()
        state = train_cli.train(argv)
        walls["train"] = time.perf_counter() - t0
    finally:
        train_cli.make_ctc_steps = real
    ckpt, saved = find_latest_checkpoint(basedir)
    common = ["--checkpoint", ckpt, "--root_dir", corpus,
              "--valid_dataset", "valid.tsv", *RESTART_TEST_BATCH]
    t0 = time.perf_counter()
    greedy = test_cli.evaluate(common + ["--device", "cuda"],
                               keep_outputs=True)
    walls["test_greedy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    beam = test_cli.evaluate(common + ["--device", "cuda", "--beam", "8",
                                       "--lm",
                                       os.path.join(corpus, "words.arpa")])
    walls["test_beam"] = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items() if k in TRAIN_PATH}
    log = state.log
    check(state.step == 3 and [r["frozen"] for r in log]
          == [True, True, False], f"restart_test steps {log}")
    check(all(math.isfinite(r["loss"]) for r in log),
          "restart_test: non-finite loss")
    check(saved == 3 and os.path.exists(resume_path(ckpt)),
          f"restart_test: saved {ckpt}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by restart_test")
    check(greedy["utterances"] == beam["utterances"] == RESTART_VALID
          and greedy["step"] == 2 and beam["wer"] == greedy["wer"]
          and "werr_lm_8" in beam
          and all(math.isfinite(m[k]) for m in (greedy, beam)
                  for k in ("wer", "cer")),
          f"cli.test { {k: v for k, v in greedy.items() if k != 'outputs'} }"
          f" {beam}")

    # step 1 on the CPU: the trainer's seeded init, restarted from the .pt
    t0 = time.perf_counter()
    cpu = Wav2Vec2AcousticModel(state.model.config,
                                generator=torch.Generator().manual_seed(0))
    cpu_state = TrainState(cpu, create_optimizer(create_lrs(
        1e-4, 10, "constant", warmup_steps=0)))
    resolve_restart(pretrained, cpu_state, ctc=True)
    grad_fn, _, _ = real(cpu)
    loss_cpu = float(grad_fn(first["batch"],
                             torch.Generator().manual_seed(1234),
                             freeze=True)[0])
    loss_rel = abs(first["loss"] - loss_cpu) / abs(loss_cpu)
    del cpu, cpu_state, grad_fn
    walls["cpu_step1"] = time.perf_counter() - t0

    # cli.test's own greedy outputs on the card vs a CPU cli.test run
    t0 = time.perf_counter()
    on_cpu = test_cli.evaluate(common + ["--device", "cpu"],
                               keep_outputs=True)
    walls["cpu_test_greedy"] = time.perf_counter() - t0
    outs_g, outs_c = greedy["outputs"], on_cpu["outputs"]
    check([o["file"] for o in outs_g] == [o["file"] for o in outs_c]
          and len(outs_g) == RESTART_VALID
          and all(a["log_probs"].shape == b["log_probs"].shape
                  for a, b in zip(outs_g, outs_c)),
          "restart_test: cli.test's utterances or frames differ on the "
          "CPU")
    err, texts_equal = 0.0, []
    for a, b in zip(outs_g, outs_c):
        e = float(np.abs(a["log_probs"] - b["log_probs"]).max())
        err = max(err, e)
        top2 = np.sort(b["log_probs"], axis=-1)[:, -2:]
        near_tie = bool(((top2[:, 1] - top2[:, 0]) <= 2 * e).any())
        texts_equal.append(a["greedy"] == b["greedy"])
        check(a["greedy"] == b["greedy"] or near_tie,
              f"restart_test: cli.test's greedy transcript of {a['file']} "
              "differs from the CPU's with no near tie")
    if all(texts_equal):
        check(greedy["wer"] == on_cpu["wer"]
              and greedy["cer"] == on_cpu["cer"],
              "restart_test: equal transcripts, different metrics")
    walls["phase"] = time.perf_counter() - t_phase
    emit({"phase": "restart_test",
          "pretrained": os.path.relpath(pretrained, tmp),
          "flags": RESTART_FLAGS, "train_wall_s": walls["train"],
          "step_seconds": [r["seconds"] for r in log],
          "losses": [r["loss"] for r in log],
          "first_loss": [first["loss"], loss_cpu], "loss_rel_err": loss_rel,
          "loss_rtol": TRAIN_LOSS_RTOL, "checkpoint": os.path.basename(ckpt),
          "wer": greedy["wer"], "cer": greedy["cer"],
          "beam_wer": beam["werr_lm_8"], "cpu_wer": on_cpu["wer"],
          "cpu_cer": on_cpu["cer"], "test_batches": greedy["step"],
          "utterances": greedy["utterances"],
          "eval_audio_s": greedy["audio_seconds"],
          "eval_audio_s_per_s": greedy["audio_seconds"]
          / greedy["eval_seconds"],
          "beam_eval_seconds": beam["eval_seconds"],
          "beam_host_ms_per_utterance": 1e3 * beam["beam_seconds"]
          / beam["utterances"],
          "greedy_vs_cpu_max_abs_err": err, "tol": MODEL_TOL,
          "greedy_texts_equal_cpu": texts_equal,
          "greedy_texts_empty": sum(not o["greedy"] for o in outs_g),
          "wall_s": walls, "launches": launches})
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"restart_test: step 1 loss card vs CPU {loss_rel}")
    check(err <= MODEL_TOL, f"restart_test: log-probs vs CPU {err}")
    return launches


def phase_pretrain_vs_cpu(seed: int, samples: int, fused=None,
                          dropout: float = 0.0) -> None:
    """One full-width pretraining step on two rows of ``samples`` (the
    pretraining run's length; dropout off; masks, Gumbel noise and
    negatives from the same seeds) on the card and on the CPU from the
    same weights: loss, contrastive loss, accuracy, gradient norm, and
    the share of Gumbel codeword indices that agree. ``fused="block"``:
    the same step through the attention block (phase ``block_vs_cpu``);
    ``fused=True`` with ``dropout`` 0.1: the core in the TPU kernel's
    semantics with every dropout on, both sides drawing the same seeds
    (phase ``kernel_vs_cpu``)."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    cfg = PretrainConfig(dropout=dropout, dropout_input=dropout,
                         dropout_features=dropout, fused_attention=fused)
    cpu = Wav2Vec2Model(cfg, generator=torch.Generator().manual_seed(seed + 5))
    gpu = Wav2Vec2Model(cfg).cuda()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed + 5)
    sig = np.stack([synthetic_speechlike((samples + 1) / SR, rng)[:samples]
                    for _ in range(2)])
    seeds = PretrainSeeds(mask=11, gumbel=22, negatives=33)
    out = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        dev = next(model.parameters()).device
        state = TrainState(model, create_optimizer(create_lrs(
            2e-4, 10, "constant", warmup_steps=0), weight_decay=0.01))
        train_step, _ = make_pretrain_steps(model)
        codes, slots = [], []
        hooks = [model.quantizer.register_forward_hook(
                     lambda m, i, o: codes.append(o[2].cpu())),
                 model.register_forward_hook(
                     lambda m, i, o: slots.append(int(o[3].sum())))]
        reset_launches()
        _, metrics = train_step(state, torch.from_numpy(sig).to(dev), seeds,
                                torch.Generator())
        for h in hooks:
            h.remove()
        if name == "cuda":
            ran = read_launches()
            want = (("attention_block", "attention_block_bwd")
                    if fused == "block" else ("attention_fwd",
                                              "attention_bwd"))
            layers = cfg.num_layers
            check(all(ran[k] == layers for k in want)
                  and sum(ran[k] for k in ("attention_block", "attention_fwd"))
                  == layers, f"{fused} step on the card launched {ran}")
        out[name] = {k: float(metrics[k]) for k in (
            "loss", "contrastive_loss", "accuracy", "grad_norm")}
        out[name].update(codes=codes[0], slots=slots[0])
    g, c = out["cuda"], out["cpu"]
    rel = {k: abs(g[k] - c[k]) / abs(c[k])
           for k in ("loss", "contrastive_loss", "grad_norm")}
    same = int((g["codes"] == c["codes"]).sum())
    agree = same / c["codes"].numel()
    xe_rtol = (CONTRASTIVE_RTOL if same == c["codes"].numel()
               else PRETRAIN_LOSS_RTOL)
    # accuracy is (argmax hits) / (valid masked slots): one slot's flip
    acc_atol = 1.0 / max(1, c["slots"])
    acc_err = abs(g["accuracy"] - c["accuracy"])
    phase = {"block": "block_vs_cpu", True: "kernel_vs_cpu"}.get(
        fused, "pretrain_vs_cpu")
    emit({"phase": phase, "fused_attention": fused, "dropout": dropout,
          "rows": [2, samples],
          **{k: [g[k], c[k]] for k in ("loss", "contrastive_loss",
                                       "accuracy", "grad_norm")},
          "loss_rel_err": rel["loss"], "loss_rtol": PRETRAIN_LOSS_RTOL,
          "contrastive_rel_err": rel["contrastive_loss"],
          "contrastive_rtol": xe_rtol, "masked_slots": [g["slots"],
                                                        c["slots"]],
          "accuracy_abs_err": acc_err, "accuracy_atol": acc_atol,
          "gnorm_rel_err": rel["grad_norm"],
          "gnorm_rtol": PRETRAIN_GNORM_RTOL, "codewords": c["codes"].numel(),
          "attention_launches": {k: ran[k] for k in want},
          "codewords_equal": same, "codeword_agreement": agree,
          "codeword_agreement_min": CODE_AGREEMENT})
    check(g["slots"] == c["slots"], "masked slots differ card vs CPU")
    check(rel["loss"] <= PRETRAIN_LOSS_RTOL,
          f"pretrain loss card vs CPU {rel['loss']}")
    check(rel["contrastive_loss"] <= xe_rtol,
          f"pretrain contrastive loss card vs CPU {rel['contrastive_loss']}")
    check(acc_err <= acc_atol * (1 + 1e-6),
          f"pretrain accuracy card vs CPU {acc_err}")
    check(rel["grad_norm"] <= PRETRAIN_GNORM_RTOL,
          f"pretrain gnorm card vs CPU {rel['grad_norm']}")
    check(agree >= CODE_AGREEMENT, f"codeword agreement {agree}")


def phase_pretrain_block(batches, seed: int) -> dict:
    """Full-width pretraining steps (``make_pretrain_steps``, dropout and
    masking on, the JAX defaults) with ``fused_attention="block"`` at the
    shapes of the batches phase 7 formed, one step of each shape twice;
    then the block and the core in turns on the largest shape, from the
    same weights. Returns the block run's launch counts."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    rng = np.random.default_rng(seed + 6)
    signals = {(rows, n): torch.from_numpy(np.stack([
        synthetic_speechlike((n + 1) / SR, rng)[:n] for _ in range(rows)]))
        .cuda() for rows, n in batches}
    init = Wav2Vec2Model(PretrainConfig(), generator=torch.Generator()
                         .manual_seed(seed + 6)).state_dict()
    runs = {}
    for fused in ("block", None):
        model = Wav2Vec2Model(PretrainConfig(fused_attention=fused)).cuda()
        model.load_state_dict(init)
        state = TrainState(model, create_optimizer(create_lrs(
            2e-4, 100, "constant", warmup_steps=0), weight_decay=0.01))
        runs[fused] = (state, make_pretrain_steps(model)[0])
    gen = torch.Generator().manual_seed(seed + 6)

    def step(fused, shape):
        state, train_step = runs[fused]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = train_step(state, signals[shape], PretrainSeeds.draw(gen), gen)
        loss = float(m["loss"])  # synchronises
        return {"seconds": time.perf_counter() - t0, "rows": shape[0],
                "samples": shape[1], "loss": loss,
                "code_perplexity": float(m["code_perplexity"]),
                "accuracy": float(m["accuracy"])}

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    log = [step("block", shape) for shape in batches * 2]
    launches = {k: n for k, n in read_launches().items()
                if k in BLOCK_PATH + ("attention_fwd", "attention_bwd")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = len(log)
    layers = PretrainConfig().num_layers
    check(launches["attention_block"] == layers * n
          and launches["attention_block_bwd"] == layers * n,
          f"attention block launches {launches} over {n} steps")
    check(launches["attention_fwd"] == 0 and launches["attention_bwd"] == 0,
          f"the core ran under fused_attention='block': {launches}")
    for name in BLOCK_PATH:
        check(launches[name] > 0, f"{name} was not launched")
    for key in ("loss", "code_perplexity", "accuracy"):
        check(all(math.isfinite(r[key]) for r in log), f"non-finite {key}")
    largest = max(batches)
    turns = {"block": [], "core": []}
    for fused in ("block", None, None, "block"):
        turns["core" if fused is None else "block"] += [
            step(fused, largest)["seconds"] for _ in range(2)]

    def rate(rows):
        return sum(r["rows"] * r["samples"] for r in rows) / SR / sum(
            r["seconds"] for r in rows)

    audio_s = largest[0] * largest[1] / SR
    emit({"phase": "pretrain_block", "config": "wav2vec2-base d768 h12 L12 "
          "ff3072, final_dim 256, 2x320 codewords, f32, "
          "fused_attention='block'",
          "step_seconds": [r["seconds"] for r in log],
          "rows": [r["rows"] for r in log],
          "samples": [r["samples"] for r in log],
          "frames": [pretrain_path_shapes(r["rows"], r["samples"])[1]
                     for r in log],
          "losses": [r["loss"] for r in log],
          "code_perplexity": [r["code_perplexity"] for r in log],
          "accuracy": [r["accuracy"] for r in log],
          # step 1 carries first-call set-up
          "audio_s_per_s": rate(log[1:]), "launches": launches,
          "launches_per_step": {k: v / n for k, v in launches.items()},
          "peak_memory_gb": peak,
          "in_turns_shape": list(largest),
          "in_turns_block_s": turns["block"], "in_turns_core_s": turns["core"],
          "in_turns_audio_s_per_s": {
              k: audio_s * len(v) / sum(v) for k, v in turns.items()}})
    del runs, signals
    return launches


def phase_block_gate() -> None:
    """Eval forwards of the acoustic model under ``fused_attention=
    "block"``: a 15 s row (749 frames) passes the gate and launches the
    block in all 12 layers, a 30 s serving chunk (1499 frames) does not
    and launches the core, as the JAX gate (T <= 1024) decides."""
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    model = Wav2Vec2AcousticModel(base_config(
        4 + len(LETTERS), fused_attention="block")).cuda().eval()
    layers = model.config.num_layers
    seen = {}
    for seconds, frames, runs, idle in ((15, 749, "attention_block",
                                         "attention_fwd"),
                                        (30, 1499, "attention_fwd",
                                         "attention_block")):
        x = torch.zeros(1, seconds * SR, device="cuda")
        reset_launches()
        with torch.inference_mode():
            lp, _ = model(x, torch.tensor([seconds * SR], device="cuda"))
        torch.cuda.synchronize()
        n = read_launches()
        check(lp.shape[1] == frames and bool(torch.isfinite(lp).all()),
              f"block gate forward at {seconds} s")
        check(n[runs] == layers and n[idle] == 0,
              f"{seconds} s ({frames} frames) under 'block': {n}")
        seen[f"{seconds}s"] = {"frames": frames, runs: n[runs], idle: n[idle]}
    emit({"phase": "block_gate", **seen})


# --------------------------------------------------------- seq2seq, paired

# the kernels the seq2seq and paired paths run (the decoder's, the text
# tower's and the reductions' attention is a torch composition, which the
# JAX package leaves to XLA too; the extractor is frozen by default)
S2S_PATH = ("conv_k3s2_fwd", "attention_fwd", "attention_bwd", "dropout",
            "adamw")
SEQ2SEQ_FLAGS = ["--target_tokens_per_batch", "700000", "--grad_accum", "2",
                 "--train_steps", "6", "--unfreeze_enc_after_step", "3",
                 "--warmup_steps", "2", "--steps_per_checkpoint", "6",
                 "--valid_steps", "0", "--num_train_workers", "4"]
VALID_BEAM = 4
PAIRED_ROWS = 8
PAIRED_FLAGS = ["--train_steps", "6", "--unfreeze_audio_after_step", "3",
                "--unfreeze_text_after_step", "3", "--warmup_steps", "2",
                "--steps_per_checkpoint", "6", "--valid_steps", "0",
                "--num_train_workers", "4", "--target_type", "bpe"]
# card vs CPU decoding: equal tokens, unless the CPU's own scores of the
# two choices (a greedy step's two tokens, or two beams' whole normalised
# hypotheses) lie within TIE_MARGIN per scored token: each device's
# log-probs may be off by MODEL_TOL
TIE_MARGIN = 2 * MODEL_TOL
DECODE_LEN = 12  # tokens decoded in the card vs CPU comparison
# one bf16 step card vs CPU: the loss within the bound the CPU's bf16
# trajectories keep to JAX's (tests/test_torch_bf16.py), the gradient
# norm within TOL[bf16]
BF16_LOSS_RTOL = 5e-3


@contextlib.contextmanager
def per_call_launches(module, factory: str, records: list):
    """Replace ``module.<factory>`` (a step factory) so that every call of
    the ``grad_fn`` it makes appends ``(flags, launches in the call)``."""
    real = getattr(module, factory)

    def wrapped(*args, **kwargs):
        fns = real(*args, **kwargs)

        def grad_fn(batch, generator, **flags):
            before = read_launches()
            out = fns[0](batch, generator, **flags)
            after = read_launches()
            records.append((flags, {k: after[k] - before[k]
                                    for k in after}))
            return out

        return (grad_fn,) + tuple(fns[1:])

    setattr(module, factory, wrapped)
    try:
        yield
    finally:
        setattr(module, factory, real)


def check_path_launches(phase, launches, records, flag) -> dict:
    """Every path kernel ran; the attention backward (2b) ran in each
    micro-step whose ``flag`` (the encoder's freeze) was off and in none
    where it was on. Returns the 2b launches per micro-step."""
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the {phase} run")
    bwd = [(f[flag], d["attention_bwd"]) for f, d in records]
    check(all((n == 0) == frozen for frozen, n in bwd),
          f"{phase}: attention_bwd launches by freeze {bwd}")
    check(any(frozen for frozen, _ in bwd) and not all(
        frozen for frozen, _ in bwd), f"{phase}: freeze schedule {bwd}")
    return {"frozen": [n for frozen, n in bwd if frozen],
            "unfrozen": [n for frozen, n in bwd if not frozen]}


@contextlib.contextmanager
def recorded_path_calls(calls: dict):
    """While the block runs, every call of the conv forward, the attention
    core and the dropout wrapper that the model's layers make is noted
    in ``calls`` (no host read in the step: the key mask is kept as a
    tensor): ``conv`` (x shape, w shape), ``attention`` (q shape, key
    mask, rate, semantics, whether autograd records it, so its
    backward ran), ``dropout`` (x shape). The wrappers are the modules'
    own names for the port's functions, replaced for the block and
    restored after it."""
    import audio8_tpu_torch.nn.dropout as nn_dropout
    import audio8_tpu_torch.nn.layers as nn_layers
    import audio8_tpu_torch.nn.transformer as nn_transformer

    calls.update(conv=[], attention=[], dropout=[])
    real = (nn_layers.conv1d_k3s2, nn_transformer.attention_core,
            nn_dropout.fused_dropout)

    def conv(x, w):
        calls["conv"].append((tuple(x.shape), tuple(w.shape)))
        return real[0](x, w)

    def attention(q, k, v, key_valid, scale, rate, seed, **sem):
        grad = torch.is_grad_enabled() and q.requires_grad
        calls["attention"].append((tuple(q.shape), None if key_valid is None
                                   else key_valid.detach().clone(), rate,
                                   tuple(sorted(sem.items())), grad))
        return real[1](q, k, v, key_valid, scale, rate, seed, **sem)

    def dropout(x, rate, seed):
        calls["dropout"].append(tuple(x.shape))
        return real[2](x, rate, seed)

    nn_layers.conv1d_k3s2 = conv
    nn_transformer.attention_core = attention
    nn_dropout.fused_dropout = dropout
    try:
        yield calls
    finally:
        (nn_layers.conv1d_k3s2, nn_transformer.attention_core,
         nn_dropout.fused_dropout) = real


def path_shapes(calls: dict) -> dict:
    """The distinct shapes of :func:`recorded_path_calls`' notes: conv
    (x, w) pairs and dropout shapes as they came; attention by (q shape,
    semantics), with the key lengths of the first call of each (a
    batch's rows; ``None`` without a mask), the largest rate and whether
    any call ran its backward."""
    attn = {}
    for shape, kv, rate, sem, grad in calls["attention"]:
        if (shape, sem) not in attn:
            attn[shape, sem] = [None if kv is None else kv.sum(-1).tolist(),
                                rate, grad]
        a = attn[shape, sem]
        a[1], a[2] = max(a[1], rate), a[2] or grad
    return {"conv": sorted(set(calls["conv"])),
            "dropout": sorted(set(calls["dropout"])),
            "attention": [(shape, dict(sem), grad, lengths, rate)
                          for (shape, sem), (lengths, rate, grad)
                          in sorted(attn.items(), key=lambda kv: kv[0][0])]}


def check_conv_fwd(phase, x_shape, w_shape, dtype, gen) -> float:
    """The conv forward kernel vs its plain version on random inputs of a
    path's (B, T_in, C_in) and (3, C_in, C_out), on the route its shape
    takes; returns the max error."""
    from audio8_tpu_torch.ops.conv import conv1d_k3s2, conv1d_k3s2_plain

    x = torch.randn(x_shape, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(w_shape, device="cuda", generator=gen)
         / np.sqrt(3 * w_shape[1])).to(dtype)
    route = check_conv_fwd_route(x, w, lambda: conv1d_k3s2(x, w))
    y = conv1d_k3s2(x, w)
    torch.cuda.synchronize()
    err, scale = max_err(y, conv1d_k3s2_plain(x, w))
    tol = TOL[dtype] * max(1.0, scale)
    emit({"phase": phase, "kernel": "conv_k3s2_fwd", "dtype": str(dtype),
          "shape": [*x_shape, w_shape[2]], "route": route,
          "max_abs_err": err, "tol": tol})
    check(bool(torch.isfinite(y).all()) and err <= tol,
          f"conv_k3s2_fwd {dtype} {x_shape}: {err} > {tol}")
    return err


def check_attn_fwd(phase, shape, lengths, rate, sem, dtype, gen) -> float:
    """The attention core's forward kernel vs its plain version on random
    q, k, v of a path's shape, key lengths and semantics, at rate 0 and at
    the path's rate; returns the max error."""
    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_plain)

    b, h, t, dh = shape
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    kv = None if lengths is None else (
        torch.arange(t, device="cuda")[None, :]
        < torch.tensor(lengths, device="cuda")[:, None])
    worst = 0.0
    for r, seed in ((0.0, 0), (rate, 1234)) if rate > 0.0 else ((0.0, 0),):
        o = attention_core(q, k, v, kv, dh ** -0.5, r, seed, **sem)
        torch.cuda.synchronize()
        err, scale = max_err(o, attention_core_plain(q, k, v, kv, dh ** -0.5,
                                                     r, seed, **sem))
        tol = TOL[dtype] * max(1.0, scale)
        emit({"phase": phase, "kernel": "attention_fwd", "dtype": str(dtype),
              "shape": list(shape), "key_lengths": lengths, "rate": r,
              **sem, "max_abs_err": err, "tol": tol})
        check(bool(torch.isfinite(o).all()) and err <= tol,
              f"attention_fwd {shape} {dtype} rate {r}: {err} > {tol}")
        worst = max(worst, err)
    return worst


def phase_path_kernels(path: str, shapes: dict, params: list, gen) -> dict:
    """The kernels of a path vs their plain versions at the shapes its run
    gave them (:func:`path_shapes`), in float32 and bfloat16: the conv
    forward at each layer's input, the attention forward at each
    attention call's shape, key lengths and semantics, its backward where
    autograd recorded the call, the dropout at every input it took (the
    encoders' residual streams, the decoder's or the text tower's
    residuals and attention probabilities (B, H, T_q, T_k)), and AdamW
    over the run's parameter shapes; returns the float32 max errors."""
    phase = f"{path}_kernel"
    emit({"phase": phase, "conv_inputs": [list(x) for x, _ in shapes["conv"]],
          "attention": [[list(s), g, lens] for s, _, g, lens, _
                        in shapes["attention"]],
          "dropout_inputs": [list(d) for d in shapes["dropout"]],
          "adamw_leaves": len(params)})
    worst = {k: 0.0 for k in S2S_PATH}
    for dtype in (torch.float32, torch.bfloat16):
        errs = {k: 0.0 for k in S2S_PATH}
        for x_shape, w_shape in shapes["conv"]:
            errs["conv_k3s2_fwd"] = max(errs["conv_k3s2_fwd"], check_conv_fwd(
                phase, x_shape, w_shape, dtype, gen))
        for shape, sem, grad, lengths, rate in shapes["attention"]:
            errs["attention_fwd"] = max(errs["attention_fwd"], check_attn_fwd(
                phase, shape, lengths, rate, sem, dtype, gen))
            if grad:
                errs["attention_bwd"] = max(errs["attention_bwd"],
                                            check_attn_bwd(phase, shape,
                                                           lengths, dtype,
                                                           gen))
            torch.cuda.empty_cache()
        for shape in shapes["dropout"]:
            errs["dropout"] = max(errs["dropout"], check_dropout(
                phase, shape, dtype, gen))
        if dtype == torch.float32:
            errs["adamw"] = check_adamw(phase, params, gen)
            worst = errs
        torch.cuda.empty_cache()
    check(any(g for _, _, g, _, _ in shapes["attention"]),
          f"{path}: no attention call ran its backward")
    return worst


def to_cuda(batch: dict) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()
            if isinstance(v, np.ndarray)}


# the seconds the step timings may pause between profiler retries in all,
# apart from the kernel timings' RETRY_BUDGET_S, and what they have paused
STEP_RETRY_BUDGET_S = 30.0
STEP_RETRY_PAUSED = {"s": 0.0}


def traced_window(fn, calls: int = 2) -> dict | None:
    """``calls`` calls of ``fn`` in one torch.profiler window
    (:func:`cuda_profiled`), framed by spin kernels
    (``torch.cuda._sleep``): one launched on the stream before the first
    call, one after the last call has returned on the host. The window
    runs from the start of the last spin kernel before the calls (the
    warm-up's last if the trace lost the frame, a host round trip
    earlier) to the end of the one after them, on the device's clock.
    Returns the device ms per call (the time any of the calls' kernels
    ran: the union of their spans), their durations summed per call
    (above the device ms where kernels overlap: the steps' library calls
    run some on side streams), the window's ms per call and the idle
    share 1 - device / window, all from the one trace. The window holds
    the profiler's own cost per launch, which raises the share over an
    untraced step's. A trace without its frames is taken again, the
    pauses doubling from 0.25 s within STEP_RETRY_BUDGET_S for all step
    timings; ``None`` when it runs out."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(8):
        if attempt:
            pause = 0.25 * 2 ** (attempt - 1)
            if STEP_RETRY_PAUSED["s"] + pause > STEP_RETRY_BUDGET_S:
                break
            STEP_RETRY_PAUSED["s"] += pause
            count_retry()
            time.sleep(pause)
        with cuda_profiled() as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        spans = cuda_spans(prof, spins=True)
        frames = [i for i, (_, _, n) in enumerate(spans) if "spin" in n]
        if len(spans) < 3 or frames[-1:] != [len(spans) - 1] \
                or frames[:-1] != list(range(len(frames) - 1)) \
                or len(frames) < 2:
            continue
        spans = spans[frames[-2]:]
        window = (spans[-1][1] - spans[0][0]) / 1e3
        busy, end = 0.0, spans[0][1]
        for a, b, _ in spans[1:-1]:
            busy += max(0.0, b - max(a, end)) / 1e3
            end = max(end, b)
        summed = sum(b - a for a, b, _ in spans[1:-1]) / 1e3
        check(busy <= window, f"device time {busy} ms above its traced "
              f"window {window} ms")
        return {"device_ms": busy / calls, "kernel_sum_ms": summed / calls,
                "window_ms": window / calls,
                "idle_share": 1.0 - busy / window, "timed_by": "trace"}
    emit({"phase": "timing_note", "function": getattr(
        fn, "__qualname__", repr(fn)), "traced_window": None})
    return None


def step_timings(state, step_fn, flags_of: dict, n: int = 5) -> dict:
    """Per setting (``flags_of``: name -> step flags): the wall ms of
    ``n`` synchronised optimizer steps (``step_fn(state, flags)``) on one
    batch, untraced, and the device ms, window ms and idle share of two
    more in one trace (:func:`traced_window`; ``timed_by`` "none" and no
    device numbers when the profiler returned no usable trace)."""
    out = {}
    for name, flags in flags_of.items():
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(state, flags)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        traced = traced_window(lambda: step_fn(state, flags))
        out[name] = {"wall_ms": ms, **(traced or {
            "device_ms": None, "kernel_sum_ms": None, "window_ms": None,
            "idle_share": None, "timed_by": "none"})}
    return out


def phase_seq2seq(tmp: str, seed: int):
    """``cli.train_seq2seq`` at full width on a letter corpus, warm-started
    from the pretrain phase's ``checkpoint-step-5.pt``: 6 steps of 2
    micro-batches, the encoder frozen up to step 3; then one validation
    greedy and with a beam of VALID_BEAM (ms per utterance), and the f32
    and bf16 steps frozen and unfrozen timed on one batch with the
    device's idle share, and the decoder's share of the unfrozen f32
    step. Returns the launch counts and the trained weights."""
    from audio8_tpu_torch.cli import train_seq2seq as s2s
    from audio8_tpu_torch.ops.metrics import postproc_letters
    from audio8_tpu_torch.train.checkpoint import load_port_checkpoint
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import (make_seq2seq_steps,
                                              sequence_loss)
    from audio8_tpu_torch.utils import revlut

    corpus = os.path.join(tmp, "seq2seq_corpus")
    os.makedirs(corpus)
    write_corpus(corpus, seed + 10)
    basedir = os.path.join(tmp, "seq2seq_run")
    pretrained = os.path.join(tmp, "pretrain_run", "checkpoint-step-5.pt")
    argv = ["--root_dir", corpus, "--train_dataset", "train.tsv",
            "--valid_dataset", "valid.tsv", "--basedir", basedir,
            "--device", "cuda", "--restart_from", pretrained,
            *SEQ2SEQ_FLAGS]
    records, calls = [], {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with per_call_launches(s2s, "make_seq2seq_steps", records), \
            recorded_path_calls(calls):
        state = s2s.train(argv)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items() if k in S2S_PATH}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log = state.log
    check(state.step == 6 and len(log) == 6, f"seq2seq took {state.step}")
    check([r["frozen"] for r in log] == [True] * 4 + [False] * 2,
          "seq2seq freeze schedule")
    check(all(math.isfinite(r["loss"]) for r in log), "non-finite loss")
    bwd = check_path_launches("seq2seq", launches, records, "freeze")
    saved = load_port_checkpoint(os.path.join(basedir, "checkpoint-step-6.pt"),
                                 "seq2seq")
    check(saved is not None and set(saved) == set(state.model.state_dict()),
          "seq2seq checkpoint keys")
    check(len(state.valid) == 2, f"{len(state.valid)} validations")

    args = s2s.parse_args(argv)
    args.dict_file = args.dict_file.format(args.target_type)
    vocab, train_set, valid_set = s2s.datasets(args)
    weights = {k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()}
    _, _, decode_fn, eval_fn = make_seq2seq_steps(state.model)
    valid = {}
    for beam in (1, VALID_BEAM):
        vm = s2s.validate(decode_fn, eval_fn, valid_set, revlut(vocab), 0,
                          postproc_letters, torch.device("cuda"), beam=beam)
        check(all(math.isfinite(vm[k]) for k in ("average_valid_loss", "cer",
                                                 "wer")), f"valid {vm}")
        vm["ms_per_utterance"] = 1e3 * vm["decode_seconds"] / vm["utterances"]
        valid["greedy" if beam == 1 else f"beam{beam}"] = vm

    batch = to_cuda(next(iter(train_set)))
    gen = torch.Generator().manual_seed(seed)
    timings = {}
    for dt in (torch.float32, torch.bfloat16):
        model = s2s.build_model(args, len(vocab), dt).cuda()
        model.load_state_dict(weights)
        tstate = TrainState(model, create_optimizer(create_lrs(
            1e-5, 100, "constant", warmup_steps=0)))
        grad_fn, update_fn, _, _ = make_seq2seq_steps(model)

        def step(st, flags):
            out = grad_fn(batch, gen, **flags)
            update_fn(st, out[1], out[2])

        timings[str(dt).split(".")[1]] = step_timings(
            tstate, step, {"frozen": {"freeze": True},
                           "unfrozen": {"freeze": False}})
        if dt == torch.float32:
            with torch.no_grad():
                memory, pad = model.encoder(batch["signal"],
                                            batch["signal_lengths"])
            ids = batch["token_ids"]
            dst_len = torch.clamp(batch["token_lengths"] - 1, min=0)
            dst_mask = (torch.arange(ids.shape[1] - 1, device="cuda")[None]
                        < dst_len[:, None])

            def decoder_step():
                lp = model.decoder(memory, pad, ids[:, :-1], dst_mask, gen)
                sequence_loss(lp, ids[:, 1:]).backward()

            dec = traced_window(decoder_step)
            timings["decoder_fwd_bwd_device_ms"] = dec and dec["device_ms"]
        del model, tstate
        torch.cuda.empty_cache()
    f32 = timings["float32"]["unfrozen"]["device_ms"]
    dec = timings["decoder_fwd_bwd_device_ms"]
    timings["decoder_share_of_unfrozen_f32"] = dec and f32 and dec / f32

    emit({"phase": "seq2seq", "config": "wav2vec2-base encoder d768 h12 L12 "
          "ff3072 + decoder d768 h4 L2 ff3072 max_len 1200, "
          f"{len(vocab)} letters, f32", "flags": SEQ2SEQ_FLAGS,
          "params": sum(p.numel() for p in state.params),
          "step_seconds": [r["seconds"] for r in log],
          "step_audio_s": [r["audio_s"] for r in log],
          "losses": [r["loss"] for r in log],
          "frozen": [r["frozen"] for r in log], "wall_s": wall,
          "launches": launches,
          "launches_per_step": {k: n / 6 for k, n in launches.items()},
          "attention_bwd_per_micro_step": bwd,
          "trainer_valid": state.valid, "valid": valid,
          "timed_batch": list(batch["signal"].shape), "step_ms": timings,
          "peak_memory_gb": peak})
    path = (path_shapes(calls), [tuple(p.shape) for p in state.params])
    return launches, weights, (args, len(vocab)), path


def s2s_batch(seed: int, vocab_size: int) -> dict:
    """Two rows of 3.0 and 2.6 s with 40- and 34-letter targets between GO
    and EOS, PAD after."""
    from audio8_tpu_torch.utils import Offsets

    rng = np.random.default_rng(seed + 11)
    lengths = np.array([48_000, 41_000])
    sig = np.zeros((2, 48_000), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = synthetic_speechlike(n / SR, rng)
    tl = np.array([42, 36])
    tok = np.full((2, 42), Offsets.PAD, np.int64)
    for i, n in enumerate(tl):
        tok[i, 0], tok[i, n - 1] = Offsets.GO, Offsets.EOS
        tok[i, 1:n - 1] = rng.integers(4, vocab_size, size=n - 2)
    return {"signal": torch.from_numpy(sig),
            "signal_lengths": torch.from_numpy(lengths),
            "token_ids": torch.from_numpy(tok),
            "token_lengths": torch.from_numpy(tl)}


def hyp_score(model, batch: dict, row: int, toks) -> tuple:
    """The CPU model's teacher-forced score of one hypothesis as the beam
    search scores it: the sum of its log-probs up to its first EOS, over
    ((5 + emitted) / 6) ** 0.6; and the number of scored tokens."""
    from audio8_tpu_torch.utils import Offsets

    toks = [int(t) for t in toks]
    end = toks.index(Offsets.EOS) + 1 if Offsets.EOS in toks else len(toks)
    toks = toks[:end]
    dst = torch.tensor([[Offsets.GO] + toks[:-1]])
    with torch.no_grad():
        lp = model(batch["signal"][row:row + 1],
                   batch["signal_lengths"][row:row + 1], dst,
                   torch.tensor([len(toks)]))[0]
    total = float(sum(lp[i, t] for i, t in enumerate(toks)))
    emitted = sum(t not in (Offsets.PAD, Offsets.EOS) for t in toks)
    return total / ((5.0 + emitted) / 6.0) ** 0.6, len(toks)


def greedy_near_tie(model, batch, row, mine, theirs) -> float:
    """The CPU's log-prob margin at the first step where two greedy rows
    part: its own token over the other's, given the shared prefix."""
    from audio8_tpu_torch.utils import Offsets

    i = next(j for j, (a, b) in enumerate(zip(mine, theirs)) if a != b)
    dst = torch.tensor([[Offsets.GO] + [int(t) for t in mine[:i]]])
    with torch.no_grad():
        lp = model(batch["signal"][row:row + 1],
                   batch["signal_lengths"][row:row + 1], dst,
                   torch.tensor([i + 1]))[0, i]
    return float(lp[int(mine[i])] - lp[int(theirs[i])])


def compare_decodes(cpu_model, gpu_model, batch) -> dict:
    """Greedy and beam-VALID_BEAM tokens card vs CPU under the tie rule
    (TIE_MARGIN); returns the rows that differed and their margins."""
    gb = {k: v.cuda() for k, v in batch.items()}
    out = {}
    for beam in (1, VALID_BEAM):
        c, _ = cpu_model.decode_beam(batch["signal"], batch["signal_lengths"],
                                     beam, DECODE_LEN)
        g, _ = gpu_model.decode_beam(gb["signal"], gb["signal_lengths"],
                                     beam, DECODE_LEN)
        g = g.cpu()
        ties = []
        for row in range(c.shape[0]):
            if torch.equal(c[row], g[row]):
                continue
            if beam == 1:
                margin = greedy_near_tie(cpu_model, batch, row, c[row],
                                         g[row])
                limit = TIE_MARGIN
            else:
                (s_c, n_c), (s_g, n_g) = (hyp_score(cpu_model, batch, row, t)
                                          for t in (c[row], g[row]))
                margin, limit = s_c - s_g, TIE_MARGIN * max(n_c, n_g)
            ties.append({"row": row, "margin": margin, "limit": limit})
            check(abs(margin) <= limit,
                  f"beam {beam} row {row}: card and CPU tokens differ "
                  f"beyond a tie ({margin} > {limit})")
        out["greedy" if beam == 1 else f"beam{beam}"] = {
            "cpu": c.tolist(), "card": g.tolist(), "near_ties": ties}
    return out


def one_step(model, batch, make_steps, gen_seed: int, **flags):
    """One grad + AdamW step from ``model``'s weights (constant LR 2e-5,
    no warmup): returns the step's outputs and the gradient norm."""
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)

    dev = next(model.parameters()).device
    state = TrainState(model, create_optimizer(create_lrs(
        2e-5, 10, "constant", warmup_steps=0), weight_decay=0.01))
    fns = make_steps(model)
    b = {k: v.to(dev) for k, v in batch.items()}
    out = fns[0](b, torch.Generator().manual_seed(gen_seed), **flags)
    grads, rows = out[-3], out[-2]
    _, gnorm = fns[1](state, grads, rows)
    return out, float(gnorm)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_seq2seq_vs_cpu(weights: dict, built, seed: int) -> None:
    """The seq2seq phase's trained weights on the card and on the CPU: one
    unfrozen step (dropout and masks on, the same seeds on both sides) on
    two rows of 3.0 and 2.6 s: loss within TRAIN_LOSS_RTOL, gradient norm
    within TRAIN_GNORM_RTOL; greedy and beam-VALID_BEAM tokens under the
    tie rule; then one bf16 step each (BF16_LOSS_RTOL, TOL[bf16])."""
    from audio8_tpu_torch.cli import train_seq2seq as s2s
    from audio8_tpu_torch.train.steps import make_seq2seq_steps

    args, vocab_size = built
    batch = s2s_batch(seed, vocab_size)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        res = {}
        for dev in ("cuda", "cpu"):
            model = s2s.build_model(args, vocab_size, dt)
            model.load_state_dict(weights)
            model = model.to(dev)
            (loss, _, _, _), gnorm = one_step(model, batch,
                                              make_seq2seq_steps, seed + 12,
                                              freeze=False)
            res[dev] = (float(loss), gnorm, model)
        (l_g, n_g, gpu), (l_c, n_c, cpu) = res["cuda"], res["cpu"]
        name = str(dt).split(".")[1]
        lt, nt = ((TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL) if dt == torch.float32
                  else (BF16_LOSS_RTOL, TOL[torch.bfloat16]))
        out[name] = {"loss": [l_g, l_c], "gnorm": [n_g, n_c],
                     "loss_rel_err": rel(l_g, l_c), "loss_rtol": lt,
                     "gnorm_rel_err": rel(n_g, n_c), "gnorm_rtol": nt}
        check(rel(l_g, l_c) <= lt, f"seq2seq {name} step loss card vs CPU")
        check(rel(n_g, n_c) <= nt, f"seq2seq {name} step gnorm card vs CPU")
        if dt == torch.float32:  # the stepped weights, both sides
            out["decode"] = compare_decodes(cpu, gpu, batch)
        del res
        torch.cuda.empty_cache()
    emit({"phase": "seq2seq_vs_cpu", "rows_s": [3.0, 41_000 / SR],
          "tie_margin_per_token": TIE_MARGIN, **out})


PAIRED_WORDS = 20_000  # distinct words of the paired corpus' text
PAIRED_BPE_TOKENS = 300_000  # words of the text the BPE codes learn on


def write_paired_corpus(root: str, seed: int) -> int:
    """16 training and 4 validation WAVs of 4-15 s with word transcripts
    (``.wrd``, about 2.5 words a second), the words drawn by Zipf's law
    from PAIRED_WORDS distinct ones (:func:`zipf_words`); then BPE codes
    learned by ``cli.learn_bpe`` at its default 10 000 merges on the
    train transcripts and a text of PAIRED_BPE_TOKENS words drawn the
    same way (a subword vocabulary of a real corpus' size), and the
    ``.bpe`` transcripts and ``dict.bpe.txt`` of ``cli.wrd2bpe``.
    Returns the longest training row's samples."""
    from scipy.io import wavfile

    from audio8_tpu_torch.cli import learn_bpe, wrd2bpe

    rng = np.random.default_rng(seed + 13)
    words, p = zipf_words(rng, PAIRED_WORDS)
    longest = 0
    for split, n in (("train", 16), ("valid", 4)):
        with open(os.path.join(root, f"{split}.tsv"), "w") as tf, \
                open(os.path.join(root, f"{split}.wrd"), "w") as wf:
            tf.write(root + "\n")
            for i in range(n):
                seconds = float(rng.uniform(4.0, 15.0))
                wav = synthetic_speechlike(seconds, rng)
                name = f"{split}{i}.wav"
                wavfile.write(os.path.join(root, name), SR,
                              (np.clip(wav, -1, 1) * 32767).astype(np.int16))
                tf.write(f"{name}\t{len(wav)}\n")
                if split == "train":
                    longest = max(longest, len(wav))
                ids = rng.choice(len(words), size=int(2.5 * seconds), p=p)
                wf.write(" ".join(words[j] for j in ids) + "\n")
    text = os.path.join(root, "bpe_text.wrd")
    with open(text, "w") as f:
        ids = rng.choice(len(words), size=PAIRED_BPE_TOKENS, p=p)
        for line in np.array_split(ids, PAIRED_BPE_TOKENS // 25):
            f.write(" ".join(words[j] for j in line) + "\n")
    learn_bpe.main(["--input", os.path.join(root, "train.wrd"), text,
                    "--output", os.path.join(root, "codes.bpe"),
                    "--write_vocab", os.path.join(root, "vocab.bpe")])
    wrd2bpe.main(["--root_dir", root, "--train_dataset", "train.tsv",
                  "--valid_dataset", "valid.tsv", "--subword_model_file",
                  os.path.join(root, "codes.bpe"), "--subword_vocab_file",
                  os.path.join(root, "vocab.bpe")])
    return longest


def phase_paired(tmp: str, seed: int):
    """``cli.pretrain_paired`` at full width (the wav2vec2-base audio
    tower; the text tower 512 wide, 8 heads, 8 layers, 2048, rpr_k 8; max
    reductions, output_dim 256) on BPE targets learned by
    ``cli.learn_bpe``: 6 steps of PAIRED_ROWS rows, both towers frozen up
    to step 3, then a validation; the f32 and bf16 steps frozen and
    unfrozen timed on one batch with the device's idle share. Returns the
    launch counts and the trained weights."""
    from audio8_tpu_torch.cli import pretrain_paired as pp
    from audio8_tpu_torch.train.checkpoint import load_port_checkpoint
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_paired_steps

    corpus = os.path.join(tmp, "paired_corpus")
    os.makedirs(corpus)
    longest = write_paired_corpus(corpus, seed)
    basedir = os.path.join(tmp, "paired_run")
    flags = PAIRED_FLAGS + [
        "--target_tokens_per_batch", str(PAIRED_ROWS * longest),
        "--subword_model_file", os.path.join(corpus, "codes.bpe"),
        "--subword_vocab_file", os.path.join(corpus, "vocab.bpe")]
    argv = ["--root_dir", corpus, "--train_dataset", "train.tsv",
            "--valid_dataset", "valid.tsv", "--basedir", basedir,
            "--device", "cuda", *flags]
    records, calls = [], {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with per_call_launches(pp, "make_paired_steps", records), \
            recorded_path_calls(calls):
        state = pp.train(argv)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items() if k in S2S_PATH}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log = state.log
    check(state.step == 6 and len(log) == 6, f"paired took {state.step}")
    check([r["freeze_audio"] for r in log] == [True] * 4 + [False] * 2
          and [r["freeze_text"] for r in log] == [True] * 4 + [False] * 2,
          "paired freeze schedule")
    check(all(r["rows"] == PAIRED_ROWS for r in log),
          f"paired rows {[r['rows'] for r in log]}")
    for key in ("loss", "clip_accuracy", "logit_scale"):
        check(all(math.isfinite(r[key]) for r in log), f"non-finite {key}")
    bwd = check_path_launches("paired", launches, records, "freeze_audio")
    saved = load_port_checkpoint(os.path.join(basedir, "checkpoint-step-6.pt"),
                                 "paired")
    check(saved is not None and "loss.logit_scale" in saved,
          "paired checkpoint keys")
    check(len(state.valid) == 2 and all(math.isfinite(
        v["average_valid_loss"]) for v in state.valid), "paired validation")

    args = pp.parse_args(argv)
    args.dict_file = args.dict_file.format(args.target_type)
    vocab, train_set, _ = pp.datasets(args)
    weights = {k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()}
    batch = to_cuda(next(iter(train_set)))
    gen = torch.Generator().manual_seed(seed)
    timings = {}
    for dt in (torch.float32, torch.bfloat16):
        module = pp.build_module(args, len(vocab), dt).cuda()
        module.load_state_dict(weights)
        tstate = TrainState(module, create_optimizer(create_lrs(
            1e-5, 100, "constant", warmup_steps=0), weight_decay=0.01))
        grad_fn, update_fn, _ = make_paired_steps(module)

        def step(st, flags):
            out = grad_fn(batch, gen, **flags)
            update_fn(st, out[2], out[3])

        timings[str(dt).split(".")[1]] = step_timings(tstate, step, {
            "frozen": {"freeze_audio": True, "freeze_text": True},
            "unfrozen": {"freeze_audio": False, "freeze_text": False}})
        del module, tstate
        torch.cuda.empty_cache()

    emit({"phase": "paired", "config": "audio wav2vec2-base d768 h12 L12 "
          "ff3072 max; text d512 h8 L8 ff2048 rpr_k 8 max; output_dim 256; "
          f"{len(vocab)} BPE pieces, f32", "flags": flags,
          "params": sum(p.numel() for p in state.params),
          "step_seconds": [r["seconds"] for r in log],
          "step_audio_s": [r["audio_s"] for r in log],
          "rows": [r["rows"] for r in log],
          "losses": [r["loss"] for r in log],
          "clip_accuracy": [r["clip_accuracy"] for r in log],
          "logit_scale": [r["logit_scale"] for r in log],
          "wall_s": wall, "launches": launches,
          "launches_per_step": {k: n / 6 for k, n in launches.items()},
          "attention_bwd_per_micro_step": bwd, "valid": state.valid,
          "timed_batch": list(batch["signal"].shape), "step_ms": timings,
          "peak_memory_gb": peak})
    path = (path_shapes(calls), [tuple(p.shape) for p in state.params])
    return launches, weights, (args, len(vocab)), path


def paired_batch(seed: int, vocab_size: int) -> dict:
    """Four rows of 3.0 to 1.9 s with 9 to 4 BPE ids (PAD after)."""
    from audio8_tpu_torch.utils import Offsets

    rng = np.random.default_rng(seed + 14)
    lengths = np.array([48_000, 41_000, 36_000, 30_000])
    sig = np.zeros((4, 48_000), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = synthetic_speechlike(n / SR, rng)
    tl = np.array([9, 7, 6, 4])
    tok = np.full((4, 9), Offsets.PAD, np.int64)
    for i, n in enumerate(tl):
        tok[i, :n] = rng.integers(4, vocab_size, size=n)
    return {"signal": torch.from_numpy(sig),
            "signal_lengths": torch.from_numpy(lengths),
            "token_ids": torch.from_numpy(tok),
            "token_lengths": torch.from_numpy(tl)}


def phase_paired_vs_cpu(weights: dict, built, seed: int) -> None:
    """The paired phase's trained weights on the card and on the CPU: one
    step with both towers unfrozen (dropout and masks on, the same seeds)
    on four rows: loss within TRAIN_LOSS_RTOL, gradient norm within
    TRAIN_GNORM_RTOL, ``logit_scale`` after the step within 1e-6, and
    ``clip_accuracy`` equal unless rows whose best two logits on the CPU
    lie within TIE_MARGIN account for the difference; then one bf16 step
    each, the loss within BF16_LOSS_RTOL and the gradient norm within
    TOL[bf16] (2^-5). In bf16 the max reductions' winners may change at
    1-ulp differences; full runs on an H100 80GB HBM3 at 700 W read the
    bf16 gradient norms 0.21% to 0.97% apart (five, a 14-piece
    vocabulary) and 0.22% to 1.27% (three, 6 747 pieces), so the bound
    keeps a factor of 2.5 over the worst."""
    from audio8_tpu_torch.cli import pretrain_paired as pp
    from audio8_tpu_torch.train.steps import make_paired_steps

    args, vocab_size = built
    batch = paired_batch(seed, vocab_size)
    flags = dict(freeze_audio=False, freeze_text=False)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        res = {}
        for dev in ("cuda", "cpu"):
            module = pp.build_module(args, vocab_size, dt)
            module.load_state_dict(weights)
            module = module.to(dev)
            near_ties = None
            if dev == "cpu" and dt == torch.float32:
                # the step's own forward: the same seeds in the same order
                with torch.no_grad():
                    a, t = module.model(
                        *batch.values(),
                        generator=torch.Generator().manual_seed(seed + 15),
                        **flags)
                a = a.float() / a.float().norm(dim=-1, keepdim=True)
                t = t.float() / t.float().norm(dim=-1, keepdim=True)
                logits = torch.exp(module.loss.logit_scale) * (a @ t.t())
                top2 = logits.topk(2, dim=-1).values
                near_ties = int((top2[:, 0] - top2[:, 1] <= TIE_MARGIN).sum())
            (loss, metrics, _, _, _), gnorm = one_step(
                module, batch, make_paired_steps, seed + 15, **flags)
            res[dev] = {"loss": float(loss), "gnorm": gnorm,
                        "acc": float(metrics["clip_accuracy"]),
                        "scale": float(module.loss.logit_scale.detach()),
                        "near_ties": near_ties}
        g, c = res["cuda"], res["cpu"]
        name = str(dt).split(".")[1]
        lt, nt = ((TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL) if dt == torch.float32
                  else (BF16_LOSS_RTOL, TOL[torch.bfloat16]))
        out[name] = {"card": g, "cpu": c, "loss_rel_err":
                     rel(g["loss"], c["loss"]), "loss_rtol": lt,
                     "gnorm_rel_err": rel(g["gnorm"], c["gnorm"]),
                     "gnorm_rtol": nt}
        check(rel(g["loss"], c["loss"]) <= lt,
              f"paired {name} step loss card vs CPU")
        check(rel(g["gnorm"], c["gnorm"]) <= nt,
              f"paired {name} step gnorm card vs CPU")
        if dt == torch.float32:
            check(abs(g["scale"] - c["scale"]) <= 1e-6,
                  "paired logit_scale after one step card vs CPU")
            check(abs(g["acc"] - c["acc"]) * 4 <= c["near_ties"],
                  "paired clip_accuracy card vs CPU")
        torch.cuda.empty_cache()
    emit({"phase": "paired_vs_cpu", "rows_s": [3.0, 2.5625, 2.25, 1.875],
          **out})


# ---------------------------------------------------------------------------
# The serving and inference surface (slice 12): beam+LM with timestamps,
# /stream, /metrics, int8, cli.transcribe --vad, cli.embed. Each phase
# reads kernels 2 and 3's launches over its own run (counts set to 0 just
# before it) and notes the shapes its layers gave them in INFER_CALLS,
# which ``inference_kernel`` checks against the plain versions.

INFER_PATH = ("conv_k3s2_fwd", "attention_fwd")
INFER_PHASES = ("serve_decode", "stream", "serve_int8", "transcribe_vad",
                "embed")
INFER_CALLS: dict = {"conv": [], "attention": [], "dropout": []}
SERVE_BEAM = 8
STREAM_BLOCK_S = 0.5  # /stream request body blocks, s16 PCM
# transcribe_vad: two files of bursts between near-silences
VAD_BURSTS = ((0.6, 1.7), (0.4, 2.9))  # (silence s, burst s) ranges
EMBED_FILES, EMBED_BATCH = 16, 8
EMBED_COS_TOL = 1e-4  # cosine to the CPU's vector >= 1 - this; norms too


@contextlib.contextmanager
def inference_path(phase: str, launches: dict):
    """Kernels 2 and 3's launches over the block into ``launches[phase]``
    (each must be launched), the layers' calls into INFER_CALLS."""
    calls: dict = {}
    reset_launches()
    with recorded_path_calls(calls):
        yield
    got = read_launches()
    launches[phase] = {k: got[k] for k in INFER_PATH}
    for key in INFER_CALLS:
        INFER_CALLS[key] += calls[key]
    for name, n in launches[phase].items():
        check(n > 0, f"{name} was not launched by the {phase} run")


def write_serve_lm(path: str, seed: int) -> int:
    """A trigram ARPA that ``ops/ngram.py`` (interpolated modified
    Kneser-Ney) estimates from 6 000 Zipf-drawn sentences over 2 000
    words of the serve dict's letters; returns its n-gram count."""
    from audio8_tpu_torch.ops.ngram import train_kneser_ney

    rng = np.random.default_rng(seed + 7)
    letters = [c for c in LETTERS if c not in ("|", "'")]
    words = sorted({"".join(rng.choice(letters, size=rng.integers(1, 8)))
                    for _ in range(2_600)})[:2_000]
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    lm = train_kneser_ney([list(rng.choice(words, size=rng.integers(3, 15),
                                           p=p)) for _ in range(6_000)], 3)
    lm.write_arpa(path)
    return len(lm.prob)


def http_get_text(port: int, path: str) -> str:
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.read().decode()


def concurrent_posts(port: int, bodies: list) -> list:
    """POST /transcribe every body at once; (status, json, client ms)."""
    out = [None] * len(bodies)

    def send(i):
        t0 = time.perf_counter()
        out[i] = post(port, "/transcribe", bodies[i]) + (
            (time.perf_counter() - t0) * 1e3,)

    clients = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=600)
    for s, res in zip(SERVE_SECONDS, out):
        check(res is not None and res[0] == 200
              and isinstance(res[1].get("text"), str),
              f"request of {s} s: {res}")
    return out


def phase_serve_decode(service, port: int, arpa: str, seed: int,
                       launches: dict) -> None:
    """The serve phase's requests, concurrent, to ``a8t-serve --beam 8
    --lm <trigram ARPA> --timestamps true``: each text equals a CPU beam
    decode (a fresh decoder on the host) of the log-probs the request
    decoded (the concurrent decodes share one loaded LM in the native
    library), word times fall inside the clip, and ``/metrics`` counts
    exactly the requests sent; the beam's host ms per request."""
    import audio8_tpu_torch.cli.serve as serve_cli
    from audio8_tpu_torch.config import conv_output_length
    from audio8_tpu_torch.models.text import read_vocab_list
    from audio8_tpu_torch.ops.beam import PrefixBeamSearch

    bodies = serve_bodies(seed)
    decoded, lock = [], threading.Lock()
    real = serve_cli.decode_stitched

    def recording(lp, index2vocab, decoder=None, **kw):
        t0 = time.perf_counter()
        text = real(lp, index2vocab, decoder, **kw)
        with lock:
            decoded.append((lp, text, (time.perf_counter() - t0) * 1e3))
        return text

    serve_cli.decode_stitched = recording
    try:
        with inference_path("serve_decode", launches):
            results = concurrent_posts(port, bodies)
    finally:
        serve_cli.decode_stitched = real
    metrics = http_get_text(port, "/metrics").splitlines()
    tmp = os.path.dirname(arpa)
    cpu_decoder = PrefixBeamSearch(
        read_vocab_list(os.path.join(tmp, "dict.ltr.txt")), alpha=0.7,
        beta=5.0, beam=SERVE_BEAM, lm_file=arpa)
    check(len(decoded) == len(bodies), f"{len(decoded)} decodes")
    by_frames = {len(lp): (lp, text, ms) for lp, text, ms in decoded}
    beam_ms, words = [], []
    for s, (_, body, _) in zip(SERVE_SECONDS, results):
        lp, text, ms = by_frames[conv_output_length(
            int(round(s * SR)), service.transcriber.conv_features)]
        check(text == body["text"], f"{s} s: the decode's text was not sent")
        cpu = decode_stitched_cpu(lp, service, cpu_decoder)
        check(cpu == body["text"], f"{s} s: served beam text differs from "
              f"the CPU's decode of its log-probs")
        check(all(0.0 <= w["start"] < w["end"] <= s + 0.02
                  for w in body["words"]), f"{s} s: word times {body}")
        beam_ms.append(ms)
        words.append(len(body["words"]))
    sent = len(bodies)
    audio = sum(round(len(wav_of(b)) / SR, 3) for b in bodies)
    want = [f'a8t_requests_total{{route="/transcribe",code="200"}} {sent}',
            f'a8t_request_seconds_count{{route="/transcribe"}} {sent}',
            f"a8t_audio_seconds_total {audio:.3f}",
            "a8t_batcher_dispatches_total "
            f"{service.transcriber.batcher.dispatches}"]
    check(all(w in metrics for w in want)
          and sum(line.startswith("a8t_requests_total") for line in metrics)
          == 1, f"/metrics: {metrics} lacks {want}")
    emit({"phase": "serve_decode", "requests_s": SERVE_SECONDS,
          "beam": SERVE_BEAM, "lm": os.path.basename(arpa),
          "latency_ms": [r[2] for r in results],
          "server_latency_ms": [r[1]["latency_ms"] for r in results],
          "beam_host_ms": beam_ms, "words": words,
          "texts_len": [len(r[1]["text"]) for r in results],
          "metrics_lines": len(metrics), "launches": launches["serve_decode"]})


def decode_stitched_cpu(lp, service, decoder) -> str:
    from audio8_tpu_torch.serve import decode_stitched

    return decode_stitched(lp, service.index2vocab, decoder,
                           postproc=service.postproc)


def wav_of(body: bytes) -> np.ndarray:
    """The float32 samples the server reads from WAV bytes."""
    from scipy.io import wavfile

    _, pcm = wavfile.read(io.BytesIO(body))
    return pcm.astype(np.float32) / 32768.0


def stream_request(port: int, pcm: bytes, block: int) -> dict:
    """POST /stream ``pcm`` in ``block``-byte chunks of a chunked body
    from a sender thread while this one reads the ndjson lines; returns
    the lines and the seconds from the first byte to the first partial
    and from the last byte to the final line."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.putrequest("POST", "/stream")
    conn.putheader("Transfer-Encoding", "chunked")
    conn.endheaders()
    times = {}

    def send():
        times["first_byte"] = time.perf_counter()
        for i in range(0, len(pcm), block):
            piece = pcm[i:i + block]
            conn.send(b"%x\r\n%s\r\n" % (len(piece), piece))
        times["last_byte"] = time.perf_counter()
        conn.send(b"0\r\n\r\n")

    sender = threading.Thread(target=send)
    sender.start()
    resp = conn.getresponse()
    lines = []
    for raw in iter(resp.readline, b""):
        lines.append(json.loads(raw))
        times.setdefault("first_line", time.perf_counter())
        if lines[-1].get("final"):
            times["final"] = time.perf_counter()
    sender.join(timeout=600)
    conn.close()
    partials = [ln for ln in lines if "partial" in ln]
    return {"lines": lines, "status": resp.status,
            "first_partial_s": (times["first_line"] - times["first_byte"]
                                if partials else None),
            "last_byte_to_final_s": times["final"] - times["last_byte"]}


def phase_stream(service, port: int, seed: int, launches: dict) -> None:
    """``POST /stream`` of the 65 s request in 0.5 s s16 blocks, chunked:
    no error line, partials, the final text equal to ``/transcribe``'s
    on the same audio, the streamed log-probs (through the batcher) equal
    to the offline ones within MODEL_TOL; then the same audio through a
    ``StreamingTranscriber`` without the batcher (batch-1 dispatches)
    within MODEL_TOL too. Time to the first partial and from the last
    byte to the final line."""
    from audio8_tpu_torch.serve import StreamingTranscriber

    body = serve_bodies(seed)[-1]
    wav = wav_of(body)
    pcm = (wav * 32768.0).astype("<i2").tobytes()
    streamed = {}
    real = service.final_text

    def final_text(st, lock=None):
        streamed["lp"] = st.finish()
        return real(st, lock)

    service.final_text = final_text
    t = service.transcriber
    try:
        with inference_path("stream", launches):
            got = stream_request(port, pcm, int(STREAM_BLOCK_S * SR) * 2)
            st = StreamingTranscriber(t.forward, t.conv_features, t.chunk,
                                      t.context, device=t.device)
            block = int(STREAM_BLOCK_S * SR)
            for i in range(0, len(wav), block):
                st.feed(wav[i:i + block])
            alone = st.finish()
            status, offline = post(port, "/transcribe", body)
    finally:
        service.final_text = real
    lines = got["lines"]
    check(got["status"] == 200 and lines and all("error" not in ln
                                                 for ln in lines),
          f"/stream failed: {lines[-3:]}")
    final = lines[-1]
    check(final.get("final") is True and status == 200
          and final["text"] == offline["text"]
          and final["audio_seconds"] == offline["audio_seconds"],
          f"/stream final {final} vs /transcribe {offline}")
    lp_offline = service.log_probs(wav)
    errs = [float(np.abs(lp - lp_offline).max()) if lp.shape ==
            lp_offline.shape else float("inf")
            for lp in (streamed["lp"], alone)]
    emit({"phase": "stream", "audio_s": final["audio_seconds"],
          "block_s": STREAM_BLOCK_S, "lines": len(lines),
          "partials": sum("partial" in ln for ln in lines),
          "first_partial_s": got["first_partial_s"],
          "last_byte_to_final_s": got["last_byte_to_final_s"],
          "upload": "unpaced",
          "stream_vs_offline_max_abs_err": errs[0],
          "batch1_stream_vs_offline_max_abs_err": errs[1],
          "batch1_text_equal": decode_stitched_cpu(
              alone, service, service.decoder) == offline["text"],
          "tol": MODEL_TOL, "launches": launches["stream"]})
    check(max(errs) <= MODEL_TOL, f"streamed log-probs vs offline {errs}")
    check(got["first_partial_s"] is not None, "no partial line")


def dispatch_ms(tmp: str, gen) -> dict:
    """Device ms of one (4, 30 s) dispatch of the served model in f32,
    bf16, int8 (f32 activations) and int8 with bf16, in turns, twice."""
    from audio8_tpu_torch.cli.serve import parse_args
    from audio8_tpu_torch.cli.transcribe import load_acoustic

    base = ["--checkpoint", os.path.join(tmp, "ctc.pt"), "--dict_file",
            os.path.join(tmp, "dict.ltr.txt")]
    variants = {"f32": [], "bf16": ["--bf16"],
                "int8": ["--quantize", "int8"],
                "int8_bf16": ["--quantize", "int8", "--bf16"]}
    forwards = {k: load_acoustic(parse_args(base + v))[1]
                for k, v in variants.items()}
    sig = torch.randn(CHUNK_BATCH, 30 * SR, device="cuda",
                      generator=gen) * 0.1
    lens = torch.full((CHUNK_BATCH,), 30 * SR, device="cuda")
    out = {k: [] for k in variants}
    for _ in range(2):
        for k, fwd in forwards.items():
            out[k].append(device_ms(lambda f=fwd: f(sig, lens)))
    # where each variant's device time goes: its eight costliest kernels
    for k, fwd in forwards.items():
        by_name = traced_or_none(lambda f=fwd: f(sig, lens))
        emit({"phase": "serve_int8", "variant": k,
              "kernels_traced": len(by_name),
              "top_kernels_ms": [[name[:90], ms] for name, ms in sorted(
                  by_name.items(), key=lambda kv: -kv[1])[:8]]})
    del forwards
    torch.cuda.empty_cache()
    return out


def check_int8_dense(phase: str, name: str, card, cpu, rows: int,
                     gen) -> None:
    """A served int8 ``Dense`` on the card against the same layer
    quantized on the CPU, on the same (rows, in) input in the layer's
    compute dtype: the weight codes, the activation codes, the int32
    products and the output, bitwise."""
    from audio8_tpu_torch.ops.quant import int_mm, quantize_rows

    dt = card.compute_dtype
    x = torch.randn(rows, card.in_features, device="cuda",
                    generator=gen).to(dt)
    xc = x.cpu()
    with torch.inference_mode():
        y, y_cpu = card(x), cpu(xc)
        xq, _ = quantize_rows(x)
        xq_cpu, _ = quantize_rows(xc)
        p, p_cpu = int_mm(xq, card.weight), int_mm(xq_cpu, cpu.weight)
    same = {"weight_codes": torch.equal(card.weight.cpu(), cpu.weight),
            "weight_scale": torch.equal(card.weight_scale.cpu(),
                                        cpu.weight_scale),
            "activation_codes": torch.equal(xq.cpu(), xq_cpu),
            "int32_products": torch.equal(p.cpu(), p_cpu),
            "output": torch.equal(y.cpu(), y_cpu)}
    emit({"phase": phase, "layer": name, "dtype": str(dt), "rows": rows,
          "bitwise": same})
    check(all(same.values()), f"{phase} {name} {dt}: {same}")


def phase_serve_int8(tmp: str, seed: int, f32_texts: list,
                     launches: dict, gen) -> None:
    """``a8t-serve --quantize int8``, f32 and ``--bf16``: the served
    model's quantized-layer count equals the CPU's, two int8 layers on
    the card equal the CPU's bitwise (:func:`check_int8_dense`), the
    transcripts' edit distance to the unquantized f32 texts; then the
    device ms of one (4, 30 s) dispatch, int8 against bf16 against f32
    (:func:`dispatch_ms`)."""
    from audio8_tpu_torch.models.convert import load_fairseq_ctc
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.ops.quant import quantize_model_params

    bodies = serve_bodies(seed)
    rows = CHUNK_BATCH * ATTN_SHAPE[2]
    for flags in ([], ["--bf16"]):
        dtype = torch.bfloat16 if flags else torch.float32
        cpu = Wav2Vec2AcousticModel(base_config(4 + len(LETTERS)), dtype)
        cpu.load_state_dict(load_fairseq_ctc(os.path.join(tmp, "ctc.pt")))
        cpu_count = quantize_model_params(cpu)
        with serving(tmp, "--quantize", "int8", *flags) as (service, port):
            with inference_path("serve_int8", launches) if not flags \
                    else contextlib.nullcontext():
                results = concurrent_posts(port, bodies)
            served = service.transcriber.forward.model
            count = sum(m.weight.dtype == torch.int8 for m in served.modules()
                        if hasattr(m, "weight_scale"))
            check(count == cpu_count, f"int8 layers {count} vs CPU "
                  f"{cpu_count}")
            card_layer = served.encoder.encoder.layers[0]
            cpu_layer = cpu.encoder.encoder.layers[0]
            for name in ("fc1", "self_attn.q_proj"):
                check_int8_dense("serve_int8", f"layers.0.{name}",
                                 card_layer.get_submodule(name),
                                 cpu_layer.get_submodule(name), rows, gen)
        texts = [r[1]["text"] for r in results]
        emit({"phase": "serve_int8", "dtype": str(dtype),
              "quantized_layers": count, "requests_s": SERVE_SECONDS,
              "latency_ms": [r[2] for r in results],
              "char_diff_vs_f32": [edit_distance(a, b) / max(1, len(a))
                                   for a, b in zip(f32_texts, texts)],
              "texts_equal_f32": [a == b for a, b in zip(f32_texts, texts)],
              "launches": launches["serve_int8"]})
        del cpu
    emit({"phase": "serve_int8", "dispatch_device_ms": dispatch_ms(tmp, gen),
          "shape": [CHUNK_BATCH, 30 * SR], "timed_by": "torch.profiler"})


def write_vad_files(root: str, seed: int) -> list:
    """Two WAVs of three tone-and-noise bursts between near-silences."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed + 11)
    paths = []
    for i in range(2):
        parts = []
        for _ in range(3):
            parts.append(rng.normal(size=int(rng.uniform(*VAD_BURSTS[0])
                                            * SR)) * 1e-3)
            parts.append(synthetic_speechlike(rng.uniform(*VAD_BURSTS[1]),
                                              rng) * 4.0)
        parts.append(rng.normal(size=SR // 2) * 1e-3)
        path = os.path.join(root, f"vad{i}.wav")
        wavfile.write(path, SR, (np.clip(np.concatenate(parts), -1, 1)
                                 * 32767).astype(np.int16))
        paths.append(path)
    return paths


def phase_transcribe_vad(tmp: str, seed: int, launches: dict) -> None:
    """``cli.transcribe --vad true --timestamps true`` on two files with
    silences, on the card and on the CPU: the segments equal; each
    segment's log-probs within MODEL_TOL, and its text and words equal
    unless a frame's top two CPU log-probs lie within twice the error
    (the serve phase's rule)."""
    import audio8_tpu_torch.cli.transcribe as transcribe

    paths = write_vad_files(tmp, seed)
    argv = ["--checkpoint", os.path.join(tmp, "ctc.pt"), "--dict_file",
            os.path.join(tmp, "dict.ltr.txt"), "--vad", "true",
            "--timestamps", "true", *paths]
    real = transcribe._transcribe_wav
    runs = {}
    for device in ("cuda", "cpu"):
        segs = runs[device] = []

        def recording(*a, **kw):
            out = real(*a, **kw)
            segs.append(out)
            return out

        transcribe._transcribe_wav = recording
        try:
            with contextlib.redirect_stdout(io.StringIO()), (
                    inference_path("transcribe_vad", launches)
                    if device == "cuda" else contextlib.nullcontext()):
                t0 = time.perf_counter()
                rows = transcribe.main(argv + ["--device", device])
                wall = time.perf_counter() - t0
        finally:
            transcribe._transcribe_wav = real
        runs[device + "_rows"], runs[device + "_wall"] = rows, wall
    card, cpu = runs["cuda_rows"], runs["cpu_rows"]
    check([r["segments"] for r in card] == [r["segments"] for r in cpu]
          and all(len(r["segments"]) > 1 for r in card),
          f"VAD segments {[r['segments'] for r in card]} vs "
          f"{[r['segments'] for r in cpu]}")
    err, ties = 0.0, False
    for (_, a), (_, b) in zip(runs["cuda"], runs["cpu"]):
        check(a.shape == b.shape, "segment frames differ on the CPU")
        e = float(np.abs(a - b).max())
        err = max(err, e)
        top2 = np.sort(b, axis=-1)[:, -2:]
        ties = ties or bool(((top2[:, 1] - top2[:, 0]) <= 2 * e).any())
    same = [(r["text"], r["words"]) == (c["text"], c["words"])
            for r, c in zip(card, cpu)]
    emit({"phase": "transcribe_vad",
          "segments": [r["segments"] for r in card],
          "segment_lengths_s": [round(b - a, 3) for r in card
                                for a, b in r["segments"]],
          "words": [len(r["words"]) for r in card],
          "max_abs_err": err, "tol": MODEL_TOL, "near_tie": ties,
          "rows_equal_cpu": same, "card_wall_s": runs["cuda_wall"],
          "cpu_wall_s": runs["cpu_wall"],
          "launches": launches["transcribe_vad"]})
    check(err <= MODEL_TOL, f"transcribe_vad log-probs vs CPU {err}")
    check(all(same) or ties, "transcribe_vad: rows differ from the CPU's "
          "with no near tie")


def write_embed_corpus(root: str, seed: int) -> tuple:
    """EMBED_FILES WAVs of 2-21 s (four tone sets, four files each) in a
    manifest ordered by length, and trials among the EMBED_BATCH shortest
    files (one batch): each with the next four (same set: 1, else 0)."""
    from scipy.io import wavfile

    os.makedirs(root)
    rng = np.random.default_rng(seed + 13)
    seconds = np.sort(rng.uniform(2.0, 21.0, EMBED_FILES))
    seconds[-1] = 21.0
    sets = rng.permutation(np.repeat(np.arange(4), EMBED_FILES // 4))
    names = []
    with open(os.path.join(root, "test.tsv"), "w") as tf:
        tf.write(root + "\n")
        for i, (s, g) in enumerate(zip(seconds, sets)):
            wav = synthetic_speechlike(float(s), np.random.default_rng(
                [seed, int(g), i]))
            name = f"set{g}_{i}.wav"
            wavfile.write(os.path.join(root, name), SR,
                          (np.clip(wav, -1, 1) * 32767).astype(np.int16))
            tf.write(f"{name}\t{len(wav)}\n")
            names.append((name, int(g)))
    with open(os.path.join(root, "trials.txt"), "w") as f:
        short = names[:EMBED_BATCH]
        for i, (a, ga) in enumerate(short):
            for b, gb in short[i + 1:i + 5]:
                f.write(f"{a}\t{b}\t{int(ga == gb)}\n")
    return os.path.join(root, "trials.txt")


def phase_embed(tmp: str, seed: int, launches: dict) -> None:
    """``cli.embed --reduction_type mean`` on the pretraining phase's
    ``checkpoint-step-5.pt`` over EMBED_FILES files of 2-21 s, batch 8
    (padded to whole seconds), on the card and on the CPU: each vector's
    cosine to the CPU's >= 1 - EMBED_COS_TOL, norms 1 within it, the
    ``--trials`` EER equal; utterances/s of a second, warm pass."""
    from audio8_tpu_torch.cli import embed as embed_cli

    root = os.path.join(tmp, "embed_corpus")
    trials = write_embed_corpus(root, seed)
    base = ["--checkpoint", os.path.join(tmp, "pretrain_run",
                                         "checkpoint-step-5.pt"),
            "--root_dir", root, "--reduction_type", "mean", "--batch",
            str(EMBED_BATCH)]
    out = {}
    for device in ("cuda", "cpu"):
        prefix = os.path.join(tmp, f"emb_{device}")
        with contextlib.redirect_stdout(io.StringIO()) as printed, (
                inference_path("embed", launches) if device == "cuda"
                else contextlib.nullcontext()):
            t0 = time.perf_counter()
            embed_cli.main(base + ["--device", device, "--output", prefix])
            wall = time.perf_counter() - t0
            embed_cli.main(base + ["--device", device, "--trials", trials])
        out[device] = (np.load(prefix + ".npy"), wall,
                       printed.getvalue().strip().splitlines()[-1])
    card, cpu = out["cuda"][0], out["cpu"][0]
    cos = (card * cpu).sum(-1) / (np.linalg.norm(card, axis=-1)
                                  * np.linalg.norm(cpu, axis=-1))
    norms = np.linalg.norm(card, axis=-1)
    with open(os.path.join(root, "test.tsv")) as f:
        paths = [os.path.join(root, line.split("\t")[0])
                 for line in f.read().splitlines()[1:]]
    embed = embed_cli.build_embedder(embed_cli.parse_args(
        base + ["--device", "cuda"]))
    embed(paths)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embed(paths)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    emit({"phase": "embed", "files": len(paths), "batch": EMBED_BATCH,
          "shape": list(card.shape), "min_cosine": float(cos.min()),
          "max_norm_err": float(np.abs(norms - 1).max()),
          "eer": [out["cuda"][2], out["cpu"][2]],
          "cli_wall_s": [out["cuda"][1], out["cpu"][1]],
          "utterances_per_s": len(paths) / warm,
          "audio_s_per_s": sum(len(embed_cli.SoundfileAudioReader().read(p))
                               for p in paths) / SR / warm,
          "launches": launches["embed"]})
    check(card.shape == cpu.shape == (EMBED_FILES, 768)
          and bool(np.isfinite(card).all()), f"embed shape {card.shape}")
    check(float(cos.min()) >= 1 - EMBED_COS_TOL,
          f"embed cosine to the CPU {cos.min()}")
    check(float(np.abs(norms - 1).max()) <= EMBED_COS_TOL,
          f"embed norms {norms}")
    check(out["cuda"][2] == out["cpu"][2] and out["cuda"][2].startswith(
        "eer "), f"EER {out['cuda'][2]} vs {out['cpu'][2]}")


def phase_inference_kernels(gen) -> dict:
    """Kernels 2 and 3 against their plain versions, float32 and bfloat16,
    at every shape the inference phases gave them (INFER_CALLS): each
    conv input, each attention shape with its first call's key lengths;
    returns the float32 max errors."""
    shapes = path_shapes(INFER_CALLS)
    emit({"phase": "inference_kernel",
          "conv_inputs": [list(x) for x, _ in shapes["conv"]],
          "attention": [[list(s), lens] for s, _, _, lens, _
                        in shapes["attention"]]})
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs = {k: 0.0 for k in INFER_PATH}
        for x_shape, w_shape in shapes["conv"]:
            errs["conv_k3s2_fwd"] = max(errs["conv_k3s2_fwd"], check_conv_fwd(
                "inference_kernel", x_shape, w_shape, dtype, gen))
        for shape, sem, _, lengths, rate in shapes["attention"]:
            errs["attention_fwd"] = max(errs["attention_fwd"], check_attn_fwd(
                "inference_kernel", shape, lengths, rate, sem, dtype, gen))
            torch.cuda.empty_cache()
        if dtype == torch.float32:
            worst = errs
    return worst


def phase_inference(tmp: str, f32_texts: list, worst: dict, gen) -> dict:
    """Phases 15 on tmp's served ``ctc.pt`` and the pretraining phase's
    ``.pt``: serve_decode and stream on one ``--beam --lm --timestamps``
    server, serve_int8, transcribe_vad, embed, then inference_kernel
    (raising ``worst``). Returns the runs' launches by phase."""
    launches: dict = {}
    with contextlib.ExitStack() as stack:
        with timed("serve_decode"):
            arpa = os.path.join(tmp, "serve_lm.arpa")
            emit({"phase": "serve_lm", "ngrams": write_serve_lm(arpa, SEED)})
            service, port = stack.enter_context(serving(
                tmp, "--beam", str(SERVE_BEAM), "--lm", arpa,
                "--timestamps", "true"))
            phase_serve_decode(service, port, arpa, SEED, launches)
        with timed("stream"):
            phase_stream(service, port, SEED, launches)
    torch.cuda.empty_cache()
    with timed("serve_int8"):
        phase_serve_int8(tmp, SEED, f32_texts, launches, gen)
    torch.cuda.empty_cache()
    with timed("transcribe_vad"):
        phase_transcribe_vad(tmp, SEED, launches)
    torch.cuda.empty_cache()
    with timed("embed"):
        phase_embed(tmp, SEED, launches)
    torch.cuda.empty_cache()
    with timed("inference_kernel"):
        for k, e in phase_inference_kernels(gen).items():
            worst[k] = max(worst[k], e)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ export

EXPORT_SECONDS = ("5", "30")  # the artifacts' entries
EXPORT_PATH = ("conv_k3s2_fwd", "attention_fwd")
EXPORT_LENGTHS = [30 * SR, 24 * SR, 11 * SR, 4 * SR]  # one (4, 30 s) batch
# exported vs live on the same inputs: the same kernels, so bitwise is
# expected; the gates are the f32 kernel tolerance and bf16's
EXPORT_TOL = {"f32": TOL[torch.float32], "bf16": TOL[torch.bfloat16],
              "int8": TOL[torch.float32]}
EXPORT_FLAGS = {"f32": [], "bf16": ["--bf16"],
                "int8": ["--quantize", "int8"]}
# int8 and the pooled artifact take the 30 s entry alone (each entry's
# trace and load cost 4-12 s on the card's host)
EXPORT_ONE_ENTRY = ("30",)
# a process that loads the three artifacts with the model code blocked
NO_MODEL_CODE = """
import sys
for m in ("audio8_tpu_torch.models", "audio8_tpu_torch.nn", "jax",
          "audio8_tpu"):
    sys.modules[m] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from audio8_tpu_torch.export import load_artifact
batch = np.load(sys.argv[2])
for path, out in zip(sys.argv[3::2], sys.argv[4::2]):
    art = load_artifact(path, "cuda")
    lp, frames = art.forward(torch.from_numpy(batch["signal"]).cuda(),
                             torch.from_numpy(batch["lengths"]).cuda())
    np.save(out, lp.float().cpu().numpy())
assert not any(k.startswith(("audio8_tpu_torch.models",
                             "audio8_tpu_torch.nn"))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def greedy_texts(lp: torch.Tensor, frames: torch.Tensor,
                 index2vocab: dict) -> list:
    """Each row's greedy text, decoded as the served path decodes it."""
    from audio8_tpu_torch.serve import decode_stitched

    lp = lp.float().cpu().numpy()
    return [decode_stitched(lp[i, :int(n)], index2vocab)
            for i, n in enumerate(frames.tolist())]


def export_artifact(tmp: str, name: str, seconds, *flags: str) -> tuple:
    """``cli.export`` of tmp's ``ctc.pt`` for the card with entries of
    ``seconds``: (artifact directory, export seconds)."""
    from audio8_tpu_torch.cli import export as export_cli

    out = os.path.join(tmp, f"art_{name}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        export_cli.main(["--checkpoint", os.path.join(tmp, "ctc.pt"),
                         "--dict_file", os.path.join(tmp, "dict.ltr.txt"),
                         "--output", out, "--seconds", *seconds,
                         "--platforms", "cuda", *flags])
    return out, time.perf_counter() - t0


def export_batch(seconds: list, seed: int) -> tuple:
    """A batch of rows of ``seconds`` (speechlike audio), padded to the
    longest, on the card."""
    rng = np.random.default_rng(seed + 21)
    wavs = [synthetic_speechlike(s / SR, rng) for s in seconds]
    sig = np.zeros((len(wavs), max(seconds)), np.float32)
    for i, w in enumerate(wavs):
        sig[i, :len(w)] = w
    return (torch.from_numpy(sig).cuda(),
            torch.tensor(seconds, dtype=torch.int32).cuda())


def check_exported(variant: str, art, live, index2vocab, sig, lens) -> dict:
    """One dispatch of the loaded artifact against the live forward on the
    same inputs (padded to the entry the artifact takes): the max error
    over valid frames, bitwise equality, argmax and greedy texts."""
    entry = art.entry_samples(sig.shape[1])
    lp, frames = art.forward(sig, lens)
    lp_live, frames_live = live(
        torch.nn.functional.pad(sig, (0, entry - sig.shape[1])), lens)
    check(torch.equal(frames, frames_live),
          f"export {variant}: frames {frames.tolist()} vs "
          f"{frames_live.tolist()}")
    valid = torch.arange(lp.shape[1], device=lp.device)[None] < frames[:, None]
    err = (lp.float() - lp_live.float()).abs()[valid].max().item()
    argmax_equal = bool((lp.argmax(-1) == lp_live.argmax(-1))[valid].all())
    texts = greedy_texts(lp, frames, index2vocab)
    texts_live = greedy_texts(lp_live, frames, index2vocab)
    row = {"batch": list(sig.shape), "entry": entry, "max_abs_err": err,
           "bitwise": bool(torch.equal(lp, lp_live)), "tol":
           EXPORT_TOL[variant], "argmax_equal": argmax_equal,
           "texts_equal": texts == texts_live}
    check(err <= EXPORT_TOL[variant], f"export {variant}: exported vs live "
          f"{err} > {EXPORT_TOL[variant]}")
    check(argmax_equal and texts == texts_live,
          f"export {variant}: argmax or text differ from the live forward")
    return row


def phase_export(tmp: str, seed: int) -> dict:
    """The export phase on tmp's ``ctc.pt`` and ``dict.ltr.txt``
    (module docstring, phase 17). Returns the kernels' launches over it."""
    import audio8_tpu_torch.cli.transcribe as transcribe
    from audio8_tpu_torch.export import load_artifact
    from audio8_tpu_torch.ops.samples import run_opcheck

    reset_launches()
    with timed("export_opcheck"):
        t0 = time.perf_counter()
        results = run_opcheck("cuda")
        failed = {k: v for k, v in results.items()
                  if any(r != "SUCCESS" for r in v.values())}
        emit({"phase": "export", "opcheck": {k: sorted(set(v.values()))
                                            for k, v in results.items()},
              "cases": len(results), "seconds": time.perf_counter() - t0})
        check(not failed, f"opcheck on the card: {failed}")
    sig, lens = export_batch(EXPORT_LENGTHS, seed)
    short = export_batch([3 * SR, 2 * SR], seed + 1)
    arts, timings, outputs = {}, {}, {}
    base = ["x.wav", "--checkpoint", os.path.join(tmp, "ctc.pt"),
            "--dict_file", os.path.join(tmp, "dict.ltr.txt")]
    for variant, flags in EXPORT_FLAGS.items():
        entries = EXPORT_ONE_ENTRY if variant == "int8" else EXPORT_SECONDS
        path, seconds = export_artifact(tmp, variant, entries, *flags)
        t0 = time.perf_counter()
        art = load_artifact(path, "cuda")
        load_s = time.perf_counter() - t0
        _, live, _, index2vocab, _ = transcribe.load_acoustic(
            transcribe.parse_args(base + flags))
        with torch.inference_mode():
            rows = [check_exported(variant, art, live, index2vocab, sig,
                                   lens),
                    check_exported(variant, art, live, index2vocab, *short)]
        reset_launches()
        lp, _ = art.forward(sig, lens)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        check(launches == {"attention_fwd": 12, "conv_k3s2_fwd": 4},
              f"export {variant}: one exported dispatch launched "
              f"{launches}, want 12 and 4")
        outputs[variant] = (path, lp.float().cpu().numpy())
        if variant != "int8":
            ms = {"live": [], "exported": []}
            with torch.inference_mode():
                for name in ("live", "exported", "exported", "live"):
                    fn = live if name == "live" else art.forward
                    ms[name].append(event_ms(lambda f=fn: f(sig, lens)))
                # where the time goes: device ms and kernels of each
                for name, fn in (("live", live), ("exported", art.forward)):
                    by_name = traced_or_none(lambda f=fn: f(sig, lens))
                    ms[name + "_device_ms"] = sum(by_name.values())
                    ms[name + "_kernel_names"] = len(by_name)
                    ms[name + "_top_kernels_ms"] = [
                        [k[:80], v] for k, v in sorted(
                            by_name.items(), key=lambda kv: -kv[1])[:4]]
            timings[variant] = ms
        emit({"phase": "export", "variant": variant, "flags": flags,
              "entries_s": list(entries), "export_s": seconds,
              "load_s": load_s, "checks": rows, "launches": launches,
              "files": sorted(os.listdir(path))})
        arts[variant] = (path, art)
        del live
        torch.cuda.empty_cache()
    emit({"phase": "export_timing", "dispatch": [CHUNK_BATCH, 30 * SR],
          "card": card_name(), "event_ms": timings})

    # the three artifacts in a process without the model code
    npz = os.path.join(tmp, "export_batch.npz")
    np.savez(npz, signal=sig.cpu().numpy(), lengths=lens.cpu().numpy())
    outs = [os.path.join(tmp, f"no_model_{v}.npy") for v in outputs]
    argv = [x for v, o in zip(outputs, outs) for x in (outputs[v][0], o)]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", NO_MODEL_CODE, HERE, npz,
                          *argv], capture_output=True, text=True,
                         timeout=600)
    check(run.returncode == 0 and run.stdout.strip().endswith("ok"),
          f"export without the model code: {run.stderr[-3000:]}")
    errs = {v: float(np.abs(np.load(o) - outputs[v][1]).max())
            for v, o in zip(outputs, outs)}
    emit({"phase": "export", "no_model_code": errs,
          "seconds": time.perf_counter() - t0})
    for v, e in errs.items():
        check(e <= EXPORT_TOL[v], f"export {v} without the model code: {e}")

    return phase_export_clis(tmp, seed, arts)


def phase_export_clis(tmp: str, seed: int, arts: dict) -> dict:
    """The four ``--exported`` entry points on the f32 artifact (and a
    ``--pooled`` one): ``cli.transcribe`` texts equal the live forward's
    at the entry's padding, ``cli.test`` scores equal the live
    checkpoint's at the entry table's length grid, ``cli.serve``'s
    ``/transcribe`` equals ``cli.transcribe --exported`` at the same
    chunking, ``cli.embed`` within EXPORT_TOL of the live pooled encoder
    at the same padding. Returns the kernels' launches over the four
    CLIs' runs (the live comparisons' included)."""
    from scipy.io import wavfile

    import audio8_tpu_torch.cli.transcribe as transcribe
    from audio8_tpu_torch.cli import embed as embed_cli
    from audio8_tpu_torch.cli import export as export_cli
    from audio8_tpu_torch.cli import test as test_cli

    path, art = arts["f32"]
    reset_launches()
    root = os.path.join(tmp, "export_corpus")
    os.makedirs(root)
    rng = np.random.default_rng(seed + 23)
    # every file under cli.test's and cli.embed's 325 000-sample cap
    seconds = [3.1, 12.4, 19.7, 4.6]
    files = []
    with open(os.path.join(root, "valid.tsv"), "w") as tf, \
            open(os.path.join(root, "valid.ltr"), "w") as lf:
        tf.write(root + "\n")
        for i, s in enumerate(seconds):
            wav = synthetic_speechlike(s, rng)
            files.append(os.path.join(root, f"e{i}.wav"))
            wavfile.write(files[-1], SR,
                          (np.clip(wav, -1, 1) * 32767).astype(np.int16))
            tf.write(f"e{i}.wav\t{len(wav)}\n")
            lf.write(" ".join(rng.choice(LETTERS[1:], 6)) + " |\n")
    with open(os.path.join(root, "dict.ltr.txt"), "w") as f:
        f.writelines(f"{c} {1000 - i}\n" for i, c in enumerate(LETTERS))
    exported = ["--exported", path]
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        rows = transcribe.main(exported + files)
        transcribe_s = time.perf_counter() - t0
        chunked = transcribe.main(exported + ["--chunk_seconds", "30",
                                              "--context_seconds", "2",
                                              files[1]])
    # cli.transcribe pads each file to whole seconds; the artifact takes
    # it to its entry, the live forward here to the same
    _, live, _, index2vocab, _ = transcribe.load_acoustic(
        transcribe.parse_args(["x.wav", "--checkpoint", os.path.join(
            tmp, "ctc.pt"), "--dict_file", os.path.join(tmp,
                                                        "dict.ltr.txt")]))
    want = []
    for f in files:
        sig, lens = padded_files([f], art.entry_sizes)
        want += greedy_texts(*live(sig, lens), index2vocab)
    got = [t for _, t in rows]
    check(got == want,
          f"cli.transcribe --exported {got} vs the live forward {want}")

    common = ["--root_dir", root, "--valid_dataset", "valid.tsv"]
    with contextlib.redirect_stdout(io.StringIO()):
        scores = test_cli.evaluate(common + exported)
        live_scores = test_cli.evaluate(common + [
            "--checkpoint", os.path.join(tmp, "ctc.pt"), "--length_buckets",
            *(str(t) for t in art.entry_sizes)])
    keys = ("cer", "wer", "step", "utterances")
    check({k: scores[k] for k in keys} == {k: live_scores[k] for k in keys},
          f"cli.test --exported {scores} vs live {live_scores}")

    with serving(tmp, *exported) as (service, port):
        with open(files[1], "rb") as f:
            status, reply = post(port, "/transcribe", f.read())
        status_h, health = post(port, "/healthz")
    check(status == 200 and reply["text"] == chunked[0][1],
          f"cli.serve --exported {reply} vs cli.transcribe {chunked}")
    check(status_h == 200 and health["model"] == "wav2vec2-ctc (exported)",
          f"healthz {health}")

    pooled = os.path.join(tmp, "art_pooled")
    with contextlib.redirect_stdout(io.StringIO()):
        export_cli.main(["--checkpoint", os.path.join(tmp, "ctc.pt"),
                         "--output", pooled, "--pooled", "true",
                         "--reduction_type", "mean", "--seconds",
                         *EXPORT_ONE_ENTRY, "--platforms", "cuda"])
        prefix = os.path.join(tmp, "emb_exported")
        embed_cli.main(["--exported", pooled, "--root_dir", root,
                        "--dataset", "valid.tsv", "--output", prefix])
    emb = np.load(prefix + ".npy")
    args = embed_cli.parse_args(["--checkpoint", os.path.join(tmp, "ctc.pt"),
                                 "--root_dir", root])
    _, model = embed_cli.build_pooled(args, torch.device("cuda"))
    with open(os.path.join(pooled, "meta.json")) as f:
        sizes = sorted(int(e["t"]) for e in json.load(f)["entries"])
    with torch.inference_mode():  # one batch of the four files
        want_emb = embed_cli.normalized(model(*padded_files(files, sizes),
                                              freeze=False)).cpu().numpy()
    emb_err = float(np.abs(emb - want_emb).max())
    emit({"phase": "export", "clis": {
        "transcribe_texts_equal": True, "transcribe_s": transcribe_s,
        "test": {k: scores[k] for k in keys},
        "serve_text_equal_transcribe": True,
        "embed_shape": list(emb.shape), "embed_max_abs_err": emb_err}})
    check(emb_err <= EXPORT_TOL["f32"],
          f"cli.embed --exported vs the live encoder {emb_err}")
    return read_launches()


def padded_files(paths: list, sizes: list) -> tuple:
    """Files as one batch on the card, padded to the smallest of
    ``sizes`` (an artifact's entries) that holds the longest."""
    from audio8_tpu_torch.data.audio import SoundfileAudioReader

    wavs = [np.asarray(SoundfileAudioReader().read(p), np.float32)
            for p in paths]
    longest = max(len(w) for w in wavs)
    sig = torch.zeros((len(wavs), min(t for t in sizes if t >= longest)),
                      device="cuda")
    for i, w in enumerate(wavs):
        sig[i, :len(w)] = torch.from_numpy(w)
    return sig, torch.tensor([len(w) for w in wavs], device="cuda")


def export_phases(gen) -> int:
    """The build and the export phase alone (``--export-phases``) on a
    fresh ``ctc.pt`` of the model phase's weights."""
    from audio8_tpu_torch.models.convert import save_fairseq_ctc
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    with timed("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        cpu = Wav2Vec2AcousticModel(base_config(4 + len(LETTERS)),
                                    generator=torch.Generator().manual_seed(
                                        SEED))
        save_fairseq_ctc(cpu, os.path.join(tmp, "ctc.pt"))
        with open(os.path.join(tmp, "dict.ltr.txt"), "w") as fh:
            fh.writelines(f"{c} {1000 - i}\n" for i, c in enumerate(LETTERS))
        with timed("export"):
            launches = phase_export(tmp, SEED)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "export_phases", "launches": launches})
    print_card()
    return 0


# ------------------------------------------------ the public topologies

# the large presets of the public encoder families (cli/common.py:
# MODEL_PRESETS), at full width: 24 layers of 1024, 16 heads, 4096
LARGE_PRESETS = ("large-lv60", "hubert-large", "data2vec-large",
                 "wavlm-large", "conformer-large-rope", "conformer-large-rel")
TOPO_PATH = ("conv_k3s2_fwd", "attention_fwd")
TOPO_LENGTHS = [30 * SR, 24 * SR, 11 * SR, 4 * SR]  # one (4, 30 s) dispatch
LV60_PRETRAIN_FLAGS = ["--preset", "large-lv60", "--tokens_per_batch",
                       "700000", "--max_sample_len", "250000",
                       "--train_steps", "2", "--steps_per_checkpoint", "2",
                       "--warmup_steps", "1", "--num_train_workers", "4"]
LV60_TRAIN_FLAGS = ["--preset", "large-lv60", "--layer_drop", "0.1",
                    "--target_tokens_per_batch", "700000", "--grad_accum",
                    "1", "--train_steps", "4", "--unfreeze_enc_after_step",
                    "1", "--warmup_steps", "2", "--valid_steps", "1"]
LV60_PATH = ("conv_k3s2_fwd", "conv_k3s2_dgrad", "conv_k3s2_wgrad",
             "attention_fwd", "attention_bwd", "ctc_loss", "dropout",
             "adamw")
LV60_BLOCK_STEPS = 2
LV60_SIZE = dict(d_model=1024, d_ff=4096, num_heads=16, num_layers=24,
                 pre_norm=True, extractor_mode="layer", conv_bias=True)


TOPOLOGY_PHASES = ("topologies", "hf_golden", "lv60_train", "lv60_block")


def topology_phases(tmp: str, worst: dict, gen) -> dict:
    """This slice's phases in order (``tmp`` holds the train and
    pretrain phases' corpora); each kernel's largest error merged into
    ``worst``. Returns each phase's launch counts."""
    out = {}
    with timed("topologies"):
        out["topologies"], errs = phase_topologies(SEED, gen)
        merge_worst(worst, errs)
    torch.cuda.empty_cache()
    with timed("hf_golden"):
        out["hf_golden"] = phase_hf_golden(tmp)
    torch.cuda.empty_cache()
    with timed("lv60_train"):
        out["lv60_train"], errs, batches = phase_lv60_train(tmp, SEED, gen)
        merge_worst(worst, errs)
    torch.cuda.empty_cache()
    with timed("lv60_block"):
        out["lv60_block"], errs = phase_lv60_block(tmp, batches, SEED, gen)
        merge_worst(worst, errs)
    torch.cuda.empty_cache()
    return out


def topology_timing(gen) -> int:
    """The build and this slice's phases alone on fresh corpora
    (``--topology-phases``), then the phase seconds and the card."""
    with timed("build"):
        phase_build()
    worst = {k: 0.0 for k in REPLACES}
    with tempfile.TemporaryDirectory() as tmp:
        for name, write in (("corpus", write_corpus),
                            ("pretrain_corpus", write_pretrain_corpus)):
            os.makedirs(os.path.join(tmp, name))
            write(os.path.join(tmp, name), SEED)
        launches = topology_phases(tmp, worst, gen)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "topology_phases", "launches": launches,
          "max_abs_err": worst})
    print_card()
    return 0


def merge_worst(worst: dict, errs: dict) -> None:
    """Keep each kernel's largest max error."""
    for k, e in errs.items():
        worst[k] = max(worst[k], e)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def event_ms(fn, calls: int = 2) -> float:
    """Mean CUDA-event ms of ``calls`` calls after one warm-up call."""
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / calls


def preset_config(preset: str, num_labels: int, **over):
    """The acoustic config of a ``MODEL_PRESETS`` entry (evaluation:
    dropout and masking off unless ``over`` says otherwise)."""
    from audio8_tpu_torch.cli.common import (_PRESET_BASE_DEFAULTS,
                                             MODEL_PRESETS)

    kw = {k: MODEL_PRESETS[preset].get(k, v)
          for k, v in _PRESET_BASE_DEFAULTS.items() if k != "final_dim"}
    kw.update(dropout=0.0)
    kw.update(over)
    return base_config(num_labels, **kw)


def first_dense(model):
    """The first FFN ``Dense`` of the encoder's layer 0."""
    layer = model.encoder.encoder.layers[0]
    return layer.ffn1.intermediate_dense if hasattr(layer, "ffn1") \
        else layer.fc1


def check_recorded_fwd(phase: str, shapes: dict, gen) -> dict:
    """Kernels 3 and 2 against their plain versions at every forward
    shape a run gave them, f32 and bf16; returns the f32 max errors."""
    worst = {k: 0.0 for k in TOPO_PATH}
    for dtype in (torch.float32, torch.bfloat16):
        for x_shape, w_shape in shapes["conv"]:
            e = check_conv_fwd(phase, x_shape, w_shape, dtype, gen)
            if dtype == torch.float32:
                worst["conv_k3s2_fwd"] = max(worst["conv_k3s2_fwd"], e)
        for shape, sem, _, lengths, rate in shapes["attention"]:
            e = check_attn_fwd(phase, shape, lengths, rate, sem, dtype, gen)
            if dtype == torch.float32:
                worst["attention_fwd"] = max(worst["attention_fwd"], e)
            torch.cuda.empty_cache()
    return worst


def phase_topologies(seed: int, gen) -> tuple:
    """Each large preset at full width with seeded weights: one (4, 30 s)
    dispatch in f32 and in bf16 (event ms), the card against the CPU on
    (1, 4 s) at the same weights (f32 log-probs within MODEL_TOL), and
    layer 0's first FFN ``Dense`` in bf16 held to the CPU's order.
    Attention runs the core (kernel 2) in the transformer layouts and the
    composition in WavLM's and the conformer's, as JAX takes XLA there.
    Returns the launch counts, the recorded forward shapes' max errors
    and the shapes."""
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    rng = np.random.default_rng(seed + 13)
    sig = torch.zeros(CHUNK_BATCH, TOPO_LENGTHS[0])
    for i, n in enumerate(TOPO_LENGTHS):
        sig[i, :n] = torch.from_numpy(synthetic_speechlike(n / SR, rng))
    lens = torch.tensor(TOPO_LENGTHS)
    small = torch.from_numpy(synthetic_speechlike(4.0, rng))[None]
    small_len = torch.tensor([4 * SR])
    sig, lens_c = sig.cuda(), lens.cuda()
    card = card_name()
    total = {k: 0 for k in TOPO_PATH}
    calls = {}
    with recorded_path_calls(calls):
        for preset in LARGE_PRESETS:
            cfg = preset_config(preset, 4 + len(LETTERS))
            cpu = Wav2Vec2AcousticModel(
                cfg, generator=torch.Generator().manual_seed(seed + 13))
            state = cpu.state_dict()
            gpu = Wav2Vec2AcousticModel(cfg).cuda().eval()
            gpu.load_state_dict(state)
            bf16 = Wav2Vec2AcousticModel(cfg, torch.bfloat16).cuda().eval()
            bf16.load_state_dict(state)
            reset_launches()
            ms, outs, peak = {}, {}, {}
            gc.collect()
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated() / 1e9
            with torch.inference_mode():
                for name, m in (("f32", gpu), ("bf16", bf16)):
                    # this dispatch's own peak: the running maximum starts
                    # again at what is resident (both models' weights)
                    torch.cuda.reset_peak_memory_stats()
                    outs[name] = m(sig, lens_c)[0]
                    torch.cuda.synchronize()
                    peak[name] = torch.cuda.max_memory_allocated() / 1e9
                    ms[name] = event_ms(lambda m=m: m(sig, lens_c))
                lp_gpu, _ = gpu(small.cuda(), small_len.cuda())
                torch.cuda.synchronize()
            launches = {k: n for k, n in read_launches().items()
                        if k in TOPO_PATH}
            with torch.inference_mode():
                lp_cpu, _ = cpu(small, small_len)
            err = (lp_gpu.cpu() - lp_cpu).abs().max().item()
            agree = (lp_gpu.cpu().argmax(-1) == lp_cpu.argmax(-1)).float(
            ).mean().item()
            composed = cfg.gated_rel_pos or cfg.encoder_type == "conformer"
            emit({"phase": "topologies", "preset": preset,
                  "params": sum(p.numel() for p in cpu.parameters()),
                  "dispatch": [CHUNK_BATCH, TOPO_LENGTHS[0]],
                  "lengths": TOPO_LENGTHS, "event_ms": ms, "card": card,
                  "attention": "composition" if composed else "core",
                  "launches": launches, "vs_cpu": [1, 4 * SR],
                  "max_abs_err": err, "tol": MODEL_TOL,
                  "argmax_agreement": agree, "resident_gb": resident,
                  "dispatch_peak_memory_gb": peak,
                  "dispatch_gb": {k: v - resident for k, v in peak.items()}})
            for name, lp in outs.items():
                check(bool(torch.isfinite(lp).all()),
                      f"{preset} {name}: non-finite log-probs")
            check(err <= MODEL_TOL, f"{preset} card vs CPU {err} > "
                  f"{MODEL_TOL}")
            check(launches["conv_k3s2_fwd"] > 0,
                  f"{preset}: the conv forward was not launched")
            check((launches["attention_fwd"] == 0) == composed,
                  f"{preset}: attention core launches {launches}")
            check_dense_bf16("topologies", f"{preset} layers.0 ffn",
                             first_dense(bf16), 4 * 1499, gen)
            for k, n in launches.items():
                total[k] += n
            del cpu, gpu, bf16, outs, state, m
            torch.cuda.empty_cache()
    shapes = path_shapes(calls)
    emit({"phase": "topologies_kernel",
          "conv_inputs": [list(x) for x, _ in shapes["conv"]],
          "attention": [[list(s), lens] for s, _, _, lens, _
                        in shapes["attention"]]})
    check(any(s[1] == 16 for s, *_ in shapes["attention"]),
          "no 16-head attention call recorded")
    worst = check_recorded_fwd("topologies_kernel", shapes, gen)
    return total, worst


def npz_hf_dir(npz: str, directory: str) -> tuple:
    """A golden fixture as a ``save_pretrained`` directory: config.json
    and ``model.safetensors`` (an 8-byte header length, the JSON header,
    the raw little-endian bytes). Returns (input, log-probs, config)."""
    blob = np.load(npz)
    os.makedirs(directory, exist_ok=True)
    config = json.loads(bytes(blob["__config_json__"]).decode("utf-8"))
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config, f)
    header, raw = {}, []
    for key in (k for k in blob.files if k.startswith("state::")):
        a = np.ascontiguousarray(blob[key], dtype="<f4")
        start = sum(len(r) for r in raw)
        raw.append(a.tobytes())
        header[key[len("state::"):]] = {
            "dtype": "F32", "shape": list(a.shape),
            "data_offsets": [start, start + len(raw[-1])]}
    text = json.dumps(header).encode()
    with open(os.path.join(directory, "model.safetensors"), "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text + b"".join(raw))
    return blob["__input__"], blob["__log_probs__"], config


HF_TOL = 1e-3  # the card's log-probs against transformers' (f32, CPU)
HF_TRANSCRIBE = "wav2vec2_stable_ln"


def phase_hf_golden(tmp: str) -> dict:
    """The seven committed HF golden fixtures written as
    ``save_pretrained`` directories, loaded through ``load_hf_dir`` onto
    the card: log-probs within HF_TOL of the ones ``transformers``
    computed; then ``cli.transcribe --checkpoint <dir> --dict_file
    vocab.json --device cuda`` on the stable-LN one (its 2-layer tiny
    extractor given to the CLI's config), whose transcript must be the
    CLI's own on the CPU, and not empty. Returns the launch counts."""
    import functools

    from scipy.io import wavfile

    from audio8_tpu_torch.cli import transcribe
    from audio8_tpu_torch.models.convert_hf import (acoustic_config_from_hf,
                                                    load_hf_dir)
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.utils import Offsets

    fixtures = os.path.join(HERE, "tests", "fixtures", "hf_golden")
    reset_launches()
    errs = {}
    for name in sorted(f[:-4] for f in os.listdir(fixtures)
                       if f.endswith(".npz")):
        d = os.path.join(tmp, "hf", name)
        x, want, _ = npz_hf_dir(os.path.join(fixtures, name + ".npz"), d)
        state, report = load_hf_dir(d, ctc="auto")
        check(report["missing"] == [] and report["unexpected"] == [],
              f"{name}: {report['missing'][:3]} {report['unexpected'][:3]}")
        model = Wav2Vec2AcousticModel(acoustic_config_from_hf(
            report["hf_config"], report["topology"])).cuda().eval()
        model.load_state_dict(state, strict=True)
        with torch.inference_mode():
            lp, _ = model(torch.from_numpy(x).cuda())
        errs[name] = float(np.abs(lp.cpu().numpy() - want).max())
        check(errs[name] <= HF_TOL, f"{name}: card vs transformers "
              f"{errs[name]} > {HF_TOL}")
    d = os.path.join(tmp, "hf", HF_TRANSCRIBE)
    x, _, config = npz_hf_dir(os.path.join(fixtures, HF_TRANSCRIBE + ".npz"),
                              d)
    vocab = ["<pad>", "<s>", "</s>", "<unk>", "|"] + list(
        "ETAONIHSRDL")[:config["vocab_size"] - 5]
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    wav = os.path.join(tmp, "hf", "clip.wav")
    wavfile.write(wav, SR, (np.clip(x[0], -1, 1) * 32767).astype(np.int16))
    conv = tuple(zip(config["conv_dim"], config["conv_kernel"],
                     config["conv_stride"]))
    flags = ["--d_model", str(config["hidden_size"]), "--num_heads",
             str(config["num_attention_heads"]), "--num_layers",
             str(config["num_hidden_layers"]), "--d_ff",
             str(config["intermediate_size"]), "--pre_norm", "true",
             "--extractor_mode", "layer", "--conv_bias", "true"]
    real = transcribe.AcousticConfig
    transcribe.AcousticConfig = functools.partial(
        real, custom_conv_features=conv)
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    texts = {}
    try:
        for device in ("cuda", "cpu"):
            with contextlib.redirect_stdout(io.StringIO()):
                texts[device] = transcribe.main([
                    "--checkpoint", d, "--dict_file",
                    os.path.join(d, "vocab.json"), "--device", device,
                    *flags, wav])[0][1]
    finally:
        transcribe.AcousticConfig = real
        Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
        Offsets.VALUES[:] = saved[4]
    launches = read_launches()
    emit({"phase": "hf_golden", "families": errs, "tol": HF_TOL,
          "transcribe": {"checkpoint": HF_TRANSCRIBE, **texts},
          "launches": {k: launches[k] for k in TOPO_PATH}})
    check(texts["cuda"] == texts["cpu"] and texts["cuda"],
          f"transcribe on the HF dir: card {texts['cuda']!r}, CPU "
          f"{texts['cpu']!r}")
    for k in TOPO_PATH:
        check(launches[k] > 0, f"hf_golden: {k} was not launched")
    return {k: launches[k] for k in TOPO_PATH}


@contextlib.contextmanager
def recorded_ctc_calls(calls: list):
    """Every CTC loss the CTC steps take, noted as (log-probs shape, input
    lengths, target lengths)."""
    import audio8_tpu_torch.train.steps as steps

    real = steps.ctc_loss

    def ctc(lp, il, tg, tl, **kw):
        calls.append((tuple(lp.shape), il.tolist(), tl.tolist()))
        return real(lp, il, tg, tl, **kw)

    steps.ctc_loss = ctc
    try:
        yield calls
    finally:
        steps.ctc_loss = real


def phase_lv60_train(tmp: str, seed: int, gen) -> tuple:
    """``cli.pretrain --preset large-lv60`` for 2 steps (the conv bias and
    the layer-mode norms through kernels 3b and 3c), then ``cli.train
    --preset large-lv60 --layer_drop 0.1 --restart_from`` its ``.pt`` for
    4 steps in f32 and in bf16; one unfrozen step card vs CPU at the same
    weights (``layer_drop`` 0, the train_vs_cpu gates); kernels 1, 2,
    2b, 3, 3b, 3c, 4 and 5 against their plain versions at every shape
    the runs gave them. Returns the launch counts, the max errors and the
    pretraining batches' (rows, samples)."""
    from audio8_tpu_torch.cli import pretrain
    from audio8_tpu_torch.cli.train import train

    card = card_name()
    pre_calls, calls, ctc_calls = {}, {}, []
    run = os.path.join(tmp, "lv60_pretrain")
    argv = ["--manifest_dir", os.path.join(tmp, "pretrain_corpus"),
            "--basedir", run, "--device", "cuda", *LV60_PRETRAIN_FLAGS]
    reset_launches()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    with recorded_path_calls(pre_calls):
        state = pretrain.train(argv)
    pre_peak = torch.cuda.max_memory_allocated() / 1e9
    pre_launches = read_launches()
    log = state.log
    check(state.step == 2 and all(math.isfinite(r["loss"]) for r in log),
          f"lv60 pretrain: {[r['loss'] for r in log]}")
    for k in ("conv_k3s2_dgrad", "conv_k3s2_wgrad"):
        check(pre_launches[k] > 0, f"lv60 pretrain: {k} not launched")
    batches = sorted({(r["rows"], r["samples"]) for r in log})
    emit({"phase": "lv60_train", "run": "pretrain", "card": card,
          "flags": LV60_PRETRAIN_FLAGS,
          "params": sum(p.numel() for p in state.params),
          "step_seconds": [r["seconds"] for r in log],
          "rows": [r["rows"] for r in log],
          "samples": [r["samples"] for r in log],
          "losses": [r["loss"] for r in log],
          "launches": {k: pre_launches[k] for k in PRETRAIN_PATH},
          "peak_memory_gb": pre_peak})
    ckpt = os.path.join(run, "checkpoint-step-1.pt")
    check(os.path.exists(ckpt), f"lv60 pretrain wrote {os.listdir(run)}")
    del state
    torch.cuda.empty_cache()
    corpus = os.path.join(tmp, "corpus")
    train_launches = {k: 0 for k in LV60_PATH}
    with recorded_path_calls(calls), recorded_ctc_calls(ctc_calls):
        for dtype_flag in ([], ["--bf16"]):
            reset_launches()
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            state = train(["--root_dir", corpus, "--train_dataset",
                           "train.tsv", "--valid_dataset", "valid.tsv",
                           "--basedir", os.path.join(tmp, "lv60_run" + (
                               "_bf16" if dtype_flag else "")),
                           "--device", "cuda", "--restart_from", ckpt,
                           *LV60_TRAIN_FLAGS, *dtype_flag])
            launches = read_launches()
            log = state.log
            check(state.step == 4 and all(math.isfinite(r["loss"])
                                          for r in log),
                  f"lv60 train {dtype_flag}: {[r['loss'] for r in log]}")
            emit({"phase": "lv60_train", "run": "train" + (
                      "_bf16" if dtype_flag else ""), "card": card,
                  "flags": LV60_TRAIN_FLAGS + dtype_flag,
                  "step_seconds": [r["seconds"] for r in log],
                  "frozen": [r["frozen"] for r in log],
                  "losses": [r["loss"] for r in log],
                  "launches": {k: launches[k] for k in LV60_PATH},
                  "peak_memory_gb":
                      torch.cuda.max_memory_allocated() / 1e9})
            for k in LV60_PATH:
                if k not in ("conv_k3s2_dgrad", "conv_k3s2_wgrad"):
                    check(launches[k] > 0, f"lv60 train: {k} not launched")
                train_launches[k] += launches[k]
            params = [tuple(p.shape) for p in state.params]
            del state
            torch.cuda.empty_cache()
    for k in ("conv_k3s2_dgrad", "conv_k3s2_wgrad"):
        train_launches[k] += pre_launches[k]
    phase_train_vs_cpu(seed, phase="lv60_vs_cpu", **LV60_SIZE)
    for k in ("conv", "attention", "dropout"):
        calls[k] += pre_calls[k]
    shapes = path_shapes(calls)
    worst = phase_path_kernels("lv60_train", shapes, params, gen)
    worst.update({"ctc_loss": 0.0, "conv_k3s2_dgrad": 0.0,
                  "conv_k3s2_wgrad": 0.0})
    for shape, il, tl in sorted(set((s, tuple(i), tuple(t))
                                    for s, i, t in ctc_calls)):
        worst["ctc_loss"] = max(worst["ctc_loss"], check_ctc(
            "lv60_train_kernel", shape, list(il), list(tl), gen))
    for dtype in (torch.float32, torch.bfloat16):
        for x_shape, w_shape in path_shapes(pre_calls)["conv"]:
            errs = check_conv_bwd("lv60_train_kernel", x_shape[0],
                                  x_shape[1], w_shape[1], w_shape[2], dtype,
                                  gen)
            if dtype == torch.float32:
                for k, e in errs.items():
                    worst[k] = max(worst[k], e)
        torch.cuda.empty_cache()
    return train_launches, worst, batches


def phase_lv60_block(tmp: str, batches, seed: int, gen) -> tuple:
    """The attention block (kernels 6 and 6b) at d_model 1024 under
    pre-norm: ``make_pretrain_steps`` with ``fused_attention="block"`` on
    the LV-60 pretraining model from the lv60 run's ``.pt`` at its
    batches' shapes (24 block forwards and backwards per step, no core
    launch; step ms), then the block against its plain versions at those
    shapes, f32 and bf16. Returns the launch counts and max errors."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.convert import load_fairseq_pretrained
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    weights = load_fairseq_pretrained(os.path.join(
        tmp, "lv60_pretrain", "checkpoint-step-1.pt"))
    cfg = PretrainConfig(final_dim=weights["final_proj.weight"].shape[0],
                         num_vq_vars=weights["quantizer.vars"].shape[0] // 2,
                         fused_attention="block", **LV60_SIZE)
    model = Wav2Vec2Model(cfg).cuda()
    model.load_state_dict(weights)
    state = TrainState(model, create_optimizer(create_lrs(
        2e-4, 100, "constant", warmup_steps=0), weight_decay=0.01))
    train_step = make_pretrain_steps(model)[0]
    rng = np.random.default_rng(seed + 14)
    cpu_gen = torch.Generator().manual_seed(seed + 14)
    reset_launches()
    ms = []
    for rows, n in batches * LV60_BLOCK_STEPS:
        x = torch.from_numpy(np.stack([synthetic_speechlike(
            (n + 1) / SR, rng)[:n] for _ in range(rows)])).cuda()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        _, m = train_step(state, x, PretrainSeeds.draw(cpu_gen), cpu_gen)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        check(math.isfinite(float(m["loss"])), "lv60 block: non-finite loss")
    launches = read_launches()
    steps = len(batches) * LV60_BLOCK_STEPS
    layers = cfg.num_layers
    check(launches["attention_block"] == layers * steps
          and launches["attention_block_bwd"] == layers * steps
          and launches["attention_fwd"] == 0,
          f"lv60 block launches {launches} over {steps} steps")
    del state, model, train_step
    torch.cuda.empty_cache()
    worst = {"attention_block": 0.0, "attention_block_bwd": 0.0}
    for rows, n in batches:
        frames = pretrain_path_shapes(rows, n)[1]
        for dtype in (torch.float32, torch.bfloat16):
            f, b = check_block("lv60_block", rows, frames, 1024, 16, None,
                               dtype, gen)
            if dtype == torch.float32:
                worst["attention_block"] = max(worst["attention_block"], f)
                worst["attention_block_bwd"] = max(
                    worst["attention_block_bwd"], b)
            torch.cuda.empty_cache()
    emit({"phase": "lv60_block", "card": card_name(),
          "config": "large-lv60 d1024 h16 L24 ff4096, pre-norm, "
          "fused_attention='block', f32",
          "batches": [list(b) for b in batches], "step_event_ms": ms,
          "launches": {k: launches[k] for k in BLOCK_PATH}})
    return {k: launches[k] for k in BLOCK_PATH}, worst


@contextlib.contextmanager
def cuda_profiled():
    """torch.profiler over CUDA activity, warmed up before the block: a
    trace loses the kernels that run while the profiler is still taking
    its buffers (a first launch waits about 2 ms for them), so four spin
    kernels (``torch.cuda._sleep``) are launched and waited for first.
    The block's kernels follow them; :func:`cuda_spans` leaves the spin
    kernels it does not ask for out."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        yield prof


def cuda_spans(prof, spins: bool = False) -> list:
    """(start, end, name) of the traced CUDA kernels and memsets, sorted,
    in µs; without the spin kernels unless ``spins``."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and (spins or "spin_kernel" not in e.name))


def traced_ms(fn, budget: bool = True) -> dict:
    """Device ms of one call of ``fn`` by kernel name: the durations of
    the CUDA kernels (and memsets) that torch.profiler traces over up to
    10 calls (as many as fit in about 0.2 s after a first, untraced
    call), divided by the number of calls. The host's launch cost, which
    exceeds the device time for a small kernel or SDPA's bf16 autograd,
    is not in it. The trace is warmed up (:func:`cuda_profiled`): a cold
    trace loses the kernels of its first calls, so short timings read
    low (an f32 attention core forward 0.745 ms cold against 0.957
    warmed, AdamW 0.618 against 0.827, on an H100 80GB HBM3 at 700 W)
    or come back empty. Every timed function launches kernels,
    so a trace that holds none is taken again, up to eight times, the
    pause before each retry doubling from 0.25 s (about 32 s in all),
    while the run's timing pauses stay within RETRY_BUDGET_S (a route
    check, not a timing, passes ``budget=False``)."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = max(1, min(10, int(0.2 / (time.perf_counter() - t0))))
    for attempt in range(8):
        if attempt:
            pause = 0.25 * 2 ** (attempt - 1)
            if budget:
                if RETRY_PAUSED["s"] + pause > RETRY_BUDGET_S:
                    break
                RETRY_PAUSED["s"] += pause
            count_retry()
            time.sleep(pause)
        with cuda_profiled() as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for a, b, name in cuda_spans(prof):
            out[name] = out.get(name, 0.0) + (b - a) / 1e3 / calls
        if out:
            return out
    raise EmptyTrace("torch.profiler traced no CUDA kernel of a timed call")


class EmptyTrace(RuntimeError):
    pass


# the seconds a full run may pause between profiler retries, and what it
# has paused so far: it bounds the timing phase whatever the profiler does
RETRY_BUDGET_S = 120.0
RETRY_PAUSED = {"s": 0.0}


def traced_or_none(fn) -> dict:
    """:func:`traced_ms`, or ``{}`` with a ``timing_note`` line when the
    profiler keeps returning empty traces: for the splits by launch, which
    a run can report without."""
    try:
        return traced_ms(fn)
    except EmptyTrace:
        emit({"phase": "timing_note", "function": getattr(
            fn, "__qualname__", repr(fn)), "split_by_launch": None})
        return {}


def device_ms(fn) -> float:
    """:func:`timed_device_ms`'s time alone."""
    return timed_device_ms(fn)[0]


def timed_device_ms(fn) -> tuple:
    """Device time of one call of ``fn`` (:func:`traced_ms`, summed) and
    ``"trace"``. If the profiler keeps returning empty traces, the
    CUDA-event time of 10 calls instead, which also holds the host's
    launch gaps, and ``"events"``; a ``timing_note`` line names the
    function."""
    try:
        return sum(traced_ms(fn).values()), "trace"
    except EmptyTrace:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(10):
            fn()
        e1.record()
        torch.cuda.synchronize()
        emit({"phase": "timing_note", "function": getattr(
            fn, "__qualname__", repr(fn)), "timed_by": "cuda_events"})
        return e0.elapsed_time(e1) / 10, "events"


def bound(flops: float, nbytes: float, dtype=torch.float32):
    """Least time on the card (ms) and what sets it: the bytes the function
    must move over HBM, or its operations over the dtype's peak."""
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def in_turns(kern, plain, library=None) -> dict:
    """Device times (:func:`timed_device_ms`) in turns: plain, kernel,
    [library], kernel, plain, [library]; ``timed_by`` says for each time
    whether both its readings came from traces ("trace"), both from CUDA
    events ("events"), or one of each ("trace+events");
    ``trace_retries`` counts the readings' retried traces."""
    retried = sum(TRACE_RETRIES.values())
    p1, k1 = timed_device_ms(plain), timed_device_ms(kern)
    l1 = timed_device_ms(library) if library else None
    k2, p2 = timed_device_ms(kern), timed_device_ms(plain)
    l2 = timed_device_ms(library) if library else None

    def source(a, b):
        return a[1] if a[1] == b[1] else "trace+events"

    return {"ms": (k1[0] + k2[0]) / 2, "plain_ms": (p1[0] + p2[0]) / 2,
            "library_ms": None if library is None else (l1[0] + l2[0]) / 2,
            "ms_runs": [k1[0], k2[0]], "plain_ms_runs": [p1[0], p2[0]],
            "library_ms_runs": None if library is None else [l1[0], l2[0]],
            "timed_by": {"ms": source(k1, k2), "plain_ms": source(p1, p2),
                         "library_ms": None if library is None
                         else source(l1, l2)},
            "trace_retries": sum(TRACE_RETRIES.values()) - retried}


def gemm_caller(name: str):
    """The kernel whose product a traced kernel of the TMA-fed GEMM
    (``csrc/tma_gemm.cuh``) ran, from the port's one table keyed by the A
    operand's recipe (``profile.py:gemm_caller``), or None: any other
    kernel, or a tree without that table (an older tree timed in
    turns)."""
    import importlib

    rule = getattr(importlib.import_module("audio8_tpu_torch.profile"),
                   "gemm_caller", None)
    return None if rule is None else rule(name)


def core_route_of(name: str):
    """The route of a traced attention-forward kernel, or None."""
    if "attention_fwd" not in name or "kernel" not in name:
        return None
    if "wgmma" in name:
        return "wgmma"
    return "mma.sync" if "bf16_mma" in name else "simt"


def wgrad_route_of(name: str):
    """The route of a traced wgrad GEMM kernel, or None."""
    if gemm_caller(name) == "conv_k3s2_wgrad":
        return "wgmma"
    for key, route in (("wgrad_bf16_mma_kernel", "mma.sync"),
                       ("wgrad_f32_kernel", "simt")):
        if key in name:
            return route
    return None


def dgrad_route_of(name: str):
    """The route of a traced dgrad GEMM kernel, or None."""
    if gemm_caller(name) == "conv_k3s2_dgrad":
        return "wgmma"
    for key, route in (("dgrad_bf16_mma_kernel", "mma.sync"),
                       ("dgrad_f32_kernel", "simt")):
        if key in name:
            return route
    return None


def split_by(fn, parts, route_of) -> dict:
    """Device ms of one call of ``fn`` by launch (``parts``: (label, key
    in the kernel name) in order, or a function from the traced kernel
    names to {name: label}; anything else PyTorch's ``rest``), the routes its kernels ran (read from their names) and the
    host's ms per call beside the CUDA-event ms."""
    by_name = traced_or_none(fn)
    if callable(parts):
        label = parts(list(by_name))
    else:
        label = {n: next((p for p, key in parts if key in n), "rest")
                 for n in by_name}
    split = {}
    for n, ms in by_name.items():
        part = label.get(n, "rest")
        split[part] = split.get(part, 0.0) + ms
    return {"launch_ms": split,
            "routes": sorted({route_of(n) for n in by_name} - {None}),
            **host_ms(fn)}


def mirrored_route(module: str, fn: str, *args):
    """A route from the port's Python mirror of a kernel's rule, or None
    in a tree that has no such mirror (an older tree timed in turns)."""
    import importlib

    rule = getattr(importlib.import_module(module), fn, None)
    return None if rule is None else rule(*args)


def time_attention_fwd(dtype, gen) -> dict:
    """The forward at the serving shape in both semantics ("xla", the
    default paths', and "/kernel"); the yardstick is
    scaled_dot_product_attention (no dropout). Each row also splits the
    device time by launch, names the route the core ran and gives the
    host's ms per call."""
    import torch.nn.functional as F

    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_plain)

    out = {}
    q, k, v, kv = attn_inputs(dtype, gen)
    mask = kv[:, None, None, :]
    b, h, t, dh = ATTN_SHAPE
    for xla, name in ((True, "attention_fwd"), (False, "attention_fwd/kernel")):
        sem = dict(xla=xla, bf16_softmax=True)

        def kern():
            return attention_core(q, k, v, kv, 0.125, **sem)

        r = in_turns(kern,
                     lambda: attention_core_plain(q, k, v, kv, 0.125, **sem),
                     lambda: F.scaled_dot_product_attention(q, k, v, mask))
        r["bound_ms"], r["bound_by"] = bound(4.0 * b * h * t * t * dh,
                                             4 * q.numel() * q.element_size()
                                             + kv.numel(), dtype)
        r.update(split_by(kern, (("core", "attention_fwd"),), core_route_of))
        r["route"] = mirrored_route("audio8_tpu_torch.ops.attention",
                                    "attention_route", dtype, dh, True)
        out[name] = r
    return out


def time_attention(dtype, gen) -> dict:
    """Forward at the serving shape (:func:`time_attention_fwd`), backward
    at the training shape (the kernels line reports both in "xla"
    semantics, the default paths'), and both in the TPU kernel's
    semantics ("/kernel"), the backward also at the pretraining shape
    ("/pretrain"); the yardstick is scaled_dot_product_attention and its
    autograd (no dropout). Each backward row also splits the kernel's
    time by launch (``launch_ms``: the D prepass, the fused pass, the dq
    reduction)."""
    import torch.nn.functional as F

    from audio8_tpu_torch.ops.attention import (_forward_kernel,
                                                attention_core_bwd,
                                                attention_core_bwd_plain)

    out = time_attention_fwd(dtype, gen)
    for shape, lengths, tag in ((TRAIN_ATTN_SHAPE, TRAIN_ATTN_LENGTHS, ""),
                                (PRETRAIN_ATTN_SHAPE, None, "/pretrain")):
        b, h, t, dh = shape
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen)
                       .to(dtype) for _ in range(4))
        kv = None if lengths is None else (
            torch.arange(t, device="cuda")[None, :]
            < torch.tensor(lengths, device="cuda")[:, None])
        qg, kg, vg = (x.requires_grad_() for x in (q.clone(), k.clone(),
                                                   v.clone()))
        ref = F.scaled_dot_product_attention(
            qg, kg, vg, None if kv is None else kv[:, None, None, :])
        for xla, sem in ((True, ""), (False, "/kernel")):
            sem_kw = dict(xla=xla, bf16_softmax=True)
            _, stats, o32 = _forward_kernel(q, k, v, kv, 0.125, 0.0, 0, True,
                                            **sem_kw)
            def kern():
                attention_core_bwd(q, k, v, o32, stats, kv, 0.125, 0.0, 0,
                                   do, **sem_kw)

            r = in_turns(
                kern,
                lambda: attention_core_bwd_plain(q, k, v, kv, 0.125, 0.0, 0,
                                                 do, **sem_kw),
                lambda: torch.autograd.grad(ref, (qg, kg, vg), do,
                                            retain_graph=True))
            by_name = traced_or_none(kern)
            r["launch_ms"] = {
                part: sum(ms for n, ms in by_name.items() if key in n)
                for part, key in (("rowdot", "rowdot_kernel"),
                                  ("fused_pass", "attention_bwd_"),
                                  ("dq_reduce", "dq_reduce_kernel"))
            } if by_name else {}
            # recompute S, then dP, dV, dK, dQ: five T x T x dh products
            # per head; reads q, k, v, o, dO and writes dq, dk, dv
            r["bound_ms"], r["bound_by"] = bound(
                10.0 * b * h * t * t * dh, 8 * q.numel() * q.element_size(),
                dtype)
            r["shape"] = list(shape)
            out["attention_bwd" + tag + sem] = r
            del stats, o32
        del q, k, v, do, qg, kg, vg, ref
    return out


def block_launch(name: str, rest: str) -> str:
    """Which launch of the attention block a traced kernel is, from its
    name: the GEMMs by their operand and epilogue types (the same on every
    route), the cores by their kernels; anything else is PyTorch's work in
    the wrapper, labelled ``rest``."""
    if "attention_fwd" in name:
        return "core_fwd"
    for key, part in (("rowdot_kernel", "D"), ("dq_reduce_kernel", "dq_sum"),
                      ("attention_bwd_", "fused_pass"),
                      ("bias_partials_kernel", "bias_partials")):
        if key in name:
            return part
    if "blockgemm" in name or gemm_caller(name) == "attention_block_gemm":
        if "Partial" in name:
            return ("dWo" if name.find("RowCols") < name.find("HeadRows")
                    else "dWqkv")
        out = "HeadOut" in name
        if "WeightRows" in name:
            return "qkv" if out else "o_proj"
        if "WeightCols" in name:
            return "dxo" if out else "dx"
    return rest


def gemm_route_of(name: str):
    """The GEMM route a traced kernel of the block ran, or None."""
    if gemm_caller(name) == "attention_block_gemm":
        return "wgmma"
    for key, route in (("blockgemm::gemm_bf16_mma_kernel", "mma.sync"),
                       ("blockgemm::gemm_kernel", "simt")):
        if key in name:
            return route
    return None


def launch_split(fn, rest: str) -> dict:
    """Device ms of one call of ``fn`` by block launch (PyTorch's kernels
    in the wrapper as ``rest``), and the GEMM routes its kernels ran."""
    by_name = traced_or_none(fn)
    split = {}
    for n, ms in by_name.items():
        part = block_launch(n, rest)
        split[part] = split.get(part, 0.0) + ms
    routes = sorted({gemm_route_of(n) for n in by_name} - {None})
    return {"launch_ms": split, "gemm_routes": routes}


def host_ms(fn, calls: int = 20) -> dict:
    """The host's ms per call of ``fn`` (enqueue, no synchronisation)
    against the CUDA-event ms per call over the same calls: where the two
    agree and exceed the device time, the host sets the pace."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    e1.record()
    torch.cuda.synchronize()
    return {"host_ms": host, "event_ms": e0.elapsed_time(e1) / calls}


def time_block(dtype, gen, backward: bool = True) -> dict:
    """Forward and (unless not ``backward``) backward at the pretraining
    batches' shape (20, 222, 768), 12 heads, no mask; the yardstick is F.multi_head_attention_
    forward (dropout 0, need_weights off, so it runs cuBLAS and SDPA) and
    its autograd. Each row also splits the kernel's device time by launch
    (``launch_ms``), names the GEMM route its kernels ran, and gives the
    host's ms per call beside the CUDA-event ms."""
    import torch.nn.functional as F

    from audio8_tpu_torch.ops.attention_block import (
        attention_block, attention_block_bwd_plain, attention_block_plain)

    b, t, d, h = 20, 222, 768, BLOCK_HEADS
    x, weights = block_inputs(b, t, d, dtype, gen)
    dy = torch.randn(b, t, d, device="cuda", generator=gen).to(dtype)
    scale = (d // h) ** -0.5
    wq, bq, wk, bk, wv, bv, wo, bo = weights
    lib = [torch.cat([wq, wk, wv]), torch.cat([bq, bk, bv]), wo, bo]

    def library(xx, w_in, b_in, w_out, b_out):
        q = xx.transpose(0, 1)
        return F.multi_head_attention_forward(
            q, q, q, d, h, w_in, b_in, None, None, False, 0.0, w_out, b_out,
            training=False, need_weights=False)[0]

    def fwd():
        return attention_block(x, *weights, None, h, scale)

    out = {}
    r = in_turns(fwd,
                 lambda: attention_block_plain(x, *weights, None, h, scale),
                 lambda: library(x, *lib))
    esize = x.element_size()
    proj = 2.0 * b * t * d * d
    core = 4.0 * b * h * t * t * (d // h)
    r["bound_ms"], r["bound_by"] = bound(
        4 * proj + core, (2 * x.numel() + 4 * d * d + 4 * d) * esize, dtype)
    r.update(launch_split(fwd, "key_mask"))
    r.update(host_ms(fwd))
    out["attention_block"] = r
    if not backward:
        return out
    xs = [a.detach().requires_grad_() for a in (x, *weights)]
    o = attention_block(*xs, None, h, scale)
    ls = [a.detach().requires_grad_() for a in (x, *lib)]
    lo = library(*ls)

    def bwd():
        return torch.autograd.grad(o, xs, dy, retain_graph=True)

    r = in_turns(
        bwd,
        lambda: attention_block_bwd_plain(x, *weights, None, h, scale, 0.0, 0,
                                          dy),
        lambda: torch.autograd.grad(lo, ls, dy.transpose(0, 1),
                                    retain_graph=True))
    # dxo, dWo, dW{q,k,v}, dx: 16 B T D^2; the core's recomputed scores
    # and its four products: 10 B H T^2 dh. Reads x, dout, the weights;
    # writes dx and the weight and bias gradients
    r["bound_ms"], r["bound_by"] = bound(
        8 * proj + 2.5 * core,
        (3 * x.numel() + 8 * d * d + 8 * d) * esize, dtype)
    r.update(launch_split(bwd, "sum_partials"))
    r.update(host_ms(bwd))
    out["attention_block_bwd"] = r
    return out


def conv_fwd_route_of(name: str):
    """The route of a traced k3s2 forward kernel, or None: the wgmma
    route is the TMA-fed GEMM on the forward's tap operand."""
    if gemm_caller(name) == "conv_k3s2_fwd":
        return "wgmma"
    for key, route in (("conv_k3s2_fwd_bf16_mma_kernel", "mma.sync"),
                       ("conv_k3s2_fwd_f32_kernel", "simt"),
                       ("conv_k3s2_fwd_kernel<", "generic")):
        if key in name:
            return route
    return None


def time_conv(dtype, gen) -> dict:
    """The four k3s2 layers of one (4, 30 s) block; the yardstick is
    cuDNN's conv1d on channel-first copies of the same inputs. The row
    also gives each layer's device ms beside cuDNN's for the same layer
    (``layer_ms``, ``layer_library_ms``), the route its kernels ran (read
    from their names; ``route``: the tree's Python rule, null in a tree
    without one) and the host's ms per four-layer call."""
    import torch.nn.functional as F

    from audio8_tpu_torch.ops.conv import conv1d_k3s2, conv1d_k3s2_plain

    convs = [conv_inputs(sh, dtype, gen) for sh in CONV_SHAPES]
    cf = [(x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous())
          for x, w in convs]

    def kern():
        return [conv1d_k3s2(x, w) for x, w in convs]

    r = in_turns(kern, lambda: [conv1d_k3s2_plain(x, w) for x, w in convs],
                 lambda: [F.conv1d(x, w, stride=2) for x, w in cf])
    flops = sum(2.0 * CHUNK_BATCH * ((t - 3) // 2 + 1) * 3 * ci * co
                for t, ci, co in CONV_SHAPES)
    nbytes = sum((x.numel() + w.numel() + CHUNK_BATCH * ((t - 3) // 2 + 1)
                  * co) * x.element_size()
                 for (x, w), (t, _, co) in zip(convs, CONV_SHAPES))
    r["bound_ms"], r["bound_by"] = bound(flops, nbytes, dtype)
    r["layer_ms"], r["layer_library_ms"] = [], []
    for (x, w), (xc, wc) in zip(convs, cf):
        r["layer_ms"].append(device_ms(lambda x=x, w=w: conv1d_k3s2(x, w)))
        r["layer_library_ms"].append(device_ms(
            lambda xc=xc, wc=wc: F.conv1d(xc, wc, stride=2)))
    r.update(split_by(kern, (("gemm", "conv_k3s2_fwd"),
                             ("gemm", "TmaTapCols")), conv_fwd_route_of))
    _, c_in, c_out = CONV_SHAPES[0]
    r["route"] = mirrored_route("audio8_tpu_torch.ops.conv", "fwd_route",
                                dtype, c_in, c_out, True)
    return {"conv_k3s2_fwd": r}


def time_ctc(gen) -> dict:
    """Loss and gradient at the training shape; the yardstick is
    F.ctc_loss (forward and backward)."""
    import torch.nn.functional as F

    from audio8_tpu_torch.ops.ctc import ctc_loss, ctc_loss_plain

    lp, il, tg, tl = ctc_inputs(CTC_SHAPE, CTC_INPUT_LENGTHS,
                                CTC_TARGET_LENGTHS, gen)
    lpg = lp.detach().requires_grad_()
    flat = torch.cat([tg[i, :n] for i, n in enumerate(CTC_TARGET_LENGTHS)])

    def kern():
        torch.autograd.grad(ctc_loss(lpg, il, tg, tl, 0, "sum"), lpg)

    def library():
        loss = F.ctc_loss(lpg.transpose(0, 1), flat, il, tl, blank=0,
                          reduction="sum", zero_infinity=True)
        torch.autograd.grad(loss, lpg)

    def plain():  # the scan on the card, autograd backward
        loss = ctc_loss_plain(lpg, il, tg, tl, 0)
        loss = torch.where(loss >= 5e29, torch.zeros_like(loss), loss)
        torch.autograd.grad(loss.sum(), lpg)

    r = in_turns(kern, plain, library)
    # the launches: the recursion (alpha and beta), the one CTC kernel
    # that a forward without a gradient also launches, and the pass that
    # writes the gradient, any other CTC kernel; the rest is PyTorch's
    # (the sum, zero_infinity's select)
    def forward():
        with torch.no_grad():
            ctc_loss(lp, il, tg, tl, 0, "sum")

    recursion = {n for n in traced_or_none(forward) if "ctc_" in n}
    r.update(split_by(kern, lambda names: {
        n: "recursion" if n in recursion else "finish"
        for n in names if "ctc_" in n}, lambda name: None))
    b, t, v = CTC_SHAPE
    # the live (t, s) of this run's rows: frames t < input_length, states
    # s < 2 U_b + 1; per live (t, s) the alpha and the beta update (2
    # exp2, 1 log2, ~8 adds, compares and selects each) and dE (1 exp2, 4
    # adds); reads the log-probs once, writes the gradient once
    live = sum(n * (2 * u + 1) for n, u in zip(CTC_INPUT_LENGTHS,
                                                CTC_TARGET_LENGTHS))
    r["bound_ms"], r["bound_by"] = bound(live * (2 * 11 + 5),
                                         2 * lp.numel() * 4)
    # the T dependent steps of the alpha and beta sweeps, which run at
    # the same time on two SMs: each step at least issues its live
    # states' 3 MUFU operations at 16 per cycle (3 S / 16 cycles), one
    # shared-memory round trip (about 30 cycles) and one barrier (about
    # 20), at 1.98 GHz: an estimate, not a measurement
    s_max = 2 * max(CTC_TARGET_LENGTHS) + 1
    r["chain_floor_ms_estimate"] = (max(CTC_INPUT_LENGTHS)
                                    * (3 * s_max / 16 + 50) / 1.98e9 * 1e3)
    return {"ctc_loss": r}


def time_adamw(gen) -> dict:
    """One update of every wav2vec2-base leaf; the yardstick is
    torch.optim.AdamW(fused=True).step() on copies of the same tensors."""
    from audio8_tpu_torch.ops.adamw import adamw_update, adamw_update_plain

    shapes = model_shapes()
    p, g, m, v = adamw_leaves(shapes, gen)
    scale = torch.tensor(1.0, device="cuda")
    args = (scale, 1e-5, 0.9, 0.999, 1e-8, 0.01, 10.0, 1000.0)
    params = [torch.nn.Parameter(x.clone()) for x in p]
    for prm, x in zip(params, g):
        prm.grad = x
    opt = torch.optim.AdamW(params, lr=1e-5, weight_decay=0.01, fused=True)
    r = in_turns(lambda: adamw_update(p, g, m, v, *args),
                 lambda: adamw_update_plain(p, g, m, v, *args), opt.step)
    n = sum(x.numel() for x in p)
    r["bound_ms"], r["bound_by"] = bound(12.0 * n, 28.0 * n)
    r["elements"] = n
    return {"adamw": r}


def conv_bwd_layers(dtype, gen) -> list:
    """(T_in, x, w, dy) of the four k3s2 layers of (4, 15 s)."""
    return [(t,) + conv_bwd_inputs(4, t, ci, co, dtype, gen)
            for t, ci, co in TRAIN_CONV_SHAPES]


def conv_flops(layers) -> float:
    return sum(2.0 * dy.shape[0] * dy.shape[1] * 3 * x.shape[2] * dy.shape[2]
               for _, x, _, dy in layers)


def launch_sequence_ms(fn, keep, calls: int = 6) -> list:
    """Device ms of each launch of the kernels whose names ``keep``
    accepts in one call of ``fn``, in launch order: the kernels
    torch.profiler traces over ``calls`` calls (after a first, untraced
    one), each call behind a one-element fill that marks where it starts;
    the calls whose launches the trace holds in full (the most common
    count: the profiler now and then loses kernels, mostly early in a
    trace) are averaged launch by launch. [] and a ``timing_note`` line
    when no two calls agree."""
    marker = torch.empty(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            marker.fill_(0.0)
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    runs, run = [], None
    for e in evs:
        if keep(e.name):
            if run is not None:
                run.append(e)
        elif "fill" in e.name.lower():
            run = []
            runs.append(run)
    counts = [len(r) for r in runs]
    n = max(set(counts), key=counts.count) if counts else 0
    ref = [e.name for e in next((r for r in runs if len(r) == n), [])]
    full = [r for r in runs if [e.name for e in r] == ref]
    if n == 0 or len(full) < 2:
        emit({"phase": "timing_note", "function": getattr(
            fn, "__qualname__", repr(fn)), "launch_counts_traced": counts})
        return []
    return [sum(r[j].time_range.end - r[j].time_range.start for r in full)
            / len(full) / 1e3 for j in range(n)]


def time_conv_bwd(dtype, gen) -> dict:
    """dgrad and wgrad (:func:`time_wgrad`) of the four k3s2 layers of (4,
    15 s); the yardstick is torch.nn.grad.conv1d_input (cuDNN) on
    channel-first copies of the same inputs. The dgrad row also gives each
    layer's device ms beside cuDNN's (``layer_ms``,
    ``layer_library_ms``), splits the device time by launch (the GEMMs,
    PyTorch's copies; ``launch_seq_ms``: each launch in order, on the
    wgmma route each layer's even then odd half), names the route its
    kernels ran (``routes``; ``route``: the tree's Python rule, null in a
    tree without one) and gives the host's ms per four-layer call."""
    from torch.nn import grad as nn_grad

    from audio8_tpu_torch.ops.conv import (conv1d_k3s2_dgrad,
                                           conv1d_k3s2_dgrad_plain)

    layers = conv_bwd_layers(dtype, gen)
    cf = [(x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous(),
           dy.transpose(1, 2).contiguous()) for _, x, w, dy in layers]
    esize = layers[0][1].element_size()

    def kern():
        return [conv1d_k3s2_dgrad(dy, w, t) for t, _, w, dy in layers]

    r = in_turns(
        kern,
        lambda: [conv1d_k3s2_dgrad_plain(dy, w, t) for t, _, w, dy in layers],
        lambda: [nn_grad.conv1d_input(x.shape, w, dy, stride=2)
                 for x, w, dy in cf])
    r["bound_ms"], r["bound_by"] = bound(
        conv_flops(layers), sum((dy.numel() + w.numel() + x.numel()) * esize
                                for _, x, w, dy in layers), dtype)
    r["layer_ms"] = [device_ms(lambda t=t, w=w, dy=dy:
                               conv1d_k3s2_dgrad(dy, w, t))
                     for t, _, w, dy in layers]
    r["layer_library_ms"] = [device_ms(
        lambda x=x, w=w, dy=dy: nn_grad.conv1d_input(x.shape, w, dy,
                                                     stride=2))
        for x, w, dy in cf]
    r.update(split_by(kern, lambda names: {n: "gemm" for n in names
                                           if dgrad_route_of(n)},
                      dgrad_route_of))
    r["launch_seq_ms"] = launch_sequence_ms(kern, dgrad_route_of)
    _, x, w, dy = layers[0]
    r["route"] = mirrored_route("audio8_tpu_torch.ops.conv", "dgrad_route",
                                dtype, x.shape[2], dy.shape[2])
    del cf
    return {"conv_k3s2_dgrad": r, **time_wgrad(dtype, gen, layers)}


def time_wgrad(dtype, gen, layers=None) -> dict:
    """wgrad of the four k3s2 layers of (4, 15 s); the yardstick is
    torch.nn.grad.conv1d_weight (cuDNN) on channel-first copies of the
    same inputs. The row also splits the device time by launch (the
    GEMM, the sum of its K-slice partials, PyTorch's copies), names the
    GEMM route and gives the host's ms per call."""
    from torch.nn import grad as nn_grad

    from audio8_tpu_torch.ops.conv import (conv1d_k3s2_wgrad,
                                           conv1d_k3s2_wgrad_plain)

    layers = conv_bwd_layers(dtype, gen) if layers is None else layers
    cf = [(x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous(),
           dy.transpose(1, 2).contiguous()) for _, x, w, dy in layers]
    esize = layers[0][1].element_size()

    def kern():
        return [conv1d_k3s2_wgrad(x, dy) for _, x, _, dy in layers]

    r = in_turns(
        kern,
        lambda: [conv1d_k3s2_wgrad_plain(x, dy) for _, x, _, dy in layers],
        lambda: [nn_grad.conv1d_weight(x, w.shape, dy, stride=2)
                 for x, w, dy in cf])
    r["bound_ms"], r["bound_by"] = bound(
        conv_flops(layers), sum((x.numel() + dy.numel()) * esize
                                + w.numel() * 4 for _, x, w, dy in layers),
        dtype)
    r.update(split_by(kern, (("gemm", "wgrad_"), ("gemm", "wgmma_gemm"),
                             ("sum_splits", "sum_splits")), wgrad_route_of))
    _, x, _, dy = layers[0]
    r["route"] = mirrored_route("audio8_tpu_torch.ops.conv", "wgrad_route",
                                dtype, x.shape[2], dy.shape[2])
    return {"conv_k3s2_wgrad": r}


def time_dropout(dtype, gen) -> dict:
    """Forward at the encoder's (4, 749, 768) residual stream; no PyTorch
    call computes hash dropout (F.dropout draws Philox bits)."""
    from audio8_tpu_torch.ops.dropout import fused_dropout, hash_dropout

    x = torch.randn(DROPOUT_SHAPE, device="cuda", generator=gen).to(dtype)
    r = in_turns(lambda: fused_dropout(x, DROPOUT_RATE, DROPOUT_SEED),
                 lambda: hash_dropout(x, DROPOUT_RATE, DROPOUT_SEED))
    # one read and one write per element; the hash's ~12 integer
    # operations per element are far below the card's integer rate
    r["bound_ms"], r["bound_by"] = bound(0.0, 2 * x.numel()
                                         * x.element_size(), dtype)
    return {"dropout": r}


def phase_timing(gen) -> dict:
    """Every kernel in turns with its plain version and its yardstick, at
    its path's shapes; float32 (the path's dtype) and, for the kernels
    that take it, bfloat16."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        found = {**time_conv(dtype, gen), **time_attention(dtype, gen)}
        torch.cuda.empty_cache()
        found.update({**time_conv_bwd(dtype, gen),
                      **time_dropout(dtype, gen)})
        torch.cuda.empty_cache()
        found.update(time_block(dtype, gen))
        if dtype == torch.float32:
            found.update({**time_ctc(gen), **time_adamw(gen)})
        for name, r in found.items():
            emit({"phase": "timing", "kernel": name, "dtype": str(dtype),
                  **r})
            out[(name, dtype)] = r
        torch.cuda.empty_cache()
    return out


REPLACES = {
    "conv_k3s2_fwd": "audio8_tpu/ops/pallas/conv_kernel.py:107",
    "conv_k3s2_dgrad": "audio8_tpu/ops/pallas/conv_kernel.py:154",
    "conv_k3s2_wgrad": "audio8_tpu/ops/pallas/conv_kernel.py:218",
    "attention_fwd": "audio8_tpu/ops/pallas/attention_kernel.py:96",
    "attention_bwd": "audio8_tpu/ops/pallas/attention_kernel.py:109",
    "ctc_loss": "audio8_tpu/ops/pallas/ctc_kernel.py:59",
    "dropout": "audio8_tpu/ops/pallas/dropout_kernel.py:21",
    "adamw": "audio8_tpu/ops/pallas/adamw_kernel.py:32",
    "attention_block": "audio8_tpu/ops/pallas/attention_block_kernel.py:59",
    "attention_block_bwd":
        "audio8_tpu/ops/pallas/attention_block_kernel.py:87",
}
SOURCES = {"conv_k3s2_fwd": "conv_k3s2_fwd.cu",
           "conv_k3s2_dgrad": "conv_k3s2_bwd.cu",
           "conv_k3s2_wgrad": "conv_k3s2_bwd.cu",
           "attention_fwd": "attention_fwd.cu",
           "attention_bwd": "attention_bwd.cu", "ctc_loss": "ctc_loss.cu",
           "dropout": "dropout.cu", "adamw": "adamw.cu",
           "attention_block": "attention_block_fwd.cu",
           "attention_block_bwd": "attention_block_bwd.cu"}
# the run whose launch counts each kernel reports: the slice's own path
# (the block runs only under fused_attention="block"; the CTC loss only on
# the CTC trainer's)
PATH_OF = {"attention_block": "pretrain_block",
           "attention_block_bwd": "pretrain_block", "ctc_loss": "train"}


def print_card() -> None:
    print(card_name(), flush=True)


def block_timing(gen) -> int:
    """The block's timing rows alone (``--block-timing``)."""
    from audio8_tpu_torch.csrc.build import build

    t0 = time.perf_counter()
    build(("attention_block_fwd.cu", "attention_block_bwd.cu"))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "tree": HERE})
    for dtype in (torch.float32, torch.bfloat16):
        for name, r in time_block(dtype, gen).items():
            emit({"phase": "timing", "kernel": name, "dtype": str(dtype),
                  "tree": HERE, **r})
    print_card()
    return 0


def core_timing(gen) -> int:
    """The timing rows of kernels 1 (the CTC loss and gradient at the
    training shape, float32), 2 (the forward at the serving shape in both
    semantics), 3 (the four k3s2 layers of (4, 30 s), each layer beside
    cuDNN's), 3b and 3c (the four k3s2 layers of (4, 15 s)) and 6 (the
    block's forward) alone (``--core-timing``)."""
    from audio8_tpu_torch.csrc.build import build

    t0 = time.perf_counter()
    build(("ctc_loss.cu", "conv_k3s2_fwd.cu", "attention_fwd.cu",
           "conv_k3s2_bwd.cu", "attention_block_fwd.cu"))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "tree": HERE})
    for name, r in time_ctc(gen).items():
        emit({"phase": "timing", "kernel": name, "dtype": "torch.float32",
              "tree": HERE, **r})
    for dtype in (torch.float32, torch.bfloat16):
        rows = dict(time_conv(dtype, gen))
        torch.cuda.empty_cache()
        rows.update({**time_attention_fwd(dtype, gen),
                     **time_conv_bwd(dtype, gen),
                     **time_block(dtype, gen, backward=False)})
        for name, r in rows.items():
            emit({"phase": "timing", "kernel": name, "dtype": str(dtype),
                  "tree": HERE, **r})
        torch.cuda.empty_cache()
    print_card()
    return 0


HOST_CALLS = 200  # calls per host reading


def host_timing() -> int:
    """The host's cost of the kernels' wrappers and the bf16 pretraining
    step (``--host-timing``), for comparing two trees in turns: the host
    us per call (enqueue, no synchronisation; ``host_ms``) of
    ``fused_dropout`` at the encoder's residual stream and of
    ``attention_core`` at the serving shape ("xla", no gradient, and with
    one, which keeps the backward's residuals), then the wall ms of one
    bf16 (20, 71 428-sample) pretraining step (``profile.py``'s
    ``pretrain_profile``, grad and update, median of 5). Drives only the
    wrappers every tree of the port has had since PR 5, so a copy placed
    in another tree's root times that tree."""
    from audio8_tpu_torch.ops.attention import attention_core
    from audio8_tpu_torch.ops.dropout import fused_dropout
    from audio8_tpu_torch.profile import pretrain_profile

    with timed("build"):
        phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(DROPOUT_SHAPE, device="cuda", generator=gen)
    q, k, v = (torch.randn(ATTN_SHAPE, device="cuda", generator=gen)
               for _ in range(3))
    kv = torch.ones(ATTN_SHAPE[0], ATTN_SHAPE[2], dtype=torch.bool,
                    device="cuda")
    qg = q.clone().requires_grad_()
    rows = {"fused_dropout": lambda: fused_dropout(x, 0.1, 7),
            "attention_core": lambda: attention_core(q, k, v, kv, 0.125,
                                                     xla=True),
            "attention_core_grad": lambda: attention_core(qg, k, v, kv,
                                                          0.125, xla=True)}
    out = {}
    for name, fn in rows.items():
        r = host_ms(fn, HOST_CALLS)
        out[name] = {"host_us": r["host_ms"] * 1e3,
                     "event_us": r["event_ms"] * 1e3}
    step = pretrain_profile(torch.bfloat16)
    emit({"phase": "host_timing", "tree": HERE, "calls": HOST_CALLS,
          "wrappers": out, "pretrain_bf16_step_ms": step["step_ms"],
          "pretrain_bf16_idle_share": step["device_idle_share"],
          "card": card_name()})
    print_card()
    return 0


# --test-timing: cli.test over an eval set of TIMING_UTTERANCES FLACs of
# 1.5-15 s, 2.7 words per second, against a trigram ARPA of
# TIMING_LM_SIZES (words, bigrams, trigrams; LibriSpeech's LM vocabulary
# has 200 000 words), at cli.test's defaults (--beam 8 with the LM)
TIMING_UTTERANCES, TIMING_REPS = 320, 3
TIMING_LM_SIZES = (200_000, 1_000_000, 1_000_000)


def zipf_words(rng, n: int):
    """``n`` distinct uppercase words (2-12 letters, letters drawn by
    LETTERS' frequency order) and their Zipf probabilities by rank."""
    letters = [c for c in LETTERS if c not in ("|", "'")]
    w = 1.0 / (np.arange(len(letters)) + 3.0)
    words, seen = [], set()
    while len(words) < n:
        lens = rng.integers(2, 13, size=n)
        draws = rng.choice(len(letters), size=(n, 12), p=w / w.sum())
        for k, row in zip(lens, draws):
            word = "".join(letters[i] for i in row[:k])
            if word not in seen:
                seen.add(word)
                words.append(word)
    p = 1.0 / np.arange(1, n + 1)
    return words[:n], p / p.sum()


def write_trigram_arpa(path: str, words, p, rng) -> None:
    """A trigram ARPA over ``words``: Zipf unigrams, TIMING_LM_SIZES'
    bigrams and trigrams drawn by the same law (each trigram extends a
    bigram), random log10 probabilities and backoffs."""
    _, n_bi, n_tri = TIMING_LM_SIZES
    n = len(words)
    bi = np.unique(rng.choice(n, size=(int(n_bi * 1.3), 2), p=p), axis=0)
    bi = bi[rng.permutation(len(bi))[:n_bi]]
    tri = np.concatenate([bi[rng.integers(0, len(bi), int(n_tri * 1.1))],
                          rng.choice(n, size=(int(n_tri * 1.1), 1), p=p)],
                         axis=1)
    tri = np.unique(tri, axis=0)[:n_tri]
    uni = np.log10(p)
    with open(path, "w") as f:
        f.write(f"\\data\\\nngram 1={n + 3}\nngram 2={len(bi)}\n"
                f"ngram 3={len(tri)}\n\n\\1-grams:\n-99\t<s>\t-0.5\n"
                "-1.0\t</s>\n-7.0\t<unk>\n")
        bo = rng.uniform(-0.8, -0.1, n)
        f.write("".join(f"{uni[i]:.4f}\t{words[i]}\t{bo[i]:.4f}\n"
                        for i in range(n)))
        f.write("\n\\2-grams:\n")
        lp, bo = rng.uniform(-3.0, -0.3, len(bi)), rng.uniform(-0.6, 0, len(bi))
        f.write("".join(f"{lp[i]:.4f}\t{words[a]} {words[b]}\t{bo[i]:.4f}\n"
                        for i, (a, b) in enumerate(bi)))
        f.write("\n\\3-grams:\n")
        lp = rng.uniform(-2.5, -0.2, len(tri))
        f.write("".join(f"{lp[i]:.4f}\t{words[a]} {words[b]} {words[c]}\n"
                        for i, (a, b, c) in enumerate(tri)))
        f.write("\n\\end\\\n")


def write_timing_corpus(root: str, seed: int) -> list:
    """TIMING_UTTERANCES validation FLACs with Zipf transcripts over the
    LM's words, the letter dict and ``lm.arpa``; returns each
    utterance's (samples, transcript words)."""
    rng = np.random.default_rng(seed + 11)
    words, p = zipf_words(rng, TIMING_LM_SIZES[0])
    write_trigram_arpa(os.path.join(root, "lm.arpa"), words, p, rng)
    with open(os.path.join(root, "dict.ltr.txt"), "w") as fh:
        fh.writelines(f"{c} {1000 - i}\n" for i, c in enumerate(LETTERS))
    rows = []
    with open(os.path.join(root, "valid.tsv"), "w") as tf, \
            open(os.path.join(root, "valid.ltr"), "w") as lf:
        tf.write(root + "\n")
        for i in range(TIMING_UTTERANCES):
            seconds = float(rng.uniform(1.5, 15.0))
            pcm = (np.clip(synthetic_speechlike(seconds, rng), -1, 1)
                   * 32767).astype(np.int16)
            with open(os.path.join(root, f"u{i}.flac"), "wb") as f:
                f.write(flac_bytes(pcm))
            text = [words[j] for j in rng.choice(
                len(words), size=max(1, round(seconds * 2.7)), p=p)]
            tf.write(f"u{i}.flac\t{len(pcm)}\n")
            lf.write(" ".join(" ".join(w) + " |" for w in text) + "\n")
            rows.append((len(pcm), text))
    return rows


def peaky_log_probs(labels, frames: int, num_labels: int, blank: int, rng,
                    confuse: float = 0.15) -> np.ndarray:
    """(frames, num_labels) CTC log-probs of the shape a trained model
    gives: blank-dominated frames with Gaussian noise, each label
    peaking at one frame, spread evenly; at ``confuse`` of them another
    letter peaks just above it (a substitution a word LM can repair)."""
    u = len(labels)
    logits = rng.normal(size=(frames, num_labels)).astype(np.float32)
    logits[:, blank] += 7.0
    pos = ((np.arange(u) + 0.5) * frames / u).astype(int)
    logits[pos, labels] += 14.0
    sub = rng.random(u) < confuse
    other = rng.integers(num_labels - len(LETTERS), num_labels, size=u)
    logits[pos[sub], other[sub]] += 15.0
    m = logits.max(-1, keepdims=True)
    return logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))


def test_timing() -> int:
    """``--test-timing``: ``cli.test`` on the card over the timing set,
    TIMING_REPS greedy runs after a warm-up (audio-s/s), then two beam+LM
    runs (``--beam 8 --lm``) on a full-width model of seeded random
    weights, whose log-probs are near uniform; then the beam+LM decode of
    ``cli.test``'s ``run_step`` alone over the same transcripts' peaky
    log-probs (``peaky_log_probs``), TIMING_REPS times: host ms per
    utterance and the greedy and beam WERs."""
    from audio8_tpu_torch.cli import test as test_cli
    from audio8_tpu_torch.models.convert import save_fairseq_ctc
    from audio8_tpu_torch.models.text import read_vocab_list
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.ops.beam import PrefixBeamSearch
    from audio8_tpu_torch.utils import Offsets, revlut

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rows = write_timing_corpus(tmp, SEED)
        lm = os.path.join(tmp, "lm.arpa")
        audio_s = sum(n for n, _ in rows) / SR
        emit({"phase": "test_timing_corpus", "utterances": len(rows),
              "audio_s": audio_s, "words": sum(len(t) for _, t in rows),
              "lm_ngrams": TIMING_LM_SIZES,
              "lm_mb": os.path.getsize(lm) / 2 ** 20,
              "seconds": time.perf_counter() - t0})
        Offsets.remap_fairseq_ctc()
        vocab_list = read_vocab_list(os.path.join(tmp, "dict.ltr.txt"))
        ckpt = os.path.join(tmp, "ctc.pt")
        save_fairseq_ctc(Wav2Vec2AcousticModel(
            base_config(len(vocab_list)),
            generator=torch.Generator().manual_seed(SEED)), ckpt)
        common = ["--checkpoint", ckpt, "--root_dir", tmp,
                  "--valid_dataset", "valid.tsv", "--device", "cuda"]
        test_cli.evaluate(common)  # warm-up: kernels built, cuDNN tuned
        for rep in range(TIMING_REPS):
            m = test_cli.evaluate(common)
            check(m["utterances"] == len(rows), f"cli.test scored {m}")
            emit({"phase": "test_timing", "run": "greedy", "rep": rep,
                  "eval_seconds": m["eval_seconds"],
                  "audio_s_per_s": m["audio_seconds"] / m["eval_seconds"],
                  "wer": m["wer"], "cer": m["cer"]})
        for rep in range(2):
            m = test_cli.evaluate(common + ["--beam", "8", "--lm", lm])
            emit({"phase": "test_timing", "run": "beam_lm_model",
                  "rep": rep, "eval_seconds": m["eval_seconds"],
                  "beam_seconds": m["beam_seconds"],
                  "beam_host_ms_per_utterance": 1e3 * m["beam_seconds"]
                  / m["utterances"], "wer": m["wer"],
                  "beam_wer": m["werr_lm_8"]})

        vocab = {v: i for i, v in enumerate(vocab_list)}
        rng = np.random.default_rng(SEED + 12)
        lps, targets = [], []
        for n, text in rows:
            labels = np.array([vocab[c] for w in text for c in w + "|"])
            frames = n // 320 - 1  # the extractor's frames at 16 kHz
            lps.append(peaky_log_probs(labels, frames, len(vocab_list),
                                       Offsets.GO, rng))
            targets.append(labels)
        t0 = time.perf_counter()
        decoder = PrefixBeamSearch(vocab_list, alpha=0.7, beta=5.0, beam=8,
                                   lm_file=lm)
        emit({"phase": "test_timing", "run": "lm_load",
              "seconds": time.perf_counter() - t0})
        index2vocab = revlut(vocab)
        for rep in range(TIMING_REPS):
            errs = {"w_errors": 0, "wbeam_errors": 0, "w_total": 0}
            host = 0.0
            for s0 in range(0, len(rows), 16):
                part = range(s0, min(s0 + 16, len(rows)))
                t_max = max(len(lps[i]) for i in part)
                lp = np.full((len(part), t_max, len(vocab_list)), -30.0,
                             np.float32)
                tok = np.full((len(part), max(len(targets[i])
                                              for i in part)),
                              Offsets.PAD, np.int32)
                for r, i in enumerate(part):
                    lp[r, :len(lps[i])] = lps[i]
                    tok[r, :len(targets[i])] = targets[i]
                lens = np.array([len(lps[i]) for i in part])
                t0 = time.perf_counter()
                sm = test_cli.run_step(index2vocab, lp, lens,
                                       {"token_ids": tok},
                                       ctc_decoder=decoder)
                host += time.perf_counter() - t0
                for k in errs:
                    errs[k] += sm[k]
            emit({"phase": "test_timing", "run": "beam_lm_peaky",
                  "rep": rep, "host_seconds": host,
                  "host_ms_per_utterance": 1e3 * host / len(rows),
                  "frames": sum(len(x) for x in lps),
                  "wer": 100 * errs["w_errors"] / errs["w_total"],
                  "beam_wer": 100 * errs["wbeam_errors"] / errs["w_total"]})
    print_card()
    return 0


FREEZE_REPS = 10


def detached(tower) -> None:
    """Make ``tower`` run with autograd on and return detached outputs
    (its graph built and dropped), however its caller calls it; ``del
    tower.forward`` undoes it."""
    real = tower.forward

    def forward(*args, **kwargs):
        with torch.enable_grad():
            out = real(*args, **kwargs)
        if isinstance(out, tuple):
            return tuple(o.detach() if torch.is_tensor(o) else o for o in out)
        return out.detach()

    tower.forward = forward


def freeze_timing() -> int:
    """``--freeze-timing``: see the module docstring. The seq2seq step
    on 3 rows of 13 s with 190-letter targets, the paired step on 8 rows
    of 15 s with 50 BPE ids of 6 747 (the phases' timed batches)."""
    from audio8_tpu_torch.cli import pretrain_paired as pp
    from audio8_tpu_torch.cli import train_seq2seq as s2s
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import (make_paired_steps,
                                              make_seq2seq_steps)

    phase_build()
    rng = np.random.default_rng(SEED)
    dirs = ["--root_dir", ".", "--train_dataset", "t", "--valid_dataset",
            "v", "--basedir", "."]

    def batch(rows, seconds, tokens, vocab):
        n = int(seconds * SR)
        sig = np.stack([synthetic_speechlike(seconds, rng)
                        for _ in range(rows)]).astype(np.float32)
        ids = rng.integers(4, vocab, size=(rows, tokens))
        return {"signal": torch.from_numpy(sig).cuda(),
                "signal_lengths": torch.full((rows,), n).cuda(),
                "token_ids": torch.from_numpy(ids).cuda(),
                "token_lengths": torch.full((rows,), tokens).cuda()}

    def s2s_setup(dt):
        model = s2s.build_model(s2s.parse_args(dirs), 32, dt).cuda()
        grad_fn, update_fn, _, _ = make_seq2seq_steps(model)
        return model, grad_fn, update_fn, [model.encoder], {"freeze": True}

    def paired_setup(dt):
        module = pp.build_module(pp.parse_args(dirs + PAIRED_FLAGS), 6747,
                                 dt).cuda()
        grad_fn, update_fn, _ = make_paired_steps(module)
        text = module.model.text_encoder
        return (module, grad_fn, update_fn,
                [module.model.audio_encoder.encoder, text.embeddings,
                 text.transformer],
                {"freeze_audio": True, "freeze_text": True})

    gen = torch.Generator().manual_seed(SEED)
    for path, setup, b in (("seq2seq", s2s_setup, batch(3, 13.0, 190, 32)),
                           ("paired", paired_setup,
                            batch(8, 15.0, 50, 6747))):
        for dt in (torch.float32, torch.bfloat16):
            model, grad_fn, update_fn, towers, flags = setup(dt)
            state = TrainState(model, create_optimizer(create_lrs(
                1e-5, 100, "constant", warmup_steps=0)))

            def step():
                out = grad_fn(b, gen, **flags)
                update_fn(state, out[-3], out[-2])

            runs = {"no_grad": [], "detach": []}
            for way in ("detach", "no_grad", "no_grad", "detach"):
                for tower in towers:
                    if way == "detach":
                        detached(tower)
                    elif "forward" in tower.__dict__:
                        del tower.forward
                step()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = []
                for _ in range(FREEZE_REPS):
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                runs[way].append({"wall_ms": ms, "peak_memory_gb":
                                  torch.cuda.max_memory_allocated() / 1e9,
                                  **(traced_window(step) or {})})
            emit({"phase": "freeze_timing", "path": path, "dtype": str(dt),
                  "batch": list(b["signal"].shape), **runs})
            for tower in towers:
                tower.__dict__.pop("forward", None)
            del model, state
            torch.cuda.empty_cache()
    print_card()
    return 0


# ------------------------------------ the trainers' flags, binary LMs

TRAINER_PHASES = ("remat", "augment", "kenlm_binary", "warmstart")
REMAT_ROWS, REMAT_SAMPLES = 20, 71_428  # the pretraining cell's batches
REMAT_TIMED_STEPS = 3
REMAT_GNORM_RTOL = 1e-5  # remat vs plain on one card: the global norm
REMAT_SGD_STEPS = 4
REMAT_SGD_FLAGS = ["--target_tokens_per_batch", "700000", "--grad_accum",
                   "2", "--train_steps", str(REMAT_SGD_STEPS),
                   "--unfreeze_enc_after_step", "1", "--warmup_steps", "2",
                   "--valid_steps", "0", "--steps_per_checkpoint",
                   str(REMAT_SGD_STEPS), "--remat", "true", "--optim", "sgd"]
AUGMENT_STEPS = 12  # the profiler's window opens after step 10
AUGMENT_FLAGS = ["--target_tokens_per_batch", "700000", "--grad_accum", "1",
                 "--train_steps", str(AUGMENT_STEPS),
                 "--unfreeze_enc_after_step", "6", "--warmup_steps", "2",
                 "--valid_steps", "0", "--steps_per_checkpoint", "100",
                 "--speed_perturb", "0.9", "1.0", "1.1"]
KENLM_LAYOUTS = {"probing": [], "trie": ["--trie"],
                 "quant_trie": ["--trie", "-q"]}
WARMSTART_FLAGS = ["--train_steps", "2", "--unfreeze_audio_after_step", "0",
                   "--unfreeze_text_after_step", "5", "--warmup_steps", "1",
                   "--steps_per_checkpoint", "2", "--valid_steps", "0",
                   "--num_train_workers", "4", "--target_type", "bpe",
                   "--weight_decay", "0"]


def remat_run(weights: dict, signal: torch.Tensor, remat: bool,
              seed: int) -> dict:
    """One full-width pretraining step (``make_pretrain_steps``, dropout
    0.1, the JAX defaults) from ``weights`` with seeds drawn from a
    generator seeded ``seed``, then REMAT_TIMED_STEPS more, each
    synchronised: step 1's loss, gradient norm and gradients (on the
    host), the generator's state after it and its launches; the later
    steps' wall ms; the peak memory of the run (reset after the weights
    and the AdamW state are placed) and what was resident before it.
    Everything the run placed on the card is freed before it returns."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    model = Wav2Vec2Model(PretrainConfig(remat=remat)).cuda()
    model.load_state_dict(weights)
    state = TrainState(model, create_optimizer(create_lrs(
        2e-4, 10, "constant", warmup_steps=0), weight_decay=0.01))
    train_step, _ = make_pretrain_steps(model)
    grads = {}
    apply = state.apply_gradients

    def keeping(g, **kw):
        grads.update({n: t.detach().cpu() for n, t in zip(state.names, g)})
        return apply(g, **kw)

    state.apply_gradients = keeping
    gen = torch.Generator().manual_seed(seed)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    _, metrics = train_step(state, signal, PretrainSeeds.draw(gen), gen)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    rng = gen.get_state()
    del state.apply_gradients  # the class's again
    ms = []
    for _ in range(REMAT_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, signal, PretrainSeeds.draw(gen), gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]), "grads": grads,
           "rng": rng, "launches": launches, "first_step_ms": first_ms,
           "step_ms": ms, "resident_gb": resident,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, state, train_step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


OPTIM_CALLS = 10


def optimizer_ms(model) -> dict:
    """Wall ms of one synchronised ``apply_gradients`` (grad scale and
    clip included) of AdamW (kernel 5) and of SGD (torch ops) over
    ``model``'s parameters, OPTIM_CALLS calls each after a warm-up, in
    turns (adamw, sgd, sgd, adamw)."""
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)

    grads = [torch.full_like(p, 1e-3) for p in model.parameters()]
    out = {}
    for name in ("adamw", "sgd", "sgd", "adamw"):
        state = TrainState(model, create_optimizer(create_lrs(
            1e-9, 100, "constant", warmup_steps=0), name))
        state.apply_gradients(grads, grad_scale=0.5, clip_norm=25.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OPTIM_CALLS):
            state.apply_gradients(grads, grad_scale=0.5, clip_norm=25.0)
        torch.cuda.synchronize()
        out.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3 / OPTIM_CALLS)
        del state
    del grads
    torch.cuda.empty_cache()
    return out


def phase_remat(tmp: str, seed: int) -> tuple:
    """``--remat``: one full-width pretraining step at the pretraining
    cell's shape (REMAT_ROWS rows of REMAT_SAMPLES samples, dropout 0.1,
    f32) without and with remat from the same weights and generator seed,
    in turns (plain, remat, remat, plain): the loss equal, the gradient norm within REMAT_GNORM_RTOL, every
    gradient within PRETRAIN_GNORM_RTOL of its leaf's largest entry (at
    least 1e-3 of the model's largest), the generator's stream equal;
    the layers' forwards doubled (kernel 2 twice, kernel 4 two more
    launches a layer), everything else equal; the remat step's peak
    memory below the plain one's; each run's peak memory, step ms and
    launches of kernels 2, 2b, 3, 3b, 3c and 4. Then ``cli.train
    --remat true --optim sgd`` for REMAT_SGD_STEPS CTC steps at the
    ``a8t-train`` defaults on the train phase's corpus: finite losses,
    kernels 1 and 2 in every micro-step, kernel 2 twice a layer in the
    unfrozen ones (the recompute), kernel 5 never, an SGD state; then the
    optimizer update's ms on its model, AdamW against SGD
    (:func:`optimizer_ms`). Returns the remat step's launches, the CTC
    run's, its checkpoint and its corpus."""
    from audio8_tpu_torch.cli import train as train_cli
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2Model
    from audio8_tpu_torch.train.checkpoint import find_latest_checkpoint
    from audio8_tpu_torch.train.optim import SGDState

    cfg = PretrainConfig()
    weights = Wav2Vec2Model(cfg, generator=torch.Generator().manual_seed(
        seed + 17)).state_dict()
    rng = np.random.default_rng(seed + 17)
    signal = torch.from_numpy(np.stack([
        synthetic_speechlike((REMAT_SAMPLES + 1) / SR, rng)[:REMAT_SAMPLES]
        for _ in range(REMAT_ROWS)])).cuda()
    runs = {name: remat_run(weights, signal, name.startswith("remat"),
                            seed + 18)
            for name in ("plain", "remat", "remat_again", "plain_again")}
    plain, remat = runs["plain"], runs["remat"]
    top = max(float(g.abs().max()) for g in plain["grads"].values())
    worst_leaf, worst = None, 0.0
    for k, g in plain["grads"].items():
        scale = max(float(g.abs().max()), 1e-3 * top)
        e = float((remat["grads"][k] - g).abs().max()) / scale
        if e >= worst:
            worst_leaf, worst = k, e
    gnorm_rel = abs(remat["grad_norm"] - plain["grad_norm"]) / \
        plain["grad_norm"]
    shown = ("attention_fwd", "attention_bwd", "conv_k3s2_fwd",
             "conv_k3s2_dgrad", "conv_k3s2_wgrad", "dropout")
    emit({"phase": "remat", "config": "wav2vec2-base d768 h12 L12 ff3072, "
          "final_dim 256, dropout 0.1, f32", "rows": [REMAT_ROWS,
                                                     REMAT_SAMPLES],
          **{name: {"loss": r["loss"], "grad_norm": r["grad_norm"],
                    "peak_memory_gb": r["peak_memory_gb"],
                    "resident_gb": r["resident_gb"],
                    "first_step_ms": r["first_step_ms"],
                    "step_ms": r["step_ms"],
                    "launches": {k: r["launches"][k] for k in shown}}
             for name, r in runs.items()},
          "gnorm_rel_err": gnorm_rel, "gnorm_rtol": REMAT_GNORM_RTOL,
          "grad_worst_rel_err": worst, "grad_worst_leaf": worst_leaf,
          "grad_rtol": PRETRAIN_GNORM_RTOL})
    check(remat["loss"] == plain["loss"],
          f"remat: loss {remat['loss']} != plain {plain['loss']}")
    check(gnorm_rel <= REMAT_GNORM_RTOL, f"remat: gnorm {gnorm_rel}")
    check(worst <= PRETRAIN_GNORM_RTOL, f"remat: {worst_leaf} {worst}")
    check(torch.equal(remat["rng"], plain["rng"]),
          "remat: the generator's stream moved")
    layers = cfg.num_layers
    want = dict(plain["launches"], attention_fwd=2 * layers,
                dropout=plain["launches"]["dropout"] + 2 * layers)
    check(plain["launches"]["attention_fwd"] == layers
          and remat["launches"] == want,
          f"remat launches {remat['launches']} against plain "
          f"{plain['launches']}")
    check(all(runs[f"{a}_again"]["loss"] == runs[a]["loss"]
              for a in ("plain", "remat")), "remat: a repeat's loss moved")
    check(remat["peak_memory_gb"] < plain["peak_memory_gb"],
          "remat: no memory saved")
    step_launches = remat["launches"]
    del runs, plain, remat, weights, signal
    torch.cuda.empty_cache()

    corpus = os.path.join(tmp, "corpus")
    if not os.path.isdir(corpus):
        os.makedirs(corpus)
        write_corpus(corpus, seed)
    basedir = os.path.join(tmp, "remat_sgd_run")
    records = []
    reset_launches()
    t0 = time.perf_counter()
    with per_call_launches(train_cli, "make_ctc_steps", records):
        state = train_cli.train([
            "--root_dir", corpus, "--train_dataset", "train.tsv",
            "--valid_dataset", "valid.tsv", "--basedir", basedir,
            "--device", "cuda", *REMAT_SGD_FLAGS])
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items()
                if k in TRAIN_PATH}
    log = state.log
    per_micro = [(f["freeze"], d["ctc_loss"], d["attention_fwd"])
                 for f, d in records]
    optim = optimizer_ms(state.model)
    emit({"phase": "remat_sgd", "flags": REMAT_SGD_FLAGS,
          "losses": [r["loss"] for r in log],
          "step_seconds": [r["seconds"] for r in log],
          "frozen": [r["frozen"] for r in log], "wall_s": wall,
          "micro_steps": [{"frozen": f, "ctc_loss": c, "attention_fwd": a}
                          for f, c, a in per_micro],
          "launches": launches, "optimizer_ms": optim,
          "params": sum(p.numel() for p in state.params)})
    check(state.step == REMAT_SGD_STEPS and isinstance(state.opt_state,
                                                       SGDState)
          and state.model.config.remat, "remat_sgd: the run's state")
    check(all(math.isfinite(r["loss"]) for r in log),
          "remat_sgd: non-finite loss")
    check(len(per_micro) == 2 * REMAT_SGD_STEPS
          and all(c > 0 and a > 0 for _, c, a in per_micro),
          f"remat_sgd: kernels 1 and 2 by micro-step {per_micro}")
    check(all(a == (1 if f else 2) * layers for f, _, a in per_micro),
          f"remat_sgd: the unfrozen micro-steps' recompute {per_micro}")
    check(launches["adamw"] == 0, "remat_sgd: AdamW launched under SGD")
    return (step_launches, launches, find_latest_checkpoint(basedir)[0],
            corpus)


def write_noise(root: str, seed: int) -> None:
    """Four noise clips of 1-8 s: white, pink (a running sum), a hum and
    bursts, at several levels."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed + 21)
    for i in range(4):
        n = int(rng.uniform(1.0, 8.0) * SR)
        white = rng.normal(size=n)
        noise = (white, np.cumsum(white) / np.sqrt(np.arange(1, n + 1)),
                 np.sin(2 * np.pi * 50 * np.arange(n) / SR)
                 + 0.1 * white, white * (rng.random(n) < 0.2))[i]
        noise = noise / np.abs(noise).max() * rng.uniform(0.1, 0.8)
        wavfile.write(os.path.join(root, f"noise{i}.wav"), SR,
                      (noise * 32767).astype(np.int16))


def phase_augment(tmp: str, corpus: str, seed: int) -> dict:
    """``cli.train`` with ``--speed_perturb 0.9 1.0 1.1`` and
    ``--noise_manifest`` over four synthetic noise clips for AUGMENT_STEPS
    steps, with ``--profile_dir``: finite losses, speed perturbation and
    noise mixing applied (their calls counted), the Chrome trace of the
    window after step 10 written, parsing as JSON and holding its
    ``ProfilerStep#`` spans; its count of CUDA kernel events printed (a
    trace that comes back without any is reported, not failed). Returns
    the run's launches."""
    import audio8_tpu_torch.data.datasets as datasets
    from audio8_tpu_torch.cli import train as train_cli
    from audio8_tpu_torch.data.audio import NoiseMixer

    noise = os.path.join(tmp, "augment_noise")
    os.makedirs(noise)
    write_noise(noise, seed)
    profile = os.path.join(tmp, "augment_profile")
    calls = {"speed": [], "noise": []}
    speed, mix = datasets.speed_perturb_wav, NoiseMixer.__call__

    def counted_speed(wav, factor):
        calls["speed"].append(factor)
        return speed(wav, factor)

    def counted_mix(self, wav, rng):
        calls["noise"].append(len(wav))
        return mix(self, wav, rng)

    datasets.speed_perturb_wav, NoiseMixer.__call__ = counted_speed, \
        counted_mix
    reset_launches()
    t0 = time.perf_counter()
    try:
        state = train_cli.train([
            "--root_dir", corpus, "--train_dataset", "train.tsv",
            "--valid_dataset", "valid.tsv", "--basedir",
            os.path.join(tmp, "augment_run"), "--device", "cuda",
            "--noise_manifest", noise, "--profile_dir", profile,
            *AUGMENT_FLAGS])
    finally:
        datasets.speed_perturb_wav, NoiseMixer.__call__ = speed, mix
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items()
                if k in TRAIN_PATH}
    log = state.log
    trace = state.profile_trace
    check(trace is not None and os.path.exists(trace),
          f"augment: no trace in {os.listdir(profile)}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted({e["name"] for e in events
                    if str(e.get("name", "")).startswith("ProfilerStep#")})
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    emit({"phase": "augment", "flags": AUGMENT_FLAGS,
          "noise_clips": len(os.listdir(noise)),
          "losses": [r["loss"] for r in log],
          "step_seconds": [r["seconds"] for r in log],
          "speed_perturbed_rows": len(calls["speed"]),
          "speed_factors": sorted(set(calls["speed"])),
          "noise_mixed_rows": len(calls["noise"]), "wall_s": wall,
          "trace": os.path.basename(trace),
          "trace_mb": os.path.getsize(trace) / 1e6,
          "trace_steps": steps, "trace_events": len(events),
          "trace_cuda_kernel_events": kernels,
          "trace_empty_of_kernels": kernels == 0, "launches": launches})
    check(state.step == AUGMENT_STEPS and all(
        math.isfinite(r["loss"]) for r in log), "augment: the run's losses")
    check(calls["speed"] and calls["noise"],
          f"augment: speed {len(calls['speed'])}, noise "
          f"{len(calls['noise'])} rows")
    check("ProfilerStep#0" in steps and len(steps) >= 2,
          f"augment: trace steps {steps}")
    return launches


def phase_kenlm_binary(tmp: str, checkpoint: str, corpus: str,
                       seed: int) -> dict:
    """``cli.build_binary`` writes PROBING, TRIE and QUANT_TRIE binaries
    of the serve phase's trigram ARPA (written here when the run has
    none); ``cli.test --beam 8 --lm`` on the card decodes the CTC
    checkpoint's valid set with the ARPA and with each binary: the
    PROBING and TRIE beam transcripts equal the ARPA run's; QUANT_TRIE's
    WER difference is printed; each LM's load seconds and file MB.
    Returns the runs' launches."""
    from audio8_tpu_torch.cli import build_binary
    from audio8_tpu_torch.cli import test as test_cli

    arpa = os.path.join(tmp, "serve_lm.arpa")
    if not os.path.exists(arpa):
        write_serve_lm(arpa, seed)
    lms, build_s = {"arpa": arpa}, {}
    for name, flags in KENLM_LAYOUTS.items():
        lms[name] = os.path.join(tmp, f"serve_lm.{name}.bin")
        t0 = time.perf_counter()
        check(build_binary.main([arpa, lms[name], *flags]) == 0,
              f"kenlm_binary: build_binary {name}")
        build_s[name] = time.perf_counter() - t0
    common = ["--checkpoint", checkpoint, "--root_dir", corpus,
              "--valid_dataset", "valid.tsv", "--device", "cuda",
              "--beam", "8"]
    reset_launches()
    runs = {name: test_cli.evaluate(common + ["--lm", lm],
                                    keep_outputs=True)
            for name, lm in lms.items()}
    launches = {k: n for k, n in read_launches().items()
                if k in INFER_PATH}
    texts = {name: [o["beam"] for o in r["outputs"]]
             for name, r in runs.items()}
    emit({"phase": "kenlm_binary", "arpa_mb": os.path.getsize(arpa) / 1e6,
          "build_seconds": build_s,
          "file_mb": {n: os.path.getsize(p) / 1e6 for n, p in lms.items()},
          "lm_load_seconds": {n: r["lm_load_seconds"]
                              for n, r in runs.items()},
          "beam_seconds": {n: r["beam_seconds"] for n, r in runs.items()},
          "beam_wer": {n: r["werr_lm_8"] for n, r in runs.items()},
          "quant_trie_wer_minus_arpa": runs["quant_trie"]["werr_lm_8"]
          - runs["arpa"]["werr_lm_8"],
          "texts_equal_arpa": {n: texts[n] == texts["arpa"] for n in lms},
          "utterances": runs["arpa"]["utterances"], "launches": launches})
    check(all(math.isfinite(r["werr_lm_8"]) for r in runs.values())
          and runs["arpa"]["utterances"] > 0, "kenlm_binary: the runs")
    for name in ("probing", "trie"):
        check(texts[name] == texts["arpa"],
              f"kenlm_binary: {name} transcripts differ from the ARPA's")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by kenlm_binary")
    return launches


def phase_warmstart(tmp: str, seed: int) -> dict:
    """``--warmstart_text``: a ``.npz`` written by the port's
    ``save_tlm_npz`` from a seeded text tower in the paired cell's text
    config (512 wide, 8 heads, 8 layers, 2048, rpr_k 8, the paired
    corpus' BPE pieces), then ``cli.pretrain_paired --warmstart_text`` for
    2 steps on the card, the text tower frozen and no weight decay: the
    report loads every array and finds nothing unexpected and nothing
    missing, the text tower after the run equals the file bitwise (its
    own ``save_tlm_npz`` against the file), the losses are finite.
    Returns the run's launches."""
    from audio8_tpu_torch.cli import pretrain_paired as pp
    from audio8_tpu_torch.models.warmstart import save_tlm_npz

    corpus = os.path.join(tmp, "paired_corpus")
    if os.path.isdir(corpus):
        with open(os.path.join(corpus, "train.tsv")) as f:
            longest = max(int(ln.split("\t")[1]) for ln in f.readlines()[1:])
    else:
        os.makedirs(corpus)
        longest = write_paired_corpus(corpus, seed)
    argv = ["--root_dir", corpus, "--train_dataset", "train.tsv",
            "--valid_dataset", "valid.tsv", "--basedir",
            os.path.join(tmp, "warmstart_run"), "--device", "cuda",
            *WARMSTART_FLAGS, "--target_tokens_per_batch",
            str(PAIRED_ROWS * longest), "--subword_model_file",
            os.path.join(corpus, "codes.bpe"), "--subword_vocab_file",
            os.path.join(corpus, "vocab.bpe")]
    args = pp.parse_args(argv)
    args.dict_file = args.dict_file.format(args.target_type)
    vocab, _, _ = pp.datasets(args)
    tower = pp.build_module(args, len(vocab), torch.float32).model
    tower.init_from(torch.Generator().manual_seed(seed + 19))
    npz = os.path.join(tmp, "tlm.npz")
    save_tlm_npz(tower.text_encoder, npz)
    del tower
    reset_launches()
    t0 = time.perf_counter()
    state = pp.train(argv + ["--warmstart_text", npz])
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items() if k in S2S_PATH}
    after = os.path.join(tmp, "tlm_after.npz")
    save_tlm_npz(state.model.model.text_encoder, after)
    want, got = np.load(npz), np.load(after)
    differ = [k for k in want.files
              if not np.array_equal(want[k], got[k])]
    report = state.warmstart
    log = state.log
    emit({"phase": "warmstart", "flags": WARMSTART_FLAGS,
          "npz_mb": os.path.getsize(npz) / 1e6, "arrays": len(want.files),
          "loaded": len(report["loaded"]),
          "unexpected": report["unexpected"],
          "missing_in_npz": report["missing_in_npz"],
          "arrays_differing_after": differ,
          "losses": [r["loss"] for r in log],
          "step_seconds": [r["seconds"] for r in log], "wall_s": wall,
          "launches": launches})
    check(len(report["loaded"]) == len(want.files)
          and not report["unexpected"] and not report["missing_in_npz"],
          "warmstart: the report")
    check(want.files == got.files and not differ,
          f"warmstart: the text tower differs from the file at {differ[:3]}")
    check(state.step == 2 and all(math.isfinite(r["loss"]) for r in log),
          "warmstart: the run's losses")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by warmstart")
    return launches


def trainer_phases(tmp: str) -> dict:
    """This slice's phases in order (``tmp`` may hold the train phase's
    corpus, the serve phase's ARPA and the paired corpus; missing ones
    are written). Returns each run's launch counts."""
    out = {}
    with timed("remat"):
        out["remat"], out["remat_sgd"], ckpt, corpus = phase_remat(tmp,
                                                                   SEED)
    torch.cuda.empty_cache()
    with timed("augment"):
        out["augment"] = phase_augment(tmp, corpus, SEED)
    torch.cuda.empty_cache()
    with timed("kenlm_binary"):
        out["kenlm_binary"] = phase_kenlm_binary(tmp, ckpt, corpus, SEED)
    torch.cuda.empty_cache()
    with timed("warmstart"):
        out["warmstart"] = phase_warmstart(tmp, SEED)
    torch.cuda.empty_cache()
    return out


def trainer_timing() -> int:
    """The build and this slice's phases alone (``--trainer-phases``) on
    fresh corpora, then the phase seconds and the card."""
    with timed("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        launches = trainer_phases(tmp)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "trainer_phases", "launches": launches})
    print_card()
    return 0

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import audio8_tpu_torch  # noqa: F401 - fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if argv == ["--block-timing"]:
        return block_timing(gen)
    if argv == ["--core-timing"]:
        return core_timing(gen)
    if argv == ["--test-timing"]:
        return test_timing()
    if argv == ["--freeze-timing"]:
        return freeze_timing()
    if argv == ["--topology-phases"]:
        return topology_timing(gen)
    if argv == ["--export-phases"]:
        return export_phases(gen)
    if argv == ["--host-timing"]:
        return host_timing()
    if argv == ["--trainer-phases"]:
        return trainer_timing()
    inference_first = argv == ["--inference-first"]
    if argv and not inference_first:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    start = time.perf_counter()
    with timed("build"):
        phase_build()
    with timed("kernel"):
        worst = phase_kernels(gen)
        worst.update(phase_train_kernels(gen))
        worst.update(phase_conv_bwd_kernels(gen))
    with timed("variants"):
        phase_variants(gen)
        phase_train_variants(gen)
        phase_pretrain_variants(gen)
    with timed("model"):
        cpu_model = phase_model(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        with timed("serve"):
            _, f32_texts = phase_serve(cpu_model, SEED, tmp)
        del cpu_model
        torch.cuda.empty_cache()
        with timed("serve_bf16"):
            phase_serve_bf16(SEED, tmp, f32_texts)
        torch.cuda.empty_cache()
        with timed("train"):
            train_launches = phase_train(tmp, SEED)
        torch.cuda.empty_cache()
        with timed("pretrain"):
            launches, batches = phase_pretrain(tmp, SEED)
        torch.cuda.empty_cache()
        with timed("pretrain_bf16"):
            phase_pretrain_bf16(tmp)
        torch.cuda.empty_cache()
        with timed("restart_test"):
            restart_launches = phase_restart_test(tmp, SEED)
        torch.cuda.empty_cache()
        if inference_first:
            infer_launches = phase_inference(tmp, f32_texts, worst, gen)
        with timed("seq2seq"):
            s2s_launches, s2s_weights, s2s_built, s2s_path = phase_seq2seq(
                tmp, SEED)
        torch.cuda.empty_cache()
        with timed("paired"):
            (paired_launches, paired_weights, paired_built,
             paired_path) = phase_paired(tmp, SEED)
        torch.cuda.empty_cache()
        with timed("seq2seq_vs_cpu"):
            phase_seq2seq_vs_cpu(s2s_weights, s2s_built, SEED)
        torch.cuda.empty_cache()
        with timed("paired_vs_cpu"):
            phase_paired_vs_cpu(paired_weights, paired_built, SEED)
        del s2s_weights, paired_weights
        torch.cuda.empty_cache()
        for name, path in (("seq2seq", s2s_path), ("paired", paired_path)):
            with timed(f"{name}_kernel"):
                for k, e in phase_path_kernels(name, *path, gen).items():
                    worst[k] = max(worst[k], e)
            torch.cuda.empty_cache()
        with timed("pretrain_kernel"):
            for k, e in phase_pretrain_path_kernels(batches, gen).items():
                worst[k] = max(worst[k], e)
        torch.cuda.empty_cache()
        with timed("pretrain_block"):
            block_launches = phase_pretrain_block(batches, SEED)
        torch.cuda.empty_cache()
        with timed("block_gate"):
            phase_block_gate()
        with timed("train_vs_cpu"):
            phase_train_vs_cpu(SEED)
        with timed("pretrain_vs_cpu"):
            phase_pretrain_vs_cpu(SEED, batches[-1][1])
        with timed("block_vs_cpu"):
            phase_pretrain_vs_cpu(SEED, batches[-1][1], fused="block")
        with timed("kernel_vs_cpu"):
            phase_pretrain_vs_cpu(SEED, batches[-1][1], fused=True,
                                  dropout=0.1)
        torch.cuda.empty_cache()
        with timed("timing"):
            times = phase_timing(gen)
        torch.cuda.empty_cache()
        if not inference_first:
            infer_launches = phase_inference(tmp, f32_texts, worst, gen)
        torch.cuda.empty_cache()
        topo_launches = topology_phases(tmp, worst, gen)
        with timed("export"):
            export_launches = phase_export(tmp, SEED)
        torch.cuda.empty_cache()
        trainer_launches = trainer_phases(tmp)
    emit({"phase": "phase_seconds", **PHASE_SECONDS,
          "inference_first": inference_first,
          "trace_retries": {str(k): n for k, n in TRACE_RETRIES.items()},
          "trace_retry_pauses": RETRY_PAUSED["s"],
          "step_trace_retry_pauses": STEP_RETRY_PAUSED["s"],
          "total": time.perf_counter() - start})
    check("jax" not in sys.modules and "audio8_tpu" not in sys.modules,
          "jax or the JAX package was imported")
    from audio8_tpu_torch.ops.attention_block import GEMM_ROUTES
    from audio8_tpu_torch.ops.attention import FWD_ROUTES
    from audio8_tpu_torch.ops.conv import FWD_ROUTES as CONV_FWD_ROUTES
    from audio8_tpu_torch.ops.conv import DGRAD_ROUTES, WGRAD_ROUTES
    check(BLOCK_ROUTES_SEEN == set(GEMM_ROUTES),
          f"attention_block routes checked: {sorted(BLOCK_ROUTES_SEEN)}")
    check(ATTN_ROUTES_SEEN == set(FWD_ROUTES),
          f"attention_fwd routes checked: {sorted(ATTN_ROUTES_SEEN)}")
    check(WGRAD_ROUTES_SEEN == set(WGRAD_ROUTES),
          f"conv_k3s2_wgrad routes checked: {sorted(WGRAD_ROUTES_SEEN)}")
    check(DGRAD_ROUTES_SEEN == set(DGRAD_ROUTES),
          f"conv_k3s2_dgrad routes checked: {sorted(DGRAD_ROUTES_SEEN)}")
    check(CONV_FWD_ROUTES_SEEN == set(CONV_FWD_ROUTES),
          f"conv_k3s2_fwd routes checked: {sorted(CONV_FWD_ROUTES_SEEN)}")
    routes_of = {"attention_fwd": ATTN_ROUTES_SEEN,
                 "conv_k3s2_wgrad": WGRAD_ROUTES_SEEN,
                 "conv_k3s2_dgrad": DGRAD_ROUTES_SEEN,
                 "conv_k3s2_fwd": CONV_FWD_ROUTES_SEEN,
                 "attention_block": BLOCK_ROUTES_SEEN,
                 "attention_block_bwd": BLOCK_ROUTES_SEEN}

    # launches: each kernel's path run (PATH_OF, else the pretraining run);
    # the block's rows also carry their launch split, GEMM route and host
    # ms per call, and the same in bf16
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "timed_by")
    split_keys = {"attention_block": ("launch_ms", "gemm_routes", "host_ms",
                                      "event_ms"),
                  "attention_fwd": ("launch_ms", "routes", "host_ms",
                                    "event_ms")}
    split_keys["attention_block_bwd"] = split_keys["attention_block"]
    split_keys["conv_k3s2_wgrad"] = split_keys["attention_fwd"]
    split_keys["conv_k3s2_fwd"] = split_keys["attention_fwd"] + (
        "layer_ms", "layer_library_ms")
    split_keys["conv_k3s2_dgrad"] = split_keys["conv_k3s2_fwd"] + (
        "launch_seq_ms",)
    split_keys["ctc_loss"] = ("launch_ms", "host_ms", "event_ms")

    def extra(name):
        if name not in split_keys:
            return {}
        out = {k: times[(name, torch.float32)][k] for k in split_keys[name]}
        if name in routes_of:
            # every route the checks saw run (the timing rows' own
            # "routes" name only the routes their dtype took)
            out["routes"] = sorted(routes_of[name])
        if (name, torch.bfloat16) in times:
            out["bfloat16"] = {k: times[(name, torch.bfloat16)][k]
                               for k in keys + split_keys[name]}
        return out

    path_launches = {"pretrain": launches, "train": train_launches,
                     "pretrain_block": block_launches}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"audio8_tpu_torch/csrc/{SOURCES[name]}",
         "replaces": REPLACES[name],
         "path": PATH_OF.get(name, "pretrain"),
         "launches": path_launches[PATH_OF.get(name, "pretrain")][name],
         "restart_test_launches": restart_launches.get(name, 0),
         "seq2seq_launches": s2s_launches.get(name, 0),
         "paired_launches": paired_launches.get(name, 0),
         **{f"{p}_launches": infer_launches[p].get(name, 0)
            for p in INFER_PHASES},
         **{f"{p}_launches": topo_launches[p].get(name, 0)
            for p in TOPOLOGY_PHASES},
         "export_launches": export_launches.get(name, 0),
         **{f"{p}_launches": trainer_launches[p].get(name, 0)
            for p in trainer_launches},
         "max_abs_err": worst[name],
         **{k: times[(name, torch.float32)][k] for k in keys},
         **extra(name)}
        for name in REPLACES]})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
