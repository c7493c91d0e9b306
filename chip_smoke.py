#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``audio8_tpu_torch``) on one CUDA card.

Drives the port's serving path, its CTC fine-tuning path, its
contrastive pretraining path, its seq2seq path, its paired audio-text
path, its RNN-T path (training, decoding, streaming, serving, eval
and export), its HuBERT and data2vec pretraining paths, and its
decoders' device beam, text-LM trainer and n-best rescoring, and its
data-parallel training (one NCCL rank, then two gloo ranks sharing the
card) with its ZeRO-1 and FSDP sharding and its tensor and sequence
parallelism, at full wav2vec2-base width
with seeded random weights, the trainers' remat,
SGD, augmentation and profiler flags, KenLM binaries written by the port
and the text tower's warm start, the pretraining path again through the
attention block (``fused_attention="block"``), the public large layouts
(LV-60, HuBERT, data2vec, WavLM, conformer) and HuggingFace checkpoints,
and holds every hand-written kernel against its plain PyTorch version.
Phases, each printing JSON lines:

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
              point at full width (the wav2vec2-base encoder, 6 of its 12
              layers, a depth cut, warm-started from phase 7's
              ``checkpoint-step-5.pt``; the paired phase's audio tower
              likewise), the default decoder
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
              ``conformer-large-rope``, ``conformer-large-rel``: 6 of their
              24 layers, a depth cut, 1024 wide, 16 heads, 4096) with seeded
              weights: one (4, 30 s)
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
    lv60_train - (the LV-60 runs keep 6 of the preset's 24 layers, a
              depth cut that makes room for phases 23 and 25)
              ``cli.pretrain --preset large-lv60`` for 2 steps (conv
              bias and layer-mode norms through kernels 3b and 3c), then
              ``cli.train --preset large-lv60 --layer_drop 0.1
              --restart_from`` its ``.pt`` for 4 steps in f32 and in bf16
              (both on SGD, to keep the full run's disk writes under the
              machine's cap), one unfrozen step card vs CPU
              (``lv60_vs_cpu``, the train_vs_cpu gates, LayerDrop off),
              and kernels 1, 2, 2b, 3, 3b, 3c, 4 and 5 against their
              plain versions at every shape those runs gave them;
    lv60_block - pretraining steps of the LV-60 model through the
              attention block (``fused_attention="block"``, d_model 1024,
              pre-norm: a block forward and backward per layer a step, no core
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
19. transducer - ``cli.train_transducer`` at full width (wav2vec2-base
              encoder, 2 x 512 LSTM predictor, 512 joint) warm-started
              from the train phase's CTC ``.pt`` on its corpus: 2 f32
              steps (1 frozen), 2 with ``--fused_loss true --valid_beam
              4`` and 2 with ``--bf16`` (these two on SGD, to keep the
              full run's disk writes down), each
              micro-step's launches of kernels 2, 2b, 3 and 4 and each
              AdamW update's of 5 held to what the code predicts; one
              unfrozen step card vs CPU for each
              loss route (loss 1e-4, gradient norm 1e-3);
              bench_transducer's step ((16, 41 359) samples, U 64)
              timed in f32 and bf16 in turns (wall and device ms, idle
              share, peak memory, the loss's device ms forward and
              backward); kernels 2, 2b, 3, 4 and 5 against their plain
              versions at that step's shapes; greedy decode of three of
              the served requests (30 s chunks) against the CPU's tokens
              (near ties allowed), the timed decode, the
              ``TransducerStreamer`` against the offline stitch, beam 4
              on short clips against the CPU, one ``decode_frames``
              window and one beam search under
              ``torch.cuda.set_sync_debug_mode("error")``, ``cli.serve
              --transducer`` (``/transcribe``, ``/stream``), ``cli.test
              --transducer`` greedy and ``--beam 4``, ``cli.export
              --transducer`` and its artifact in transcribe, serve and
              test (tokens equal the live model's); greedy ms per
              utterance and audio-s/s at (4, 30 s) and beam ms per
              utterance;
20. ssl     - HuBERT and data2vec pretraining at full width on a corpus of
              its own: ``cli.cluster_targets`` (MFCC k-means targets on the
              host, then iteration 2: layer 6 of a random base HuBERT
              ``.pt`` on the card, two clips' ids recomputed from CPU
              features, equal but near ties); one step of each objective
              card vs CPU on two rows of 3.0 and 2.6 s (HuBERT f32 loss
              1e-4, gradient norm 1e-3, masked accuracy equal but argmax
              near ties, then bf16 5e-3; data2vec-base f32 with the EMA
              teacher after the step within 1e-6 of its largest weight);
              bench_hubert's step ((8, 163 920), T' 512, 100 clusters,
              AdamW) of each objective in f32 and bf16 in turns (wall and
              device ms, idle share, peak memory, audio-s/s), its
              launches held to the code's prediction first; kernels 2,
              2b, 3, 3b, 3c, 4 and 5 against their plain versions at those
              steps' shapes; then ``cli.pretrain_hubert`` for 2 steps from
              the ``.km`` files, ``cli.train --restart_from`` its
              checkpoint for 2 CTC steps (kernel 1; every encoder weight
              the HuBERT checkpoint's after the run), and
              ``cli.pretrain_data2vec --preset data2vec-base`` for 2 steps
              and a restart whose teacher is bitwise the saved one (the
              three on SGD, whose checkpoints carry no moments); the
              bytes the phase wrote;
21. decode  - the device beam (``ops/beam_device.py``) at beams 8 and
              100 on one (4, 30 s) batch of (4, 1499, 32) log-probs shaped
              like a trained model's, timed on the card (ms per batch,
              audio-s/s) beside the host library's search; its n-best
              equal to the same search on the CPU (every row at beam 8,
              the two shorter at beam 100; scores within 1e-4), every
              rank equal to the host search's unless a near tie (beam
              100 also with the word bonus, that search run under
              ``torch.cuda.set_sync_debug_mode("error")``; at beam 8 the
              host search's symbol pruning splits them with it);
              ``cli.train_lm`` at its JAX defaults (512 wide, 8 heads, 6
              layers, 2048, rpr_k 8, block 512, batch 32, dropout 0.1) on
              a synthetic transcript corpus, 3 f32 and 2 bf16 steps:
              kernel 4's launches as the code predicts (its forward
              dropouts, each again in the backward), kernel 5's once a
              step, step ms, tokens/s, peak memory, a traced step's
              device ms, idle share and costliest kernels; one step card
              vs CPU
              (loss 1e-4, gradient norm 1e-3); kernels 4 and 5 against
              their plain versions at the LM's shapes; ``cli.test --beam
              8 --lm_rescore`` that LM on the CTC cell's ``ctc.pt`` over
              6 clips of 1.5-15 s with and without ``--device_beam``:
              kernel 1 once per utterance, kernels 2 and 3 once per
              forward, picks equal to the CPU's on the card's log-probs
              but near ties, the host ms per utterance of the beam, the
              CTC recompute and the LM; kernel 1 against its plain
              version at the rescoring shape; ``cli.test --transducer
              --beam 4 --lm_rescore`` on phase 19's transducer at its
              JAX defaults (a random one when phase 21 runs alone);
22. moe     - the Mixture-of-Experts FFN (``nn/moe.py``) at full width:
              ``PretrainConfig()`` with 8 experts in layers 1, 3, ...,
              11 (293 M parameters), top-1 at capacity factor 1.25. One
              pretraining step card vs CPU on two rows of 71 428 samples
              (the pretraining gates, ``moe_aux`` within 1e-5, each MoE
              layer's kept tokens per expert equal but for near ties);
              the f32 and bf16 steps at (20, 71 428) beside the dense f32
              step in turns (wall ms, a trace's device ms and idle share,
              peak memory), the launches of one step as the code predicts
              them, one MoE layer's device ms split into router,
              dispatch, expert GEMMs and combine, its forward and
              backward run under ``torch.cuda.set_sync_debug_mode
              ("error")`` (no host read inside the layer); kernels 2,
              2b, 3, 3b, 3c, 4 and 5 against their plain versions at
              that step's shapes (the expert leaves among AdamW's);
              ``cli.train --moe_experts 8 --moe_top_k 2`` from the
              step's weights saved as a pretrained ``.pt``, 2 SGD steps,
              the first frozen: its encoder gradient the aux's alone
              (the routers' non-zero, the last layer's experts' zero),
              kernel 1 once and 2b 12 times in each step; the result
              served by ``cli.transcribe`` on four WAVs of 30-4 s and
              through its loader in f32, bf16 and int8 (one (4, 30 s)
              dispatch each: event ms, launches; the int8 model's
              quantized count the dense model's less two per MoE layer)
              and exported by ``cli.export``, whose log-probs must be
              bitwise the live forward's;
23. dp      - data parallelism (``parallel/sharding.py``): (a)
              ``cli.train --distributed true`` with ``WORLD_SIZE`` 1 over
              NCCL (full width, 4 of the 12 layers, 2 SGD steps, cuDNN's
              deterministic algorithms), whose parameters must be bitwise
              the plain run's, its launches on the path and the NCCL
              all-reduce ms of its gradients;
              (b) two ranks sharing the card over gloo with CUDA tensors
              (spawned, ``setup(backend="gloo")``, a check of gloo's CUDA
              all-gather, ``per_rank``) take 2 SGD CTC steps (every dropout 0.1, the
              span masks on, a padding row) and 2 SGD pretraining steps
              (dropout 0.1) at full wav2vec2-base width (4 of the 12
              layers) on their row blocks: ranks bitwise equal (checksums, parameter samples,
              losses), held to one process's step on the global batches
              (loss 1e-4, gradient norm 1e-3, parameters 1e-6), the gloo
              all-reduce ms; kernels 4, 2, 2b (both semantics), 6 and 6b
              in float32 and bfloat16 with a nonzero row base, and bases
              past the 2**32 wrap, against their plain versions, with
              their ms at base 0 and at the base;
24. orbax   - the JAX package's Orbax checkpoints, read with the port's
              own zstd, OCDBT and zarr readers (no tensorstore on the
              card's machine): (a) the committed
              ``tests/fixtures/orbax_golden`` (written by the JAX
              package) reads bitwise to its ``expected.npz``; its CTC
              TrainState resumes for 2 steps and its pretraining one for
              1 on the card (every dropout 0.1 on the resumed models),
              each first loss held to a CPU resume of the same directory
              on the same batch and seeds (TRAIN_LOSS_RTOL; the
              pretraining loss PRETRAIN_LOSS_RTOL where a Gumbel code
              flips), and the kernels each run launched; (b)
              ``cli.train`` at full width (4 of the 12 layers) for 2 SGD
              steps, ``cli.convert_checkpoint --output_format orbax`` of
              its ``.pt`` and resume file, then one more step resumed
              from the Orbax directory and one from the ``.pt`` (cuDNN's
              deterministic algorithms): losses equal, parameters
              bitwise; ``cli.transcribe`` on the Orbax directory gives
              the ``.pt``'s log-probs bitwise and its text; the reader's
              and the writer's host seconds for the full-width
              directory, its bytes and the phase's bytes written;
25. zero    - ZeRO-1 and FSDP (``parallel/zero.py``): (a) one NCCL rank
              (``WORLD_SIZE`` 1, full width, 4 of the 12 layers, cuDNN's
              deterministic algorithms): ``cli.train --distributed true``
              under ``--zero1`` and ``--fsdp`` (2 AdamW steps each) and
              ``cli.pretrain --fsdp`` (1 step), each run's parameters
              bitwise the plain run's, the launches of kernels 1, 2, 2b,
              3, 4 and 5 and the NCCL reduce-scatter and all-gather ms
              over the flat buffer; (b) two gloo ranks sharing the card
              (the composed collectives on CUDA tensors checked first)
              take 2 AdamW CTC steps under DP, ZeRO-1 and FSDP (every
              dropout 0.1, the span masks on, a padding row) and 2 AdamW
              pretraining steps under DP and FSDP: ranks bitwise equal,
              held to the 2-rank DP run (loss rtol 1e-6, parameters and
              moments 1e-6; the max differences and whether they are 0)
              and to one process's step (loss 1e-4, gradient norm 1e-3;
              parameters 1e-6 after 2 SGD steps under FSDP); kernel 5 on
              a chunk's slices that cross leaves and end in padding
              against its plain version; (c) each rank's persistent
              bytes (parameters, the gradients an update takes, moments),
              a step's peak and the gloo collectives' ms; (d) the 2-rank
              checkpoints equal DP's, one more step resumed from each in
              one plain process gives the DP resume's loss, and
              ``cli.convert_checkpoint --output_format orbax`` of the
              ZeRO-1 one reads back bitwise;
26. tp      - tensor and sequence parallelism (``parallel/tensor.py``):
              (a) kernels 4, 2, 2b, 6 and 6b at a rank's place in a
              larger tensor (kernel 4 on frames from a T offset, bitwise
              its plain version and the whole tensor's draw; 2 and 2b on
              heads 6..11 of 12, both semantics, and 6 and 6b on half the
              heads, against their plain versions and the whole call);
              (b) two gloo ranks sharing the card run ``cli.train`` (2
              unfrozen SGD CTC steps, a checkpoint each) and
              ``cli.pretrain`` (1 SGD step) at full wav2vec2-base width
              and depth, every dropout 0.1, no warmup (every step moves
              every parameter), under ``--distributed true
              --tensor_parallel 2``, sequence parallelism off and on,
              against one process on the card: ranks' replicated
              parameters bitwise equal, losses rtol 1e-4, gradient norms
              1e-3, each parameter's difference within 1e-3 of its
              leaf's largest update plus a float32 rounding of the
              parameter a step (the key biases, whose true gradient is
              0, within 1e-9), the split leaves moved, the saved ``.pt``
              read in one process equal to the run's whole state, the
              launches of kernels 1, 2, 2b, 3 and 4 (pretraining 2, 2b,
              3, 3b, 3c and 4); each rank's
              parameter bytes beside one process's, and the gloo
              all-reduce ms per layer (host-staged on one card: not a
              scaling number);

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
    python3 chip_smoke.py --transducer-phases  # the build and phase 19 only
    python3 chip_smoke.py --ssl-phases       # the build and phase 20 only
    python3 chip_smoke.py --decode-phases    # the build and phase 21 only
    python3 chip_smoke.py --moe-phases       # the build and phase 22 only
    python3 chip_smoke.py --orbax-phases     # the build and phase 24 only
    python3 chip_smoke.py --dp-phases        # the build and phase 23 only
    python3 chip_smoke.py --zero-phases      # the build and phase 25 only
    python3 chip_smoke.py --tp-phases        # the build and phase 26 only
    python3 chip_smoke.py --dp-timing        # rows 2, 2b, 4, 6, 6b only

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
paired corpus itself). ``--transducer-phases`` runs the build and phase
19 alone (it writes the train phase's corpus and warm-starts from a
random CTC model's ``.pt``). ``--ssl-phases`` runs the build and phase
20 alone and ends with the last line of a full run, and
``--decode-phases`` phase 21 likewise (on a random CTC model's
``ctc.pt``), and ``--moe-phases`` phase 22 (it writes its own corpus).
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
import shutil
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


def check_block(phase, b, t, d, heads, lengths, dtype, gen,
                b0: int = 0) -> tuple:
    """The block's forward (with and without the backward's residuals)
    and its nine gradients, through the kernels, vs the plain versions on
    the same inputs, at rates 0 and 0.1, the rows' dropout drawn as rows
    ``b0``.. of a larger batch; every row is compared, a zero-length row
    included; a second backward must be bitwise equal to the first, and
    the GEMM kernels must be the shape's route (:func:`check_block_route`).
    Returns the largest forward and gradient errors."""
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
        out = attention_block(*xs, kv, heads, scale, rate, seed, b0)
        got = torch.autograd.grad(out, xs, dy, retain_graph=True)
        again = torch.autograd.grad(out, xs, dy)
        check(all(torch.equal(g1, g2) for g1, g2 in zip(got, again)),
              f"attention_block_bwd {(b, t, d, heads)} {dtype} rate {rate}: "
              "repeated backward calls differ")
        if route is None:
            route = check_block_route(
                b, t, d, heads, dtype,
                lambda: torch.autograd.grad(attention_block(
                    *xs, kv, heads, scale, rate, seed, b0), xs, dy))
        with torch.no_grad():
            evaluated = attention_block(x, *weights, kv, heads, scale, rate,
                                        seed, b0)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = attention_block_plain(x, *weights, kv, heads, scale, rate,
                                         seed, b0)
            want_g = attention_block_bwd_plain(x, *weights, kv, heads, scale,
                                               rate, seed, dy, b0=b0)
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
              "key_lengths": lengths, "rate": rate, "b0": b0,
              "gemm_route": route,
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
                          dropout: float = 0.0, moe: dict = None) -> dict:
    """One full-width pretraining step on two rows of ``samples`` (the
    pretraining run's length; dropout off; masks, Gumbel noise and
    negatives from the same seeds) on the card and on the CPU from the
    same weights: loss, contrastive loss, accuracy, gradient norm, and
    the share of Gumbel codeword indices that agree. ``fused="block"``:
    the same step through the attention block (phase ``block_vs_cpu``);
    ``fused=True`` with ``dropout`` 0.1: the core in the TPU kernel's
    semantics with every dropout on, both sides drawing the same seeds
    (phase ``kernel_vs_cpu``). ``moe``: the MoE fields of the config
    (phase ``moe_vs_cpu``): also ``moe_aux`` within MOE_AUX_RTOL and each
    MoE layer's kept tokens per expert equal but for near ties
    (:func:`moe_routing`). Returns the emitted line."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    cfg = PretrainConfig(dropout=dropout, dropout_input=dropout,
                         dropout_features=dropout, fused_attention=fused,
                         **(moe or {}))
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
        routing = []
        with moe_routing(routing):
            _, metrics = train_step(state, torch.from_numpy(sig).to(dev),
                                    seeds, torch.Generator())
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
        out[name].update(codes=codes[0], slots=slots[0], routing=routing)
        if moe:
            out[name]["moe_aux"] = float(metrics["moe_aux"])
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
        fused, "moe_vs_cpu" if moe else "pretrain_vs_cpu")
    extra = moe_vs_cpu_fields(g, c) if moe else {}
    line = {"phase": phase, "fused_attention": fused, "dropout": dropout,
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
          "codeword_agreement_min": CODE_AGREEMENT, **extra}
    emit(line)
    if moe:
        check(not extra["moe_failures"], f"moe_vs_cpu: "
              f"{extra['moe_failures']}")
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
    return line


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
# the seq2seq and paired runs (and the text warm start) keep 6 of the
# encoder's 12 layers, and the large layouts 6 of 24: depth cuts that
# keep the full run inside its time limit since phases 23 and 25 came
CUT_LAYERS = "6"
SEQ2SEQ_FLAGS = ["--num_layers", CUT_LAYERS,
                 "--target_tokens_per_batch", "700000", "--grad_accum", "2",
                 "--train_steps", "6", "--unfreeze_enc_after_step", "3",
                 "--warmup_steps", "2", "--steps_per_checkpoint", "6",
                 "--valid_steps", "0", "--num_train_workers", "4"]
VALID_BEAM = 4
PAIRED_ROWS = 8
PAIRED_FLAGS = ["--num_layers", CUT_LAYERS,
                "--train_steps", "6", "--unfreeze_audio_after_step", "3",
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

    def dropout(x, rate, seed, *index):
        calls["dropout"].append(tuple(x.shape))
        return real[2](x, rate, seed, *index)

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
# (30 s until phase 19 came, 15 s until phase 22 came)
STEP_RETRY_BUDGET_S = 5.0
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

    emit({"phase": "seq2seq", "config": "wav2vec2-base encoder d768 h12 L6 "
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

    emit({"phase": "paired", "config": "audio wav2vec2-base d768 h12 L6 "
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
TOPO_LAYERS = 6  # of the presets' 24 (a depth cut for the time limit)
TOPO_LENGTHS = [30 * SR, 24 * SR, 11 * SR, 4 * SR]  # one (4, 30 s) dispatch
# the LV-60 runs keep 6 of the preset's 24 layers (a depth cut that
# makes room for phases 23 and 25 in the run's time and disk-write limits)
LV60_LAYERS = "6"
LV60_PRETRAIN_FLAGS = ["--preset", "large-lv60", "--num_layers", LV60_LAYERS,
                       "--tokens_per_batch",
                       "700000", "--max_sample_len", "250000",
                       "--train_steps", "2", "--steps_per_checkpoint", "2",
                       "--warmup_steps", "1", "--num_train_workers", "4"]
# both CTC runs step SGD: their resume files hold no moments, which keeps
# the full run's disk writes under the machine's 45 GiB cap (each save
# of the f32 run wrote 3.8 GB on AdamW; kernel 5 runs at LV-60's 317 M
# parameters in the pretraining run)
LV60_TRAIN_FLAGS = ["--preset", "large-lv60", "--num_layers", LV60_LAYERS,
                    "--layer_drop", "0.1",
                    "--target_tokens_per_batch", "700000", "--grad_accum",
                    "1", "--train_steps", "4", "--unfreeze_enc_after_step",
                    "1", "--warmup_steps", "2", "--valid_steps", "1",
                    "--optim", "sgd"]
LV60_PATH = ("conv_k3s2_fwd", "conv_k3s2_dgrad", "conv_k3s2_wgrad",
             "attention_fwd", "attention_bwd", "ctc_loss", "dropout",
             "adamw")
LV60_BLOCK_STEPS = 2
LV60_SIZE = dict(d_model=1024, d_ff=4096, num_heads=16,
                 num_layers=int(LV60_LAYERS),
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
            cfg = preset_config(preset, 4 + len(LETTERS),
                                num_layers=TOPO_LAYERS)
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
    4 steps in f32 and in bf16 (both on SGD); one unfrozen step card vs
    CPU at the same weights (``layer_drop`` 0, the train_vs_cpu gates); kernels
    1, 2, 2b, 3, 3b, 3c, 4 and 5 against their plain versions at every
    shape the runs gave them. Returns the launch counts, the max errors and the
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
                if k not in ("conv_k3s2_dgrad", "conv_k3s2_wgrad",
                             "adamw"):
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
    batches' shapes (a block forward and backward per layer a step, no core
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
# (120 s until phase 19 came: a run that spent it all took 1 104 s of the
# script's 1 200 s budget; 45 s until phase 22 came, whose full runs took
# 903.8 and 1 198.7 s on two H100 machines; a row past it takes
# CUDA-event times)
RETRY_BUDGET_S = 20.0
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


def dp_timing(gen) -> int:
    """The timing rows of the kernels whose hashes take a row base since
    data parallelism came, 2 and 2b (both semantics, the serving and
    training shapes), 4 and 6, 6b, in float32 and bfloat16, alone
    (``--dp-timing``). It drives only the wrappers' arguments that every
    tree of the port has had, so a copy placed in another tree's root
    times that tree (two trees in turns in one call)."""
    from audio8_tpu_torch.csrc.build import build

    t0 = time.perf_counter()
    build(("attention_fwd.cu", "attention_bwd.cu", "dropout.cu",
           "attention_block_fwd.cu", "attention_block_bwd.cu"))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "tree": HERE})
    for dtype in (torch.float32, torch.bfloat16):
        rows = dict(time_attention(dtype, gen))
        torch.cuda.empty_cache()
        rows.update({**time_dropout(dtype, gen), **time_block(dtype, gen)})
        torch.cuda.empty_cache()
        for name, r in rows.items():
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
        named = g.items() if isinstance(g, dict) else zip(state.names, g)
        grads.update({n: t.detach().cpu() for n, t in named})
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

# ----------------------------------------------------------------- RNN-T

# the kernels of the transducer's training path (the extractor frozen, as
# cli.train_transducer's default --freeze_fx): 2, 2b, 3, 4 and 5
RNNT_PATH = ("conv_k3s2_fwd", "attention_fwd", "attention_bwd", "dropout",
             "adamw")
# the model: the JAX defaults at full width (wav2vec2-base encoder, a
# 2 x 512 LSTM predictor on 256-wide embeddings, a 512-wide joint)
RNNT_SIZE: list = []
RNNT_FLAGS = ["--target_tokens_per_batch", "700000", "--grad_accum", "2",
              "--warmup_steps", "2", "--valid_steps", "0",
              "--num_train_workers", "4", "--max_decode_len", "200"]
# the f32 run (autograd loss), the fused-loss run and the bf16 run: 2
# steps each, 1 frozen, the fused one validating with a beam. Each run
# checkpoints at both steps (1.2 GB each with AdamW's moments); to keep
# the full run's disk writes down (over 40 GB in all), the fused and bf16
# runs step SGD, whose resume files hold no moments (0.4 GB)
RNNT_RUNS = {"f32": ["--train_steps", "2", "--unfreeze_enc_after_step", "0",
                     "--steps_per_checkpoint", "2"],
             "fused": ["--train_steps", "2", "--unfreeze_enc_after_step",
                       "0", "--steps_per_checkpoint", "2", "--fused_loss",
                       "true", "--valid_beam", "4", "--optim", "sgd"],
             "bf16": ["--train_steps", "2", "--unfreeze_enc_after_step",
                      "0", "--steps_per_checkpoint", "2", "--bf16",
                      "--optim", "sgd"]}
RNNT_BENCH = (16, 41_359, 64)  # bench.py:bench_transducer's rows, samples, U
RNNT_REQUESTS = 2  # the served requests phase 19 decodes (3.1, 12.4 s)
RNNT_CPU_REQUESTS = 1  # of them, those whose greedy tokens the CPU checks
RNNT_STREAMED = 1  # the one the streamer decodes
RNNT_BEAM = 4
RNNT_BEAM_SECONDS = (5.0, 3.1)  # the clips the beam search runs on
RNNT_DECODE_ROWS = 4  # the decode-cost batch: 4 rows of 30 s
RNNT_SYNC_FRAMES = 64  # one decode window under the sync check
RNNT_MAX_SYMBOLS = 4  # --max_symbols_per_frame's default


RNNT_VALID = "rnnt_valid.tsv"  # the validation manifest phase 19 decodes
RNNT_VALID_SAMPLES = 2 * SR  # its one clip: the shortest one's first 2 s


def rnnt_sources(tmp: str, seed: int) -> tuple:
    """The train phase's corpus and CTC checkpoint (a random CTC model
    saved in fairseq's layout when the phase runs alone), and beside the
    corpus' manifests RNNT_VALID: the first 2 s of its shortest
    validation utterance with as many of its letters (the validations
    and ``cli.test`` decode it: a beam validation of the whole set took
    9 s)."""
    from audio8_tpu_torch.models.convert import save_fairseq_ctc
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    corpus = os.path.join(tmp, "corpus")
    if not os.path.isdir(corpus):
        os.makedirs(corpus)
        write_corpus(corpus, seed)
    ckpt = os.path.join(tmp, "run", "checkpoint-step-6.pt")
    if not os.path.exists(ckpt):
        ckpt = os.path.join(tmp, "rnnt_warm_start.pt")
        save_fairseq_ctc(Wav2Vec2AcousticModel(base_config(
            4 + len(LETTERS)), generator=torch.Generator().manual_seed(
                seed + 40)), ckpt)
    from scipy.io import wavfile

    with open(os.path.join(corpus, "valid.tsv")) as fh:
        root, *rows = fh.read().splitlines()
    with open(os.path.join(corpus, "valid.ltr")) as fh:
        texts = fh.read().splitlines()
    i = min(range(len(rows)), key=lambda j: int(rows[j].split("\t")[1]))
    name, n = rows[i].split("\t")
    _, pcm = wavfile.read(os.path.join(root, name))
    keep = min(int(n), RNNT_VALID_SAMPLES)
    wavfile.write(os.path.join(root, "rnnt_valid0.wav"), SR, pcm[:keep])
    letters = texts[i].split()
    stem = os.path.splitext(RNNT_VALID)[0]
    with open(os.path.join(corpus, RNNT_VALID), "w") as fh:
        fh.write(f"{root}\nrnnt_valid0.wav\t{keep}\n")
    with open(os.path.join(corpus, f"{stem}.ltr"), "w") as fh:
        fh.write(" ".join(letters[:len(letters) * keep // int(n)]) + " |\n")
    return corpus, ckpt


def counted_dropouts(run) -> int:
    """The hash-dropout calls ``run()`` makes (a training forward of a
    copy at width 32 on the CPU): what the code predicts kernel 4's
    launches per forward to be."""
    import audio8_tpu_torch.nn.dropout as nn_dropout

    calls, real = [], nn_dropout.fused_dropout
    nn_dropout.fused_dropout = lambda x, r, s, *index: calls.append(1) or \
        real(x, r, s, *index)
    try:
        with torch.no_grad():
            run()
    finally:
        nn_dropout.fused_dropout = real
    return len(calls)


def small_copy(cfg, **over):
    """``cfg`` at width 32 with a two-layer 32-channel extractor: the same
    layers and rates, cheap on the CPU."""
    import dataclasses

    return dataclasses.replace(cfg, d_model=32, num_heads=2, d_ff=64,
                               custom_conv_features=((32, 10, 5),
                                                     (32, 3, 2)), **over)


def encoder_dropouts(cfg) -> int:
    """The encoder's hash-dropout calls in one training forward."""
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder

    model = Wav2Vec2Encoder(small_copy(cfg, timestep_masking=0.0,
                                       channel_masking=0.0))
    return counted_dropouts(lambda: model(
        torch.zeros(2, 400), torch.tensor([400, 300]),
        torch.Generator().manual_seed(0)))


def rnnt_train(tmp: str, corpus: str, ckpt: str) -> dict:
    """``cli.train_transducer`` from ``ckpt`` on ``corpus``: the three
    RNNT_RUNS, each micro-step's launches held to the code's prediction
    (kernel 2 once a layer, 2b once a layer when unfrozen, 3 once a k3s2
    layer, 4 the encoder's dropouts and the predictor's 1 + pred_layers
    forward, and again in the backward: the predictor's always, the
    encoder's when unfrozen; 5 once an AdamW update, never under SGD).
    Returns each run's
    summary and the f32 run's state and launches."""
    from audio8_tpu_torch.cli import train_transducer as rnnt_cli

    out = {}
    for name, flags in RNNT_RUNS.items():
        basedir = os.path.join(tmp, f"rnnt_{name}")
        records = []
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with per_call_launches(rnnt_cli, "make_transducer_steps", records):
            state = rnnt_cli.train([
                "--root_dir", corpus, "--train_dataset", "train.tsv",
                "--valid_dataset", RNNT_VALID, "--basedir", basedir,
                "--device", "cuda", "--restart_from", ckpt, *RNNT_SIZE,
                *RNNT_FLAGS, *flags])
        wall = time.perf_counter() - t0
        sgd = "sgd" in flags
        launches = {k: n for k, n in read_launches().items()
                    if k in RNNT_PATH and not (sgd and k == "adamw")}
        cfg = state.model.config
        steps = int(flags[flags.index("--train_steps") + 1])
        log = state.log
        check(state.step == steps and len(log) == steps,
              f"rnnt {name}: {state.step} steps")
        check(all(math.isfinite(r["loss"]) for r in log),
              f"rnnt {name}: non-finite loss")
        check(any(r["frozen"] for r in log) and not all(
            r["frozen"] for r in log), f"rnnt {name}: freeze schedule")
        bwd = check_path_launches(f"rnnt_{name}", launches, records,
                                  "freeze")
        # kernel 4 runs again in the backward of every dropout whose
        # input needs a gradient: the predictor's always, the encoder's
        # when unfrozen
        enc_drop, pred_drop = encoder_dropouts(cfg), 1 + cfg.pred_layers
        k3s2 = sum(1 for _, k, s in cfg.conv_features if (k, s) == (3, 2))
        for flags_, d in records:
            frozen = flags_["freeze"]
            want = {"attention_fwd": cfg.num_layers, "conv_k3s2_fwd": k3s2,
                    "attention_bwd": 0 if frozen else cfg.num_layers,
                    "dropout": enc_drop * (1 if frozen else 2)
                    + 2 * pred_drop}
            got = {k: d[k] for k in want}
            check(got == want, f"rnnt {name} micro-step launches {got} "
                  f"against the prediction {want}")
        adamw = read_launches()["adamw"]
        check(adamw == (0 if sgd else steps), f"rnnt {name}: adamw "
              f"{adamw} launches for {steps} updates")
        check(len(state.valid) >= 1 and all(
            math.isfinite(v["wer"]) for v in state.valid),
            f"rnnt {name}: validation {state.valid}")
        out[name] = {"step_seconds": [r["seconds"] for r in log],
                     "losses": [r["loss"] for r in log],
                     "frozen": [r["frozen"] for r in log], "wall_s": wall,
                     "launches": launches,
                     "micro_steps": len(records),
                     "predicted_per_micro_step": {
                         "attention_fwd": cfg.num_layers,
                         "attention_bwd_unfrozen": cfg.num_layers,
                         "conv_k3s2_fwd": k3s2,
                         "dropout_frozen": enc_drop + 2 * pred_drop,
                         "dropout_unfrozen": 2 * (enc_drop + pred_drop)},
                     "attention_bwd_per_micro_step": bwd,
                     "valid": state.valid,
                     "peak_memory_gb": torch.cuda.max_memory_allocated()
                     / 1e9}
        if name == "f32":
            f32 = (state, launches)
        del state
        torch.cuda.empty_cache()
    return out, f32


def rnnt_batch(seed: int, vocab_size: int, rows=None, samples=None,
               labels=None) -> dict:
    """Two rows of 3.0 and 2.6 s with 42 and 36 letters (PAD after), or
    ``rows`` full rows of ``samples`` with ``labels`` letters each."""
    from audio8_tpu_torch.utils import Offsets

    rng = np.random.default_rng(seed)
    if rows is None:
        lengths, tl = np.array([48_000, 41_000]), np.array([42, 36])
    else:
        lengths, tl = np.full(rows, samples), np.full(rows, labels)
    sig = np.zeros((len(lengths), lengths.max()), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = synthetic_speechlike((n + 1) / SR, rng)[:n]
    tok = np.full((len(tl), tl.max()), Offsets.PAD, np.int64)
    for i, n in enumerate(tl):
        tok[i, :n] = rng.integers(4, vocab_size, size=n)
    return {"signal": torch.from_numpy(sig),
            "signal_lengths": torch.from_numpy(lengths),
            "token_ids": torch.from_numpy(tok),
            "token_lengths": torch.from_numpy(tl)}


def rnnt_model(cfg, weights: dict, dtype, device: str):
    from audio8_tpu_torch.models.transducer import Transducer

    model = Transducer(cfg, dtype)
    model.load_state_dict(weights)
    return model.to(device)


def rnnt_vs_cpu(cfg, weights: dict, seed: int) -> dict:
    """One unfrozen f32 step (dropout and masking off) on the card and on
    the CPU from the trained weights, for each loss route: loss within
    TRAIN_LOSS_RTOL, gradient norm within TRAIN_GNORM_RTOL."""
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_transducer_steps

    batch = rnnt_batch(seed + 41, cfg.vocab_size)
    out = {}
    for fused in (False, True):
        res = {}
        for dev in ("cuda", "cpu"):
            model = rnnt_model(cfg, weights, torch.float32, dev)
            state = TrainState(model, create_optimizer(create_lrs(
                1e-5, 10, "constant", warmup_steps=0)))
            grad_fn, update_fn, _, _ = make_transducer_steps(
                model, fused_loss=fused)
            loss, grads, rows, _ = grad_fn(
                {k: v.to(dev) for k, v in batch.items()}, None,
                freeze=False)
            _, gnorm = update_fn(state, grads, rows)
            res[dev] = (float(loss), float(gnorm))
            del model, state, grads
        (l_g, n_g), (l_c, n_c) = res["cuda"], res["cpu"]
        out["fused" if fused else "autograd"] = {
            "loss": [l_g, l_c], "gnorm": [n_g, n_c],
            "loss_rel_err": rel(l_g, l_c), "gnorm_rel_err": rel(n_g, n_c)}
        check(rel(l_g, l_c) <= TRAIN_LOSS_RTOL,
              f"rnnt fused={fused}: step loss card vs CPU {rel(l_g, l_c)}")
        check(rel(n_g, n_c) <= TRAIN_GNORM_RTOL,
              f"rnnt fused={fused}: step gnorm card vs CPU {rel(n_g, n_c)}")
        torch.cuda.empty_cache()
    return dict(out, loss_rtol=TRAIN_LOSS_RTOL, gnorm_rtol=TRAIN_GNORM_RTOL,
                rows_s=[3.0, 41_000 / SR])


def rnnt_timing(cfg, weights: dict, seed: int) -> tuple:
    """bench_transducer's step ((16, 41 359) samples, U 64, V 32,
    dropout 0.1, masking 0.5 and 0.1, unfrozen) in f32 and bf16 in turns
    (f32, bf16, bf16, f32): wall ms and peak memory, and in the first
    turn of each dtype the device ms and idle share of a trace;
    the loss's device ms at its (16, T', 65, 32) log-probs, forward and
    forward + backward, each route. Returns the timings and the path
    shapes of one f32 step."""
    import dataclasses

    from audio8_tpu_torch.ops.transducer import transducer_loss
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_transducer_steps

    rows, samples, labels = RNNT_BENCH
    bcfg = dataclasses.replace(cfg, dropout=0.1, timestep_masking=0.5,
                               channel_masking=0.1)
    batch = {k: v.cuda() for k, v in rnnt_batch(
        seed + 42, cfg.vocab_size, rows, samples, labels).items()}
    gen = torch.Generator().manual_seed(seed + 42)
    out, calls, runs = {"shape": [rows, samples, labels]}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        model = rnnt_model(bcfg, weights, dt, "cuda")
        runs[dt] = (model, TrainState(model, create_optimizer(create_lrs(
            1e-5, 100, "constant", warmup_steps=0))),
            make_transducer_steps(model)[0])
    for turn, dt in enumerate((torch.float32, torch.bfloat16,
                               torch.bfloat16, torch.float32)):
        model, state, grad_fn = runs[dt]

        def step(st, flags, grad_fn=grad_fn):
            grad_fn.train_step(st, batch, gen, **flags)

        if turn == 0:
            with recorded_path_calls(calls):
                step(state, {"freeze": False})
            params = [tuple(p.shape) for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 1e9  # both models
        if turn < 2:  # the first turn of each dtype is traced too
            t = step_timings(state, step, {"unfrozen": {"freeze": False}},
                             n=3)["unfrozen"]
        else:
            t = {"wall_ms": []}
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, {"freeze": False})
                torch.cuda.synchronize()
                t["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        t["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        t["resident_gb"] = resident
        out.setdefault(str(dt).split(".")[1], []).append(t)
        if turn == 0:
            with torch.no_grad():
                lp, mask = model(batch["signal"], batch["signal_lengths"],
                                 batch["token_ids"], gen, freeze=False)
            lp = lp.detach().requires_grad_()
            frames = mask.sum(-1)
            loss = {"log_probs": list(lp.shape)}
            for fused in (False, True):
                args = (lp, frames, batch["token_ids"],
                        batch["token_lengths"])

                def fwd():
                    with torch.no_grad():
                        transducer_loss(*args, reduction="sum", fused=fused)

                def fwd_bwd():
                    transducer_loss(*args, reduction="sum",
                                    fused=fused).backward()
                    lp.grad = None

                name = "fused" if fused else "autograd"
                loss[name] = {"fwd": traced_window(fwd),
                              "fwd_bwd": traced_window(fwd_bwd)}
            out["loss"] = loss
            del lp
    del runs, model, state, grad_fn
    torch.cuda.empty_cache()
    step_ms = out["float32"][0]["device_ms"]
    for name in ("autograd", "fused"):
        fb = out["loss"][name]["fwd_bwd"]
        out["loss"][name]["share_of_f32_step"] = (
            fb["device_ms"] / step_ms if fb and step_ms else None)
    return out, path_shapes(calls), params


def rnnt_greedy_tie(cpu_model, enc: torch.Tensor, mine: tuple,
                    theirs: tuple) -> float:
    """The CPU's log-prob margin at the first (frame, round) where two
    timed greedy decodes of one row part: its own choice (a label, or
    blank, moving on) over the other's, the state replayed from the
    shared prefix. ``mine``/``theirs``: (tokens, frames) lists."""
    from audio8_tpu_torch.utils import Offsets

    (t_m, f_m), (t_t, f_t) = mine, theirs
    i = next((j for j in range(min(len(t_m), len(t_t)))
              if (t_m[j], f_m[j]) != (t_t[j], f_t[j])),
             min(len(t_m), len(t_t)))
    frame = min(f_m[i] if i < len(t_m) else 10 ** 9,
                f_t[i] if i < len(t_t) else 10 ** 9)
    with torch.no_grad():
        tokens = torch.full((1, len(t_m) + 1), Offsets.PAD,
                            dtype=torch.int32)
        n = torch.zeros((1,), dtype=torch.int32)
        pred, carry = cpu_model.decode_init(1)
        _, _, pred, carry = cpu_model.decode_frames(
            enc[None, :frame], torch.tensor([frame]), tokens, n, pred,
            carry, RNNT_MAX_SYMBOLS)
        for j in range(i):  # the shared emissions inside the frame
            if f_m[j] == frame:
                pred, carry = cpu_model.predictor.step(
                    carry, torch.tensor([t_m[j]]))
        lp = torch.log_softmax(cpu_model.joint.single(
            enc[None, frame], pred), dim=-1)[0]

    def choice(toks, frames):
        return (toks[i] if i < len(toks) and frames[i] == frame
                else Offsets.GO)

    return float(lp[choice(t_m, f_m)] - lp[choice(t_t, f_t)])


def rnnt_emitting(cfg, weights: dict, wav: np.ndarray) -> tuple:
    """The trained weights made to emit: a few steps of training teach
    blank first and the letters' frequencies in the output bias, so the
    model would decode nothing, or one letter at every frame. The
    joint's label biases are set to their mean, and the blank's lowered
    by a quantile of its margin over the best label on ``wav``'s frames
    at the predictor's start state: the median, a quarter or a tenth,
    the first that decodes ``wav`` to at least one token and at most one
    a frame. Returns (weights, the blank's shift, the quantile)."""
    from audio8_tpu_torch.utils import Offsets

    bias = weights["joint.out.bias"].clone()
    labels = torch.arange(len(bias)) != Offsets.GO
    bias[labels] = bias[labels].mean()
    weights = dict(weights, **{"joint.out.bias": bias})
    model = rnnt_model(cfg, weights, torch.float32, "cuda").eval()
    sig = torch.from_numpy(wav)[None].cuda()
    lens = torch.tensor([len(wav)], device="cuda")
    with torch.no_grad():
        enc, frames = model.encode(sig, lens)
        pred, _ = model.decode_init(1)
        logits = model.joint.single(enc[0], pred.expand(enc.shape[1], -1))
        margin = logits[:, Offsets.GO] - logits[:, labels.cuda()].max(-1)[0]
        for q in (0.5, 0.25, 0.1):
            shift = float(torch.quantile(margin, q))
            model.joint.out.bias[Offsets.GO] = bias[Offsets.GO] - shift
            _, n = model.decode(sig, lens, int(frames[0]) + 1,
                                RNNT_MAX_SYMBOLS)
            if 0 < int(n[0]) <= int(frames[0]):
                break
    check(0 < int(n[0]) <= int(frames[0]),
          f"rnnt: no blank shift decodes to one token a frame or fewer")
    bias[Offsets.GO] -= shift
    del model
    return weights, shift, q


def rnnt_decode(tmp: str, corpus: str, cfg, weights: dict, seed: int
                ) -> dict:
    """The decode paths at full width from the trained f32 weights (the
    blank bias lowered, :func:`rnnt_emitting`; the CLIs read them from a
    transducer ``.pt``):
    greedy over the serve phase's requests (30 s chunks stitched) with
    the CPU's tokens on the first RNNT_CPU_REQUESTS (near ties allowed,
    TIE_MARGIN), the timed decode, the ``TransducerStreamer`` against
    the offline stitch, beam RNNT_BEAM on short clips against the CPU,
    the decode loops under ``torch.cuda.set_sync_debug_mode("error")``,
    ``cli.serve --transducer`` (``/transcribe`` and one ``/stream``),
    ``cli.test --transducer`` greedy and beam, ``cli.export
    --transducer`` and ``--exported`` in transcribe, serve and test; and
    the greedy and beam decode costs."""
    from scipy.io import wavfile

    from audio8_tpu_torch.cli import export as export_cli
    from audio8_tpu_torch.cli import test as test_cli
    from audio8_tpu_torch.cli import transcribe
    from audio8_tpu_torch.cli.transcribe import transducer_stream_fns
    from audio8_tpu_torch.models.text import read_vocab_list
    from audio8_tpu_torch.ops.metrics import postproc_letters
    from audio8_tpu_torch.serve import ChunkedTranscriber, TransducerStreamer
    from audio8_tpu_torch.utils import Offsets

    out = {}
    wavs = [wav_of(b) for b in serve_bodies(seed)]
    weights, shift, q = rnnt_emitting(cfg, weights, wavs[0])
    out["blank_bias_lowered_by"] = {"shift": shift, "quantile": q}
    ckpt = os.path.join(tmp, "rnnt_decode.pt")
    torch.save({"kind": "transducer", "model": weights}, ckpt)
    gpu = rnnt_model(cfg, weights, torch.float32, "cuda").eval()
    cpu = rnnt_model(cfg, weights, torch.float32, "cpu").eval()
    encode, decode_init, decode_frames = transducer_stream_fns(
        gpu, RNNT_MAX_SYMBOLS)
    # (1, chunk) dispatches, as the streamer's: a batch of other rows may
    # round the features otherwise
    ct = ChunkedTranscriber(encode, cfg.conv_features,
                            chunk_samples=30 * SR, context_samples=2 * SR,
                            batch_size=1, device="cuda")
    budget = 8000
    greedy, ties = [], []
    t0 = time.perf_counter()
    feats = [ct.log_probs(w) for w in wavs[:RNNT_REQUESTS]]
    for r, f in enumerate(feats):
        enc = torch.from_numpy(f)
        state = []
        for dev, model in (("cuda", gpu), ("cpu", cpu))[
                :1 + (r < RNNT_CPU_REQUESTS)]:
            with torch.inference_mode():
                tok, n, _, _, (times, _) = model.decode_frames(
                    enc[None].to(dev), torch.tensor([len(f)], device=dev),
                    torch.full((1, budget), Offsets.PAD, dtype=torch.int32,
                               device=dev),
                    torch.zeros((1,), dtype=torch.int32, device=dev),
                    *model.decode_init(1, torch.device(dev)),
                    RNNT_MAX_SYMBOLS,
                    extra=(torch.full((1, budget), -1, dtype=torch.int32,
                                      device=dev),
                           torch.zeros((1, budget), device=dev)))
            k = int(n[0])
            state.append((tok[0, :k].tolist(), times[0, :k].tolist()))
        greedy.append(state[0][0])
        if len(state) == 2 and state[0] != state[1]:
            margin = rnnt_greedy_tie(cpu, enc, state[1], state[0])
            ties.append({"request": r, "margin": margin})
            check(abs(margin) <= TIE_MARGIN, f"rnnt greedy request {r}: "
                  f"card and CPU differ beyond a tie ({margin})")
    out["greedy"] = {"seconds": SERVE_SECONDS[:RNNT_REQUESTS],
                     "tokens": [len(g)
                                                          for g in greedy],
                     "cpu_checked": RNNT_CPU_REQUESTS, "near_ties": ties,
                     "wall_s": time.perf_counter() - t0}
    check(sum(len(g) for g in greedy) > 0, "rnnt: nothing decoded")

    # the streamer, fed 0.5 s blocks, against the offline stitch
    w = wavs[RNNT_STREAMED]
    st = TransducerStreamer(encode, decode_init, decode_frames,
                            cfg.conv_features, chunk_samples=30 * SR,
                            context_samples=2 * SR, window_frames=256,
                            max_output_len=budget, device="cuda")
    for i in range(0, len(w), SR // 2):
        st.feed(w[i:i + SR // 2])
    check(st.finish().tolist() == greedy[RNNT_STREAMED],
          "rnnt: the streamer differs from the offline stitch")

    # the greedy cost at (4, 30 s), and the timed decode of the first
    # request
    sig = torch.from_numpy(np.stack([
        np.resize(wavs[1], 30 * SR) for _ in range(RNNT_DECODE_ROWS)])).cuda()
    lens = torch.full((RNNT_DECODE_ROWS,), 30 * SR, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu.decode(sig, lens, 200, RNNT_MAX_SYMBOLS)
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    tsig = torch.from_numpy(wavs[0])[None].cuda()
    tlens = torch.tensor([len(wavs[0])], device="cuda")
    tok, n = gpu.decode(tsig, tlens, budget, RNNT_MAX_SYMBOLS)
    ttok, tn, times, lps = gpu.decode(tsig, tlens, budget, RNNT_MAX_SYMBOLS,
                                      timed=True)
    k = int(tn[0])
    ts = times[0, :k].tolist()
    check(torch.equal(tok, ttok) and torch.equal(n, tn) and k > 0
          and ts == sorted(ts) and all(0 <= t for t in ts)
          and bool((lps[0, :k] <= 0).all()),
          f"rnnt: timed decode ({k} tokens, frames {ts[:8]})")
    with torch.inference_mode():
        frames = int(gpu.encode(sig[:1], lens[:1])[0].shape[1])
    out["decode_cost"] = {
        "greedy_batch": [RNNT_DECODE_ROWS, 30 * SR],
        "greedy_ms_per_utterance": 1e3 * g_s / RNNT_DECODE_ROWS,
        "greedy_audio_s_per_s": 30 * RNNT_DECODE_ROWS / g_s,
        "frames": frames, "rounds_per_frame": RNNT_MAX_SYMBOLS}

    # beam RNNT_BEAM on short clips: the card's 1-best against the CPU's
    rng = np.random.default_rng(seed + 43)
    clips = [synthetic_speechlike(s, rng) for s in RNNT_BEAM_SECONDS]
    bsig = np.zeros((len(clips), max(map(len, clips))), np.float32)
    for i, c in enumerate(clips):
        bsig[i, :len(c)] = c
    blens = torch.tensor([len(c) for c in clips])
    res = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, bn, scores = model.decode_beam(
            torch.from_numpy(bsig).to(dev), blens.to(dev), RNNT_BEAM, 200,
            RNNT_MAX_SYMBOLS)
        torch.cuda.synchronize()
        res[dev] = (toks.cpu(), bn.cpu(), scores.cpu(),
                    time.perf_counter() - t0)
    beam_ties = []
    (gt, gn, gs, g_s), (ct_, cn, cs, _) = res["cuda"], res["cpu"]
    for row in range(len(clips)):
        mine = gt[row, 0, :gn[row, 0]].tolist()
        if mine == ct_[row, 0, :cn[row, 0]].tolist():
            continue
        found = [j for j in range(RNNT_BEAM)
                 if ct_[row, j, :cn[row, j]].tolist() == mine]
        margin = float(cs[row, 0] - cs[row, found[0]]) if found else None
        limit = TIE_MARGIN * max(1, len(mine))
        beam_ties.append({"row": row, "margin": margin, "limit": limit})
        check(margin is not None and margin <= limit,
              f"rnnt beam row {row}: card and CPU 1-best differ beyond a "
              f"tie ({margin})")
    out["beam"] = {"beam": RNNT_BEAM, "seconds": list(RNNT_BEAM_SECONDS),
                   "tokens": gn[:, 0].tolist(),
                   "score_max_abs_diff": float((gs - cs).abs().max()),
                   "near_ties": beam_ties,
                   "ms_per_utterance": 1e3 * g_s / len(clips)}

    # nothing in the decode loops synchronises with the host
    with torch.inference_mode():
        f0 = torch.from_numpy(feats[1][:RNNT_SYNC_FRAMES])[None].cuda()
        benc, bframes = gpu.encode(torch.from_numpy(bsig).cuda(),
                                   blens.cuda())
        st0 = (torch.full((1, 200), Offsets.PAD, dtype=torch.int32,
                          device="cuda"),
               torch.zeros((1,), dtype=torch.int32, device="cuda"),
               *gpu.decode_init(1))
        frames0 = torch.tensor([RNNT_SYNC_FRAMES], device="cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gpu.decode_frames(f0, frames0, *st0, RNNT_MAX_SYMBOLS)
            gpu.beam_search(benc, bframes, RNNT_BEAM, 200, RNNT_MAX_SYMBOLS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["no_host_sync"] = {"decode_frames_window": RNNT_SYNC_FRAMES,
                           "beam_search_frames": int(benc.shape[1])}

    # the entry points over the f32 run's checkpoint
    dict_file = os.path.join(corpus, "dict.ltr.txt")
    live = ["--checkpoint", ckpt, "--dict_file", dict_file, *RNNT_SIZE]
    files = [os.path.join(tmp, "rnnt_request0.wav")]
    with open(files[0], "wb") as fh:
        fh.write(serve_bodies(seed)[0])
    with contextlib.redirect_stdout(io.StringIO()):
        texts = [t for _, t in transcribe.main(
            files + live + ["--transducer", "true", "--chunk_seconds",
                            "30"])]
    Offsets.remap_fairseq_ctc()
    i2v = dict(enumerate(read_vocab_list(dict_file)))
    want = [postproc_letters([i2v[t] for t in greedy[0]])]
    check(texts == want, f"rnnt transcribe {texts} != {want}")
    served = rnnt_serve(live + ["--transducer", "true"], seed, want[0])
    evals = {}
    for beam in (1, RNNT_BEAM):
        with contextlib.redirect_stdout(io.StringIO()):
            m = test_cli.evaluate(["--root_dir", corpus, "--valid_dataset",
                                   RNNT_VALID, "--checkpoint", ckpt,
                                   "--transducer", "true", "--beam",
                                   str(beam), "--valid_steps", "0",
                                   *RNNT_SIZE])
        check(math.isfinite(m["wer"]) and m["utterances"] > 0,
              f"rnnt cli.test beam {beam}: {m}")
        evals[f"beam{beam}"] = m

    art = os.path.join(tmp, "rnnt_art")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        export_cli.main(live + ["--transducer", "true", "--output", art,
                                "--seconds", "30", "--platforms", "cuda"])
    export_s = time.perf_counter() - t0
    exported = ["--exported", art]
    with contextlib.redirect_stdout(io.StringIO()):
        ex_texts = [t for _, t in transcribe.main(files + exported)]
    check(ex_texts == want, f"rnnt exported transcribe {ex_texts} != {want}")
    ex_served = rnnt_serve(exported, seed, want[0])
    with contextlib.redirect_stdout(io.StringIO()):
        ex_eval = test_cli.evaluate(["--root_dir", corpus, "--valid_dataset",
                                     RNNT_VALID, "--valid_steps", "0",
                                     *exported])
    check(ex_eval["utterances"] == evals["beam1"]["utterances"]
          and math.isfinite(ex_eval["wer"]), f"rnnt exported eval {ex_eval}")
    out["clis"] = {"transcribe": texts, "serve": served, "test": evals,
                   "export_s": export_s, "exported_serve": ex_served,
                   "exported_test": ex_eval}
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def rnnt_serve(argv: list, seed: int, want: str) -> dict:
    """``cli.serve`` with ``argv`` on 127.0.0.1: ``/transcribe`` of the
    first served request and one ``/stream`` of it in 1 s blocks, both
    giving ``want``."""
    from audio8_tpu_torch.cli.serve import (build_service, make_server,
                                            parse_args)

    body = serve_bodies(seed)[0]
    # batch 1: the (1, chunk) dispatches of the streamer it is held to
    args = parse_args(argv + ["--host", "127.0.0.1", "--port", "0",
                              "--batch", "1"])
    service = build_service(args)
    srv = make_server(service, args.host, args.port)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    try:
        port = srv.server_address[1]
        status, one = post(port, "/transcribe", body)
        pcm = (wav_of(body) * 32768.0).astype("<i2").tobytes()
        streamed = stream_request(port, pcm, SR)
    finally:
        srv.shutdown()
        srv.server_close()
        service.transcriber.batcher.close()
        server.join(timeout=10)
    final = streamed["lines"][-1]
    check(status == 200 and one["text"] == want,
          f"rnnt /transcribe {one} != {want!r}")
    check(final.get("final") and final["text"] == want,
          f"rnnt /stream {final} != {want!r}")
    return {"text": one["text"], "latency_ms": one["latency_ms"],
            "stream_lines": len(streamed["lines"]),
            "last_byte_to_final_s": streamed["last_byte_to_final_s"]}


def phase_transducer(tmp: str, seed: int, gen) -> tuple:
    """Phase 19: the RNN-T path at full width. ``cli.train_transducer``
    warm-started from the train phase's CTC checkpoint on its corpus
    (RNNT_RUNS), one step card vs CPU for each loss route, the
    bench_transducer step timed, kernels 2, 2b, 3, 4 and 5 against their
    plain versions at the shapes the timed step gave them, and the
    decode paths (:func:`rnnt_decode`). Returns the f32 run's launches
    and the kernels' max errors."""
    corpus, warm = rnnt_sources(tmp, seed)
    with timed("transducer_train"):
        runs, (state, launches) = rnnt_train(tmp, corpus, warm)
    cfg = state.model.config
    weights = {k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()}
    n_params = sum(p.numel() for p in state.params)
    del state
    torch.cuda.empty_cache()
    with timed("transducer_vs_cpu"):
        vs_cpu = rnnt_vs_cpu(cfg, weights, seed)
    with timed("transducer_timing"):
        timing, shapes, params = rnnt_timing(cfg, weights, seed)
    with timed("transducer_kernel"):
        worst = phase_path_kernels("transducer", shapes, params, gen)
    with timed("transducer_decode"):
        decode = rnnt_decode(tmp, corpus, cfg, weights, seed)
    emit({"phase": "transducer", "config": "wav2vec2-base encoder d768 h12 "
          "L12 ff3072 + LSTM predictor 2 x 512 (embed 256) + joint 512, "
          f"{cfg.vocab_size} letters", "params": n_params,
          "warm_start": os.path.basename(warm), "runs": runs,
          "vs_cpu": vs_cpu, "step": timing, "decode": decode,
          "launches": launches, "kernel_max_abs_err": worst})
    return launches, worst


def transducer_timing(gen) -> int:
    """The build and phase 19 alone (``--transducer-phases``) on a fresh
    corpus and warm start, then the phase seconds and the card."""
    with timed("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        launches, _ = phase_transducer(tmp, SEED, gen)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "transducer_phases", "launches": launches})
    print_card()
    return 0


SSL_PATH = ("conv_k3s2_fwd", "conv_k3s2_dgrad", "conv_k3s2_wgrad",
            "attention_fwd", "attention_bwd", "dropout", "adamw")
# bench.py:bench_hubert's step: rows, samples (T' 512), clusters
SSL_BENCH = (8, 163_920, 100)
SSL_VS_CPU = (48_000, 41_000)  # the card-vs-CPU steps' two rows
SSL_FEATURE_LAYER = 6  # iteration 2 clusters layer 6 of a base model
SSL_CPU_CLIPS = 2  # the iteration-2 clips whose ids the CPU recomputes
SSL_TIE_RTOL = 1e-3  # a k-means near tie: two distances this close
EMA_RTOL = 1e-6  # the teacher after one EMA, card vs CPU
SSL_CLI = ["--device", "cuda", "--warmup_steps", "1", "--valid_steps", "1",
           "--num_train_workers", "4", "--train_steps", "2",
           "--steps_per_checkpoint", "2", "--optim", "sgd"]
SSL_SIZE: list = []  # the models' size flags: the defaults, full width
# the data2vec-base preset's layout
D2V_TOPOLOGY = {"extractor_mode": "layer", "pos_conv_depth": 5,
                "conv_pos_kernel": 19}


def tree_bytes(*dirs: str) -> int:
    """The bytes of every file under ``dirs``."""
    return sum(os.path.getsize(os.path.join(d, f)) for top in dirs
               for d, _, files in os.walk(top) for f in files)


def ssl_configs() -> dict:
    """Full width: HuBERT base (``HubertPretrainConfig()``: 768 wide, 12
    heads, 12 layers, d_ff 3072, 100 clusters, final_dim 256) and
    data2vec-base (the same widths, the layer-norm extractor and five
    stacked positional convs of k 19)."""
    from audio8_tpu_torch.config import (Data2VecPretrainConfig,
                                         HubertPretrainConfig)

    return {"hubert": HubertPretrainConfig(),
            "data2vec": Data2VecPretrainConfig(**D2V_TOPOLOGY)}


def ssl_model(kind: str, cfg, dtype, device: str, weights=None,
              seed: int = 0):
    """``kind``'s model of ``cfg`` with ``weights`` or the JAX init drawn
    from ``seed``."""
    from audio8_tpu_torch.models.data2vec import Data2VecAudioModel
    from audio8_tpu_torch.models.hubert import HubertPretrainModel

    cls = HubertPretrainModel if kind == "hubert" else Data2VecAudioModel
    if weights is None:
        return cls(cfg, dtype, torch.Generator().manual_seed(seed)).to(
            device)
    model = cls(cfg, dtype)
    model.load_state_dict(weights)
    return model.to(device)


def ssl_batch(seed: int, lengths, clusters: int) -> dict:
    """Rows of ``lengths`` samples (padded to the longest) and one random
    cluster id per frame of each row's conv grid (-1 after)."""
    from audio8_tpu_torch.config import CONV_FEATURES, conv_output_length

    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    sig = np.zeros((len(lengths), lengths.max()), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = synthetic_speechlike((n + 1) / SR, rng)[:n]
    u = np.array([conv_output_length(int(n), CONV_FEATURES[16])
                  for n in lengths])
    ids = np.full((len(lengths), u.max()), -1, np.int32)
    for i, n in enumerate(u):
        ids[i, :n] = rng.integers(0, clusters, size=n)
    return {"signal": torch.from_numpy(sig),
            "signal_lengths": torch.from_numpy(lengths.astype(np.int32)),
            "token_ids": torch.from_numpy(ids),
            "token_lengths": torch.from_numpy(u.astype(np.int32))}


def ssl_steps(kind: str, model, teacher=None):
    """One call of ``kind``'s train step as ``step(state, batch, seed)``,
    its seeds drawn from a fresh generator of ``seed``."""
    from audio8_tpu_torch.models.hubert import HubertSeeds
    from audio8_tpu_torch.ops.hashrand import draw_seed
    from audio8_tpu_torch.train.steps import (make_data2vec_steps,
                                              make_hubert_steps)

    if kind == "hubert":
        train_step, _ = make_hubert_steps(model)

        def step(state, batch, seed):
            gen = torch.Generator().manual_seed(seed)
            return train_step(state, batch, HubertSeeds.draw(gen), gen)
    else:
        train_step, _ = make_data2vec_steps(model, teacher)

        def step(state, batch, seed):
            gen = torch.Generator().manual_seed(seed)
            return train_step(state, batch, draw_seed(gen), gen)
    return step


def ssl_state(model):
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)

    return TrainState(model, create_optimizer(create_lrs(
        2e-5, 100, "constant", warmup_steps=0), weight_decay=0.01))


def ssl_predicted(kind: str, cfg) -> dict:
    """Each kernel's launches in one unfrozen training step, as the code
    predicts them: kernel 2 once a layer (twice for data2vec: the
    teacher's forward and the student's), 2b once a layer, 3 once a k3s2
    layer (twice for data2vec), 3b and 3c once a k3s2 layer (the
    extractor trains), 4 once for every dropout the student's forward
    draws (counted on a copy at width 32 on the CPU; the teacher draws
    none) and once more in its backward, 5 once."""
    from audio8_tpu_torch.models.hubert import HubertSeeds

    model = ssl_model(kind, small_copy(cfg), torch.float32, "cpu")
    seeds = HubertSeeds(1, 2) if kind == "hubert" else 1
    drops = counted_dropouts(lambda: model(
        torch.zeros(2, 4000), torch.tensor([4000, 3000]), seeds,
        generator=torch.Generator().manual_seed(0)))
    k3s2 = sum(1 for _, k, s in cfg.conv_features if (k, s) == (3, 2))
    fwd = 2 if kind == "data2vec" else 1
    return {"conv_k3s2_fwd": fwd * k3s2, "conv_k3s2_dgrad": k3s2,
            "conv_k3s2_wgrad": k3s2, "attention_fwd": fwd * cfg.num_layers,
            "attention_bwd": cfg.num_layers, "dropout": 2 * drops,
            "adamw": 1}


def ssl_targets(tmp: str, corpus: str, cfg, seed: int) -> dict:
    """``cli.cluster_targets`` on the corpus: MFCC targets (the ``.km``
    files HuBERT trains on), then iteration 2 on a copy of the manifests:
    layer SSL_FEATURE_LAYER of a random base HuBERT model's ``.pt`` on the
    card, whose ids on SSL_CPU_CLIPS validation clips are recomputed from
    CPU features of the same weights (the same centroids): equal, or the
    card's choice within SSL_TIE_RTOL of the CPU's best distance."""
    from audio8_tpu_torch.cli import cluster_targets
    from audio8_tpu_torch.config import CONV_FEATURES, conv_output_length
    from audio8_tpu_torch.data.audio import SoundfileAudioReader
    from audio8_tpu_torch.models.convert import save_fairseq_pretrained

    def km_lines(root, split):
        with open(os.path.join(root, f"{split}.tsv")) as fh:
            audio_root, *rows = fh.read().splitlines()
        with open(os.path.join(root, f"{split}.km")) as fh:
            lines = fh.read().splitlines()
        for row, line in zip(rows, lines, strict=True):
            n = int(row.split("\t")[1])
            check(len(line.split()) == conv_output_length(
                n, CONV_FEATURES[16]), f"{split}.km: {row} ids off the grid")
        return audio_root, rows, lines

    out = {}
    t0 = time.perf_counter()
    check(cluster_targets.main(["--root_dir", corpus, "--manifests",
                                "train.tsv", "valid.tsv"]) == 0,
          "cluster_targets (MFCC) failed")
    out["mfcc_s"] = time.perf_counter() - t0
    for split in ("train", "valid"):
        _, rows, lines = km_lines(corpus, split)
        out[f"mfcc_{split}_frames"] = sum(len(x.split()) for x in lines)
    out["mfcc_clusters_used"] = len({i for split in ("train", "valid")
                                     for line in km_lines(corpus, split)[2]
                                     for i in line.split()})

    it2 = os.path.join(tmp, "ssl_it2")
    os.makedirs(it2)
    for name in ("train.tsv", "valid.tsv"):
        shutil.copy(os.path.join(corpus, name), it2)
    ckpt = os.path.join(tmp, "ssl_random_hubert.pt")
    save_fairseq_pretrained(ssl_model("hubert", cfg, torch.float32, "cpu",
                                      seed=seed + 60), ckpt)
    argv = ["--root_dir", it2, "--manifests", "train.tsv", "valid.tsv",
            "--checkpoint", ckpt, "--feature_layer",
            str(SSL_FEATURE_LAYER), *SSL_SIZE]
    t0 = time.perf_counter()
    check(cluster_targets.main(argv) == 0, "cluster_targets (layer 6) "
          "failed")
    out["layer_s"] = time.perf_counter() - t0
    audio_root, rows, lines = km_lines(it2, "valid")
    cents = np.load(os.path.join(it2, "train.centroids.npy")).astype(
        np.float64)
    featurize = cluster_targets.make_model_featurizer(
        cluster_targets.parse_args(argv + ["--device", "cpu"]),
        torch.device("cpu"))
    reader = SoundfileAudioReader()
    short = sorted(range(len(rows)),
                   key=lambda i: int(rows[i].split("\t")[1]))[:SSL_CPU_CLIPS]
    frames = agree = ties = 0
    worst_gap = 0.0
    for i in short:
        feats = featurize(reader.read(os.path.join(
            audio_root, rows[i].split("\t")[0])).squeeze()).astype(
                np.float64)
        card = np.array([int(v) for v in lines[i].split()])
        d = ((feats[:, None, :] - cents[None]) ** 2).sum(-1)
        cpu = d.argmin(-1)
        frames += len(card)
        agree += int((card == cpu).sum())
        for f in np.flatnonzero(card != cpu):
            gap = (d[f, card[f]] - d[f, cpu[f]]) / d[f, cpu[f]]
            worst_gap = max(worst_gap, float(gap))
            ties += int(gap <= SSL_TIE_RTOL)
    out.update({"layer_cpu_frames": frames, "layer_agreement": agree / frames,
                "layer_near_ties": ties, "layer_worst_gap": worst_gap,
                "tie_rtol": SSL_TIE_RTOL})
    check(agree + ties == frames and agree / frames >= CODE_AGREEMENT,
          f"iteration-2 ids card vs CPU: {agree}/{frames} equal, {ties} "
          "near ties")
    return out, ckpt


def ssl_vs_cpu(kind: str, cfg, weights: dict, seed: int) -> dict:
    """One full-width training step (dropout and masks on, the seeds of
    one generator seed on both sides) on two rows of 3.0 and 2.6 s, card
    and CPU from the same weights: in f32 the loss within TRAIN_LOSS_RTOL
    and the gradient norm within TRAIN_GNORM_RTOL; HuBERT's masked
    accuracy may differ only where the CPU's logits are within
    TIE_MARGIN of a tie, and a bf16 step follows (BF16_LOSS_RTOL,
    TOL[bf16]); data2vec's EMA teacher after the step within EMA_RTOL of
    the CPU's, relative to its largest weight."""
    import copy

    from audio8_tpu_torch.models.hubert import HubertSeeds

    batch = ssl_batch(seed + 61, SSL_VS_CPU, cfg.num_clusters
                      if kind == "hubert" else 2)
    dtypes = ((torch.float32, torch.bfloat16) if kind == "hubert"
              else (torch.float32,))
    out = {"rows_s": [n / SR for n in SSL_VS_CPU]}
    for dt in dtypes:
        res = {}
        for dev in ("cuda", "cpu"):
            model = ssl_model(kind, cfg, dt, dev, weights)
            b = {k: v.to(dev) for k, v in batch.items()}
            teacher = None
            if kind == "data2vec":
                teacher = copy.deepcopy(model).requires_grad_(False)
                del b["token_ids"], b["token_lengths"]
            logits = None
            if kind == "hubert" and dt == torch.float32:
                gen = torch.Generator().manual_seed(seed + 62)
                with torch.no_grad():
                    logits, tm, _ = model(b["signal"], b["signal_lengths"],
                                          HubertSeeds.draw(gen), gen)
                logits = (logits.float().cpu(), tm.cpu())
            state = ssl_state(model)
            _, m = ssl_steps(kind, model, teacher)(state, b, seed + 62)
            res[dev] = ({k: float(v) for k, v in m.items()}, logits,
                        None if teacher is None else
                        {k: v.float().cpu() for k, v in
                         teacher.state_dict().items()})
            del model, state, teacher
        (m_g, lg_g, t_g), (m_c, lg_c, t_c) = res["cuda"], res["cpu"]
        name = str(dt).split(".")[1]
        lt, nt = ((TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL) if dt == torch.float32
                  else (BF16_LOSS_RTOL, TOL[torch.bfloat16]))
        row = {"loss": [m_g["loss"], m_c["loss"]],
               "gnorm": [m_g["grad_norm"], m_c["grad_norm"]],
               "loss_rel_err": rel(m_g["loss"], m_c["loss"]),
               "loss_rtol": lt,
               "gnorm_rel_err": rel(m_g["grad_norm"], m_c["grad_norm"]),
               "gnorm_rtol": nt, "n_masked": [m_g["n_masked"],
                                               m_c["n_masked"]]}
        check(row["loss_rel_err"] <= lt,
              f"{kind} {name} step loss card vs CPU {row['loss_rel_err']}")
        check(row["gnorm_rel_err"] <= nt,
              f"{kind} {name} step gnorm card vs CPU {row['gnorm_rel_err']}")
        check(m_g["n_masked"] == m_c["n_masked"],
              f"{kind} {name}: masked frames differ")
        if lg_g is not None:
            (g, tm), (c, _) = lg_g, lg_c
            diff = (g.argmax(-1) != c.argmax(-1)) & tm
            gap = (c.max(-1).values - c.gather(
                -1, g.argmax(-1, keepdim=True))[..., 0])[diff]
            ties = int((gap <= TIE_MARGIN).sum())
            row.update({"acc_masked": [m_g["acc_masked"],
                                       m_c["acc_masked"]],
                        "argmax_differs": int(diff.sum()),
                        "near_ties": ties, "tie_margin": TIE_MARGIN})
            check(ties == int(diff.sum()), f"hubert: {int(diff.sum())} "
                  f"argmax changes, {ties} near ties")
            check(abs(m_g["acc_masked"] - m_c["acc_masked"])
                  * m_c["n_masked"] <= ties + 1e-3,
                  "hubert: masked accuracy card vs CPU")
        if t_g is not None:
            # relative to the teacher's largest weight: a zero-initialised
            # bias holds only (1 - decay) times one update after a step
            err = max(float((t_g[k] - t_c[k]).abs().max()) for k in t_c)
            scale = max(float(t_c[k].abs().max()) for k in t_c)
            row.update({"ema_decay": m_g["ema_decay"],
                        "teacher_max_abs_err": err, "teacher_scale": scale,
                        "teacher_rel_err": err / scale,
                        "teacher_rtol": EMA_RTOL})
            check(m_g["ema_decay"] == m_c["ema_decay"], "ema decay")
            check(err / scale <= EMA_RTOL,
                  f"data2vec teacher card vs CPU {err} of {scale}")
        emit({"phase": f"ssl_{kind}_vs_cpu", name: row})
        out[name] = row
        torch.cuda.empty_cache()
    return out


def ssl_timing(kind: str, cfg, weights: dict, seed: int) -> tuple:
    """bench_hubert's step ((8, 163 920) samples, T' 512, 100 clusters,
    AdamW, the recipe's dropouts and masks) of ``kind`` in f32 and bf16 in
    turns (f32, bf16, bf16, f32): wall ms, peak memory and audio-s/s, and
    in the first turn of each dtype the device ms and idle share of a
    trace; first one f32 step with the launches counted (against
    :func:`ssl_predicted`) and the path's calls recorded. Returns the
    timings, the launches and the path's calls."""
    import copy

    rows, samples, clusters = SSL_BENCH
    batch = {k: v.cuda() for k, v in ssl_batch(
        seed + 63, [samples] * rows, clusters).items()}
    if kind == "data2vec":  # dense rows, as its entry point batches them
        batch = {"signal": batch["signal"], "signal_lengths": None}
    runs = {}
    for dt in (torch.float32, torch.bfloat16):
        model = ssl_model(kind, cfg, dt, "cuda", weights)
        teacher = (copy.deepcopy(model).requires_grad_(False)
                   if kind == "data2vec" else None)
        runs[dt] = (model, ssl_state(model), ssl_steps(kind, model, teacher))
    model, state, step = runs[torch.float32]
    predicted = ssl_predicted(kind, cfg)
    calls = {}
    reset_launches()
    with recorded_path_calls(calls):
        step(state, batch, seed)
    torch.cuda.synchronize()
    launches = {k: n for k, n in read_launches().items() if k in SSL_PATH}
    check(launches == predicted, f"{kind} step launches {launches} "
          f"against the prediction {predicted}")
    params = [tuple(p.shape) for p in model.parameters()]
    audio_s = rows * samples / SR
    out = {"shape": [rows, samples], "clusters": clusters}
    for turn, dt in enumerate((torch.float32, torch.bfloat16,
                               torch.bfloat16, torch.float32)):
        model, state, step = runs[dt]

        def step_fn(st, flags, step=step):
            step(st, batch, seed + turn)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 1e9  # both dtypes' runs
        t = step_timings(state, step_fn, {"step": {}},
                         n=3)["step"] if turn < 2 else {"wall_ms": []}
        if turn >= 2:
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step_fn(state, {})
                torch.cuda.synchronize()
                t["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        t["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        t["resident_gb"] = resident
        t["audio_s_per_s"] = audio_s / (float(np.median(t["wall_ms"]))
                                        / 1e3)
        out.setdefault(str(dt).split(".")[1], []).append(t)
    del runs, model, state, step
    torch.cuda.empty_cache()
    return out, launches, predicted, calls, params


def ssl_kernels(calls: dict, params: list, gen, path: str = "ssl") -> dict:
    """Kernels 2, 2b, 3, 4 and 5 (:func:`phase_path_kernels`) and 3b and
    3c (each recorded k3s2 layer's input) against their plain versions at
    the shapes the timed HuBERT and data2vec steps (or ``path``'s) gave
    them, float32 and bfloat16; returns the float32 max errors."""
    worst = phase_path_kernels(path, path_shapes(calls), params, gen)
    worst.update({"conv_k3s2_dgrad": 0.0, "conv_k3s2_wgrad": 0.0})
    for x_shape, w_shape in sorted(set(calls["conv"])):
        for dtype in (torch.float32, torch.bfloat16):
            errs = check_conv_bwd(f"{path}_kernel", x_shape[0], x_shape[1],
                                  w_shape[1], w_shape[2], dtype, gen)
            if dtype == torch.float32:
                for k, e in errs.items():
                    worst[k] = max(worst[k], e)
            torch.cuda.empty_cache()
    return worst


def ssl_clis(tmp: str, corpus: str) -> dict:
    """The entry points at full width on the corpus (SSL_CLI: 2 steps,
    validating and saving at both, as the JAX entry points' cadence has it):
    ``cli.pretrain_hubert`` from the MFCC ``.km`` files, then
    ``cli.train --restart_from`` its last ``.pt`` for 2 CTC steps (the
    encoder frozen, so after the run every encoder weight must still be
    the HuBERT checkpoint's, bitwise: the warm start, heads dropped), then
    ``cli.pretrain_data2vec --preset data2vec-base`` and a restart from
    its directory at its last step, whose teacher must be bitwise the
    saved one and the one the run ended with. All three step SGD (the
    timed steps run AdamW): its resume files hold no moments, which keeps
    the full run's disk writes under the machine's cap."""
    from audio8_tpu_torch.cli import pretrain_data2vec, pretrain_hubert
    from audio8_tpu_torch.cli import train as ctc_train
    from audio8_tpu_torch.models.convert import load_fairseq_pretrained

    out = {}
    hub_dir = os.path.join(tmp, "ssl_hubert")
    reset_launches()
    t0 = time.perf_counter()
    state = pretrain_hubert.train(["--root_dir", corpus, "--train_dataset",
                                   "train.tsv", "--valid_dataset",
                                   "valid.tsv", "--basedir", hub_dir,
                                   *SSL_CLI, *SSL_SIZE])
    runs = {"hubert": read_launches()}
    launches = {k: n for k, n in runs["hubert"].items()
                if k in SSL_PATH and k != "adamw"}
    check(state.step == 2 and all(math.isfinite(r["loss"])
                                  for r in state.log),
          f"pretrain_hubert: {state.step} steps, {state.log}")
    check(all(n > 0 for n in launches.values()),
          f"pretrain_hubert launches {launches}")
    out["hubert"] = {"wall_s": time.perf_counter() - t0,
                     "log": state.log, "valid": state.valid,
                     "launches": launches}
    del state
    torch.cuda.empty_cache()

    ckpt = os.path.join(hub_dir, "checkpoint-step-2.pt")
    reset_launches()
    t0 = time.perf_counter()
    state = ctc_train.train(["--root_dir", corpus, "--train_dataset",
                             "train.tsv", "--valid_dataset", "valid.tsv",
                             "--basedir", os.path.join(tmp, "ssl_ctc"),
                             "--restart_from", ckpt, "--grad_accum", "1",
                             "--target_tokens_per_batch", "700000",
                             *SSL_CLI, *SSL_SIZE])
    ctc_launches = runs["ctc"] = read_launches()
    body = load_fairseq_pretrained(ckpt)
    moved = [k for k, v in state.model.state_dict().items()
             if k.startswith("encoder.")
             and not torch.equal(v.cpu(), body[k[len("encoder."):]])]
    check(not moved, f"CTC warm start: encoder weights {moved[:3]} are not "
          "the HuBERT checkpoint's")
    check(ctc_launches["ctc_loss"] > 0 and all(
        math.isfinite(r["loss"]) for r in state.log),
        f"CTC from HuBERT: {ctc_launches}, {state.log}")
    out["ctc_warm_start"] = {"wall_s": time.perf_counter() - t0,
                             "losses": [r["loss"] for r in state.log],
                             "ctc_loss_launches": ctc_launches["ctc_loss"],
                             "encoder_tensors_from_hubert": sum(
                                 1 for k in state.model.state_dict()
                                 if k.startswith("encoder."))}
    del state
    torch.cuda.empty_cache()

    d2v_dir = os.path.join(tmp, "ssl_data2vec")
    d2v = ["--manifest_dir", corpus, "--basedir", d2v_dir, "--preset",
           "data2vec-base", *SSL_CLI, *SSL_SIZE]
    reset_launches()
    t0 = time.perf_counter()
    state, teacher = pretrain_data2vec.train(d2v)
    runs["data2vec"] = read_launches()
    launches = {k: n for k, n in runs["data2vec"].items()
                if k in SSL_PATH and k != "adamw"}
    ended = {k: v.cpu().clone() for k, v in teacher.state_dict().items()}
    check(state.step == 2 and all(math.isfinite(r["loss"])
                                  for r in state.log),
          f"pretrain_data2vec: {state.step} steps, {state.log}")
    check(all(n > 0 for n in launches.values()),
          f"pretrain_data2vec launches {launches}")
    out["data2vec"] = {"wall_s": time.perf_counter() - t0,
                       "log": state.log, "valid": state.valid,
                       "launches": launches}
    del state, teacher
    torch.cuda.empty_cache()
    state, teacher = pretrain_data2vec.train(d2v + ["--restart_from",
                                                    d2v_dir])
    saved = load_fairseq_pretrained(os.path.join(d2v_dir,
                                                 "teacher-step-2.pt"))
    restored = teacher.state_dict()
    check(state.step == 2 and state.log == [], "data2vec restart stepped")
    check(all(torch.equal(v.cpu(), saved[k]) and torch.equal(v.cpu(),
                                                             ended[k])
              for k, v in restored.items()),
          "data2vec restart: the teacher is not the saved one")
    out["data2vec"]["restart_teacher_bitwise"] = True
    del state, teacher
    torch.cuda.empty_cache()
    out["launches"] = {k: sum(r[k] for r in runs.values())
                       for k in runs["hubert"]}
    return out


def phase_ssl(tmp: str, seed: int, gen) -> tuple:
    """Phase 20: HuBERT and data2vec pretraining at full width on a fresh
    corpus: the targets (:func:`ssl_targets`), each objective's step card
    vs CPU (:func:`ssl_vs_cpu`) and timed with its launches held to the
    prediction (:func:`ssl_timing`), the kernels at those steps' shapes
    (:func:`ssl_kernels`), and the entry points (:func:`ssl_clis`).
    Returns the HuBERT step's launches, the three entry-point runs'
    launches summed, and the kernels' max errors."""
    cfgs = ssl_configs()
    corpus = os.path.join(tmp, "ssl_corpus")
    os.makedirs(corpus)
    write_corpus(corpus, seed + 60)
    dirs = [os.path.join(tmp, d) for d in ("ssl_corpus", "ssl_it2",
                                           "ssl_hubert", "ssl_ctc",
                                           "ssl_data2vec")]
    with timed("ssl_targets"):
        targets, ckpt = ssl_targets(tmp, corpus, cfgs["hubert"], seed)
    emit({"phase": "ssl_targets", **targets})
    weights = {
        "hubert": {k: v for k, v in ssl_model(
            "hubert", cfgs["hubert"], torch.float32, "cpu",
            seed=seed + 60).state_dict().items()},
        "data2vec": {k: v for k, v in ssl_model(
            "data2vec", cfgs["data2vec"], torch.float32, "cpu",
            seed=seed + 64).state_dict().items()}}
    vs_cpu, timing, launches, predicted, calls = {}, {}, {}, {}, {}
    for kind in ("hubert", "data2vec"):
        with timed(f"ssl_{kind}_vs_cpu"):
            vs_cpu[kind] = ssl_vs_cpu(kind, cfgs[kind], weights[kind], seed)
        with timed(f"ssl_{kind}_timing"):
            (timing[kind], launches[kind], predicted[kind], c,
             params) = ssl_timing(kind, cfgs[kind], weights[kind], seed)
        emit({"phase": f"ssl_{kind}_step", **timing[kind],
              "launches": launches[kind], "predicted": predicted[kind]})
        for key, v in c.items():
            calls.setdefault(key, []).extend(v)
    with timed("ssl_kernel"):
        worst = ssl_kernels(calls, params, gen)
    with timed("ssl_cli"):
        clis = ssl_clis(tmp, corpus)
    emit({"phase": "ssl_cli", **clis})
    emit({"phase": "ssl", "config": {
        "hubert": "HuBERT base d768 h12 L12 ff3072, 100 clusters, "
                  "final_dim 256", "data2vec": "data2vec-base: the same "
                  "widths, layer-norm extractor, 5 positional convs of k "
                  "19, top 8 layers"},
        "iteration2_checkpoint": os.path.basename(ckpt),
        "vs_cpu": vs_cpu, "launches_per_step": launches,
        "predicted_per_step": predicted, "cli_launches": clis["launches"],
        "kernel_max_abs_err": worst, "bytes_written": tree_bytes(*dirs),
        "bytes_written_by_dir": {os.path.basename(d): tree_bytes(d)
                                 for d in dirs}})
    return launches["hubert"], clis["launches"], worst


def ssl_phases(gen) -> int:
    """The build and phase 20 alone (``--ssl-phases``) on a fresh corpus,
    then the phase seconds, the card and the last line."""
    with timed("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        launches, cli_launches, worst = phase_ssl(tmp, SEED, gen)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "ssl_phases", "step_launches": launches,
          "cli_launches": cli_launches, "kernel_max_abs_err": worst})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# phase 21: the device beam, the text LM and n-best rescoring
DECODE_PHASES = ("decode_beam", "decode_lm", "decode_rescore")
BEAM_WIDTHS = (8, 100)  # a serving beam and PrefixBeamSearch's default
BEAM_SECONDS = (30.0, 24.0, 11.0, 4.0)  # one ragged (4, 30 s) batch
BEAM_BLANK, BEAM_SPACE = 0, 4  # fairseq's <s> and '|' in the letter dict
# the word bonus of the timed searches, and cli.test's --beta, held to the
# host search at beam 100 only: the host search extends each frame's
# max(beam, 16) likeliest symbols, the device search (JAX's) every one,
# so at beam 8 a bonus-earning unlikely space splits them by design
BEAM_BETA, BONUS_BETA = 0.0, 5.0
BEAM_TIE = 1e-3  # two search scores this close are a near tie
BEAM_CPU_RTOL = 1e-4  # the card's search scores against the CPU's
BEAM_CPU_FRAMES = {8: 1499, 100: 549}  # the CPU's loop: every row at beam
# 8, the two shorter rows at beam 100 (the whole batch took 9.5 s there)
LM_TEXT_LINES = (3000, 100)  # train and valid transcript lines
LM_RUNS = {"f32": ["--train_steps", "3", "--steps_per_checkpoint", "3"],
           "bf16": ["--train_steps", "2", "--steps_per_checkpoint", "2",
                    "--bf16"]}
LM_CPU_ROWS = 2  # the card-vs-CPU step's packed blocks
RESCORE_BEAM = 8
RESCORE_CLIPS = 6  # of 1.5-15 s
RESCORE_CPU_UTTS = 2  # the shortest utterances, whose picks the CPU redoes
RNNT_RESCORE_BEAM = 4
RNNT_RESCORE_CLIPS = 2  # the shortest clips


def decode_log_probs(seed: int) -> tuple:
    """(4, 1499, 32) CTC log-probs of the shape a trained model gives
    (``peaky_log_probs``) over BEAM_SECONDS of letters at about 14 a
    second, words of 2-9 letters, and each row's frame count."""
    from audio8_tpu_torch.config import CONV_FEATURES, conv_output_length

    rng = np.random.default_rng(seed + 70)
    frames = [conv_output_length(int(s * SR), CONV_FEATURES[16])
              for s in BEAM_SECONDS]
    v = 4 + len(LETTERS)
    lp = np.full((len(frames), frames[0], v), -np.log(v), np.float32)
    for b, n in enumerate(frames):
        labels = []
        while len(labels) < int(14 * BEAM_SECONDS[b]):
            labels += list(rng.integers(5, v, size=rng.integers(2, 10)))
            labels.append(BEAM_SPACE)
        lp[b, :n] = peaky_log_probs(np.array(labels), n, v, BEAM_BLANK, rng)
    return lp, frames


def near_tie_ranks(scores: np.ndarray) -> set:
    """The ranks whose score is within BEAM_TIE of a neighbour's or of
    the last kept one (where a search may keep either of two)."""
    k = len(scores)
    return {r for r in range(k)
            if (r > 0 and scores[r - 1] - scores[r] <= BEAM_TIE)
            or (r + 1 < k and scores[r] - scores[r + 1] <= BEAM_TIE)
            or scores[r] - scores[-1] <= BEAM_TIE}


def decode_beam(seed: int) -> dict:
    """The device beam on the card on one (4, 30 s) batch of log-probs:
    first the widest beam with the word bonus under
    ``torch.cuda.set_sync_debug_mode("error")`` (the warm-up), held to
    the host library's search; then at each of BEAM_WIDTHS without it, ms
    per batch and audio-s/s, n-best equal to the same search on the CPU
    (every row at beam 8, the rows of BEAM_CPU_FRAMES at beam 100),
    scores within BEAM_CPU_RTOL, and against the host search per row (ms
    per batch too) every rank equal unless a near tie, top-1 included."""
    from audio8_tpu_torch.csrc import native
    from audio8_tpu_torch.ops.beam_device import (backtrace, beam_search,
                                                  ctc_beam_search)

    lp, frames = decode_log_probs(seed)
    lp_gpu = torch.from_numpy(lp).cuda()
    fl_gpu = torch.tensor(frames, device="cuda")
    audio_s = sum(BEAM_SECONDS)
    out = {"shape": list(lp.shape), "frames": frames, "beta": BEAM_BETA}

    def against_host(k, beta, nbest, scores) -> tuple:
        t0 = time.perf_counter()
        host = [native.prefix_beam_search(
            np.ascontiguousarray(lp[b, :n]), BEAM_BLANK, k, BEAM_SPACE, 0.0,
            beta) for b, n in enumerate(frames)]
        host_s = time.perf_counter() - t0
        ties, off = 0, []
        for b in range(len(frames)):
            tied = near_tie_ranks(scores[b])
            for r in range(min(k, len(host[b]))):
                if host[b][r] != nbest[b][r]:
                    if r in tied:
                        ties += 1
                    else:
                        off.append((b, r))
        check(not off, f"device beam {k}, beta {beta}: ranks {off[:5]} "
              "differ from the host search without a near tie")
        return host_s, ties

    # first the widest beam with the word bonus, under the sync check (it
    # is also the loop's warm-up), against the host search
    k = BEAM_WIDTHS[-1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        parents, tokens, scores = beam_search(
            lp_gpu, fl_gpu, beam=k, blank=BEAM_BLANK, space=BEAM_SPACE,
            beta=BONUS_BETA)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out["no_host_sync"] = {"beam": k, "frames": frames[0]}
    nbest = backtrace(parents.cpu().numpy(), tokens.cpu().numpy())
    _, ties = against_host(k, BONUS_BETA, nbest, scores.cpu().numpy())
    out[f"beam{k}_bonus"] = {"beta": BONUS_BETA,
                             "rank_differences_at_near_ties": ties,
                             "top1_labels": [len(nb[0]) for nb in nbest]}
    for k in BEAM_WIDTHS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parents, tokens, scores = beam_search(
            lp_gpu, fl_gpu, beam=k, blank=BEAM_BLANK, space=BEAM_SPACE,
            beta=BEAM_BETA)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nbest = backtrace(parents.cpu().numpy(), tokens.cpu().numpy())
        scores = scores.cpu().numpy()
        # the CPU runs the same search on the rows whose frames fit a
        # BEAM_CPU_FRAMES loop (rows are independent: tested on the CPU)
        rows = [b for b, n in enumerate(frames) if n <= BEAM_CPU_FRAMES[k]]
        n_cpu = max(frames[b] for b in rows)
        t0 = time.perf_counter()
        cpu_nbest, cpu_scores = ctc_beam_search(
            lp[rows, :n_cpu], [frames[b] for b in rows], beam=k,
            blank=BEAM_BLANK, space=BEAM_SPACE, beta=BEAM_BETA)
        cpu_s = time.perf_counter() - t0
        score_err = float(np.abs(scores[rows] - cpu_scores).max()
                          / max(1.0, np.abs(cpu_scores).max()))
        same = [nbest[b] for b in rows] == cpu_nbest
        check(same and score_err <= BEAM_CPU_RTOL,
              f"device beam {k}: card vs CPU n-best equal {same}, score "
              f"rel err {score_err}")
        host_s, ties = against_host(k, BEAM_BETA, nbest, scores)
        out[f"beam{k}"] = {
            "ms_per_batch": 1e3 * wall, "audio_s_per_s": audio_s / wall,
            "host_ms_per_batch": 1e3 * host_s,
            "host_audio_s_per_s": audio_s / host_s,
            "cpu_rows": rows, "cpu_device_search_ms": 1e3 * cpu_s,
            "card_vs_cpu_score_rel_err": score_err,
            "rank_differences_at_near_ties": ties,
            "top1_labels": [len(nb[0]) for nb in nbest]}
    return out


def write_lm_text(root: str, seed: int) -> None:
    """Letter transcripts (``train.ltr``, ``valid.ltr``) of LM_TEXT_LINES
    lines of 4-30 Zipf words over 5 000 words, and the letter dict."""
    rng = np.random.default_rng(seed + 72)
    words, p = zipf_words(rng, 5000)
    with open(os.path.join(root, "dict.ltr.txt"), "w") as fh:
        fh.writelines(f"{c} {1000 - i}\n" for i, c in enumerate(LETTERS))
    for split, n in zip(("train", "valid"), LM_TEXT_LINES):
        with open(os.path.join(root, f"{split}.ltr"), "w") as fh:
            for _ in range(n):
                line = rng.choice(len(words), size=rng.integers(4, 31), p=p)
                fh.write(" ".join(" ".join(words[i]) + " |"
                                  for i in line) + "\n")


def lm_predicted_dropouts() -> int:
    """The hash-dropout calls of one training forward of the LM at the
    JAX defaults' depth and rate (a 32-wide copy on the CPU)."""
    from audio8_tpu_torch.config import TextLMConfig
    from audio8_tpu_torch.models.text import CausalTextLM

    model = CausalTextLM(TextLMConfig(vocab_size=4 + len(LETTERS),
                                      d_model=32, num_heads=2, d_ff=64),
                         generator=torch.Generator().manual_seed(0))
    return counted_dropouts(lambda: model(
        torch.ones((2, 9), dtype=torch.long),
        generator=torch.Generator().manual_seed(0)))


def lm_vs_cpu(corpus: str, seed: int) -> dict:
    """One LM step at the JAX defaults' width (dropout 0.1) on
    LM_CPU_ROWS packed blocks, on the card and on the CPU from the same
    weights and seeds: loss within 1e-4, gradient norm within 1e-3."""
    from audio8_tpu_torch.cli.train_lm import pack_token_stream
    from audio8_tpu_torch.config import TextLMConfig
    from audio8_tpu_torch.models.text import (CausalTextLM, TextVectorizer,
                                              read_vocab_list)
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_lm_steps

    vocab = read_vocab_list(os.path.join(corpus, "dict.ltr.txt"))
    blocks = pack_token_stream(
        [os.path.join(corpus, "train.ltr")],
        TextVectorizer({v: i for i, v in enumerate(vocab)}), 512, seed)
    ids = torch.from_numpy(blocks[:LM_CPU_ROWS])
    cfg = TextLMConfig(vocab_size=len(vocab))
    weights = CausalTextLM(cfg, generator=torch.Generator().manual_seed(
        seed + 73)).state_dict()
    res = {}
    for dev in ("cuda", "cpu"):
        model = CausalTextLM(cfg).to(dev)
        model.load_state_dict(weights)
        state = TrainState(model, create_optimizer(
            create_lrs(3e-4, 10, warmup_steps=1), weight_decay=0.01))
        step, _ = make_lm_steps(model, clip=1.0)
        _, m = step(state, {"ids": ids.to(dev)},
                    torch.Generator().manual_seed(seed))
        res[dev] = (float(m["loss"]), float(m["grad_norm"]))
        del model, state
    torch.cuda.empty_cache()
    out = {"loss": res["cuda"][0], "cpu_loss": res["cpu"][0],
           "grad_norm": res["cuda"][1], "cpu_grad_norm": res["cpu"][1],
           "loss_rel_err": rel(res["cuda"][0], res["cpu"][0]),
           "grad_norm_rel_err": rel(res["cuda"][1], res["cpu"][1])}
    check(out["loss_rel_err"] <= 1e-4 and out["grad_norm_rel_err"] <= 1e-3,
          f"LM step card vs CPU {out}")
    return out


def lm_step_trace(state, make_lm_steps, gen) -> dict:
    """Where an LM step's time goes: the trained state's step on a batch
    of 32 random blocks, its device ms and idle share from one traced
    window, and its eight costliest kernels."""
    cfg = state.model.config
    ids = torch.randint(4, cfg.vocab_size, (32, cfg.block_len + 1),
                        device="cuda", generator=gen)
    step, _ = make_lm_steps(state.model, clip=1.0)
    g = torch.Generator().manual_seed(0)

    def fn():
        step(state, {"ids": ids}, g)

    window = traced_window(fn, calls=1)
    by_name = traced_or_none(fn)
    return {"trace": window, "top_kernels_ms": [
        [n[:90], ms] for n, ms in sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:8]]
        if by_name else None}


def decode_lm(tmp: str, seed: int, gen) -> tuple:
    """``cli.train_lm`` at its JAX defaults (512 wide, 8 heads, 6 layers,
    2048, rpr_k 8, block 512, batch 32, dropout 0.1, AdamW) on a
    synthetic transcript corpus, f32 then bf16: finite losses, kernel 4's
    launches per step as the code predicts (each forward dropout again
    in the backward) and kernel 5's once a step, no other kernel; step
    ms, tokens/s and peak memory; one step card vs CPU; kernels 4 and 5
    against their plain versions at the run's shapes. Returns (results,
    the f32 run's basedir, the runs' launches, the kernels' errors)."""
    from audio8_tpu_torch.cli import train_lm
    from audio8_tpu_torch.train.steps import make_lm_steps

    corpus = os.path.join(tmp, "lm_corpus")
    os.makedirs(corpus, exist_ok=True)
    write_lm_text(corpus, seed)
    per_step = 2 * lm_predicted_dropouts()
    base = ["--text", os.path.join(corpus, "train.ltr"), "--valid_text",
            os.path.join(corpus, "valid.ltr"), "--dict_file",
            os.path.join(corpus, "dict.ltr.txt"), "--warmup_steps", "1",
            "--device", "cuda"]
    out, total = {"predicted_dropouts_per_step": per_step}, {}
    for name, flags in LM_RUNS.items():
        basedir = os.path.join(tmp, f"lm_{name}")
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            state = train_lm.train(base + ["--basedir", basedir, *flags])
        wall = time.perf_counter() - t0
        launches = read_launches()
        steps = len(state.log)
        want = {k: 0 for k in launches}
        want.update(dropout=per_step * steps, adamw=steps)
        check(launches == want, f"train_lm {name}: launches {launches} "
              f"!= {want}")
        check(all(math.isfinite(r["loss"]) for r in state.log)
              and state.valid and math.isfinite(state.valid[-1]["valid_nll"]),
              f"train_lm {name}: {state.log} {state.valid}")
        timed_steps = state.log[1:]
        ms = [1e3 * r["seconds"] for r in timed_steps]
        out[name] = {"wall_s": wall, "steps": steps,
                     "losses": [r["loss"] for r in state.log],
                     "valid": state.valid[-1], "step_ms": ms,
                     "tokens_per_s": [r["tokens"] / r["seconds"]
                                      for r in timed_steps],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "parameters": sum(p.numel() for p in
                                       state.model.parameters()),
                     "launches": launches}
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        with timed("decode_lm_trace"):
            out[name].update(lm_step_trace(state, make_lm_steps, gen))
        if name == "f32":
            shapes = [tuple(p.shape) for p in state.model.parameters()]
            cfg = state.model.config
        del state
        torch.cuda.empty_cache()
    with timed("decode_lm_vs_cpu"):
        out["vs_cpu"] = lm_vs_cpu(corpus, seed)
    rows, t = 32, cfg.block_len
    worst = {"dropout": 0.0, "adamw": 0.0}
    with timed("decode_lm_kernel"):
        for dtype in (torch.float32, torch.bfloat16):
            for shape in ((rows, t, cfg.d_model),
                          (rows, cfg.num_heads, t, t)):
                worst["dropout"] = max(worst["dropout"], check_dropout(
                    "decode_kernel", shape, dtype, gen))
        worst["adamw"] = check_adamw("decode_kernel", shapes, gen)
    torch.cuda.empty_cache()
    return out, os.path.join(tmp, "lm_f32"), total, worst


def write_rescore_corpus(root: str, seed: int) -> None:
    """RESCORE_CLIPS WAVs of 1.5-15 s with letter transcripts, their
    manifest and the letter dict; and ``rnnt.tsv``, the shortest
    RNNT_RESCORE_CLIPS of them."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed + 74)
    with open(os.path.join(root, "dict.ltr.txt"), "w") as fh:
        fh.writelines(f"{c} {1000 - i}\n" for i, c in enumerate(LETTERS))
    rows, texts = [], []
    for i in range(RESCORE_CLIPS):
        seconds = float(rng.uniform(1.5, 15.0))
        wav = synthetic_speechlike(seconds, rng)
        wavfile.write(os.path.join(root, f"r{i}.wav"), SR,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        rows.append((f"r{i}.wav", len(wav)))
        texts.append(" ".join(rng.choice(LETTERS[1:], size=int(
            14 * seconds))) + " |")
    short = sorted(range(len(rows)), key=lambda j: rows[j][1])
    for stem, keep in (("valid", range(len(rows))),
                       ("rnnt", short[:RNNT_RESCORE_CLIPS])):
        with open(os.path.join(root, f"{stem}.tsv"), "w") as tf, \
                open(os.path.join(root, f"{stem}.ltr"), "w") as lf:
            tf.write(root + "\n")
            for j in keep:
                tf.write(f"{rows[j][0]}\t{rows[j][1]}\n")
                lf.write(texts[j] + "\n")


def text_ids(text: str, vocab_list) -> list:
    """A beam transcript of ``cli.test`` back to its ids: each symbol is
    one character or a bracketed special (``<pad>``), '|' the space."""
    import re

    index = {v: i for i, v in enumerate(vocab_list)}
    return [index[t] for t in re.findall(r"<[^>]*>|.", text)]


def rescore_on_cpu(outputs, vocab_list, lm_dir: str, device_beam: bool
                   ) -> dict:
    """The RESCORE_CPU_UTTS shortest utterances' picks recomputed on the
    CPU from the card's log-probs: the n-best of the search ``cli.test`` ran
    (the host library's, or the device search on the card), the exact
    CTC and the LM on the CPU, whose pick must be the card's or within a
    near tie of it; the CTC kernel's and the card LM's scores against the
    CPU's; with the device search, whether the CPU's own device search
    gave the same n-best (flat log-probs of a random model put near ties
    at the beam's cut, where the two may keep different prefixes)."""
    from audio8_tpu_torch.ops.beam import PrefixBeamSearch
    from audio8_tpu_torch.ops.rescore import (NeuralLMRescorer,
                                              ctc_label_logp)

    search = PrefixBeamSearch(vocab_list, alpha=0.7, beta=5.0,
                              beam=RESCORE_BEAM,
                              device="cuda" if device_beam else False)
    cpu_search = PrefixBeamSearch(vocab_list, alpha=0.7, beta=5.0,
                                  beam=RESCORE_BEAM, device=device_beam)
    cpu = NeuralLMRescorer(lm_dir, alpha=0.5, word_bonus=0.0)
    card = NeuralLMRescorer(lm_dir, alpha=0.5, word_bonus=0.0,
                            device="cuda")
    res = {"equal": 0, "near_tie": 0, "ctc_rel_err": 0.0,
           "lm_rel_err": 0.0, "cpu_search_equal": []}
    for o in sorted(outputs, key=lambda o: len(o["log_probs"])
                    )[:RESCORE_CPU_UTTS]:
        lp = o["log_probs"]
        hyps = search.run(lp[None], [len(lp)], n_best=RESCORE_BEAM,
                          return_ids=True)[0]
        if device_beam:
            res["cpu_search_equal"].append(hyps == cpu_search.run(
                lp[None], [len(lp)], n_best=RESCORE_BEAM,
                return_ids=True)[0])
        ac = ctc_label_logp(lp, len(lp), hyps)
        ac_card = ctc_label_logp(torch.from_numpy(lp).cuda(), len(lp), hyps)
        lm = cpu.lm_logp(hyps)
        lm_card = card.lm_logp(hyps)
        res["ctc_rel_err"] = max(res["ctc_rel_err"], float(
            np.abs(ac - ac_card).max() / max(1.0, np.abs(ac).max())))
        res["lm_rel_err"] = max(res["lm_rel_err"], float(
            np.abs(lm - lm_card).max() / max(1.0, np.abs(lm).max())))
        total = np.where([len(h) == 0 for h in hyps], -np.inf,
                         ac + cpu.alpha * lm)
        mine = int(np.argmax(total))
        picked = text_ids(o["beam"], vocab_list)
        check(picked in hyps, f"rescore: the card's pick {o['beam']!r} is "
              "not in the search's n-best")
        theirs = hyps.index(picked)
        if theirs == mine:
            res["equal"] += 1
        else:
            gap = abs(total[mine] - total[theirs])
            check(gap <= BEAM_TIE * max(1.0, abs(total[mine])),
                  f"rescore: card pick {theirs} vs CPU {mine}, gap {gap}")
            res["near_tie"] += 1
    check(res["ctc_rel_err"] <= 1e-4 and res["lm_rel_err"] <= 1e-3,
          f"rescore scores card vs CPU {res}")
    return res


def decode_rescore(tmp: str, seed: int, lm_dir: str, gen) -> tuple:
    """``cli.test --beam RESCORE_BEAM --lm_rescore`` the f32 LM on the CTC
    cell's ``ctc.pt`` (a random base model's when phase 21 runs alone)
    over RESCORE_CLIPS clips, with and without ``--device_beam``: kernel
    1 once per utterance, kernels 2 and 3 once per forward, the picks
    the CPU's but near ties (:func:`rescore_on_cpu`), the host ms per
    utterance of the beam, the CTC recompute and the LM; kernel 1
    against its plain version at the rescoring shape; then ``cli.test
    --transducer --beam RNNT_RESCORE_BEAM --lm_rescore`` on the RNN-T
    cell's f32 checkpoint (a random transducer at its JAX defaults when
    the phase runs alone) over the shortest clips. Returns
    (results, the CTC runs' launches, kernel 1's error)."""
    from audio8_tpu_torch.cli import test as test_cli
    from audio8_tpu_torch.config import TransducerConfig
    from audio8_tpu_torch.models.convert import save_fairseq_ctc
    from audio8_tpu_torch.models.text import read_vocab_list
    from audio8_tpu_torch.models.transducer import Transducer
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.utils import Offsets

    corpus = os.path.join(tmp, "rescore_corpus")
    os.makedirs(corpus, exist_ok=True)
    write_rescore_corpus(corpus, seed)
    v = 4 + len(LETTERS)
    ckpt = os.path.join(tmp, "ctc.pt")
    if not os.path.exists(ckpt):
        save_fairseq_ctc(Wav2Vec2AcousticModel(
            base_config(v), generator=torch.Generator().manual_seed(seed)),
            ckpt)
    common = ["--root_dir", corpus, "--valid_dataset", "valid.tsv",
              "--checkpoint", ckpt, "--beam", str(RESCORE_BEAM),
              "--lm_rescore", lm_dir, "--device", "cuda"]
    out, total = {}, {}
    for device_beam in ("false", "true"):
        reset_launches()
        with timed("decode_rescore_cli"), \
                contextlib.redirect_stdout(io.StringIO()):
            m = test_cli.evaluate(common + ["--device_beam", device_beam],
                                  keep_outputs=True)
        launches = read_launches()
        n, batches = m["utterances"], m["step"]
        want = {k: 0 for k in launches}
        want.update(ctc_loss=n, attention_fwd=12 * batches,
                    conv_k3s2_fwd=4 * batches)
        check(launches == want and n == RESCORE_CLIPS
              and math.isfinite(m[f"werr_rescore_{RESCORE_BEAM}"]),
              f"cli.test --lm_rescore device_beam {device_beam}: "
              f"{launches} != {want}, {n} utterances")
        Offsets.remap_fairseq_ctc()
        vocab_list = read_vocab_list(os.path.join(corpus, "dict.ltr.txt"))
        with timed("decode_rescore_cpu"):
            cpu = rescore_on_cpu(m["outputs"], vocab_list, lm_dir,
                                 device_beam == "true")
        hyp_labels = [len(text_ids(o["beam"], vocab_list))
                      for o in m["outputs"]]
        out[f"device_beam_{device_beam}"] = {
            "werr": m[f"werr_rescore_{RESCORE_BEAM}"], "wer": m["wer"],
            "utterances": n, "eval_seconds": m["eval_seconds"],
            "host_ms_per_utterance": {k: 1e3 * s / n for k, s in
                                      m["rescore_seconds"].items()},
            "beam_seconds": m["beam_seconds"], "launches": launches,
            "pick_labels": hyp_labels, "cpu": cpu}
        for k, c in launches.items():
            total[k] = total.get(k, 0) + c
    frames = max(len(o["log_probs"]) for o in m["outputs"])
    labels = max(1, max(hyp_labels))
    with timed("decode_rescore_kernel"):
        err = check_ctc("decode_kernel", (RESCORE_BEAM, frames, v),
                        [frames] * RESCORE_BEAM,
                        [labels] + [max(1, labels // 2)]
                        * (RESCORE_BEAM - 1), gen)

    # the RNN-T cell's f32 checkpoint (2 steps from a CTC warm start), or
    # a random transducer's when phase 21 runs alone
    rnnt_ckpt = os.path.join(tmp, "rnnt_f32", "checkpoint-step-2.pt")
    if not os.path.exists(rnnt_ckpt):
        rnnt_ckpt = os.path.join(tmp, "rescore_rnnt.pt")
        cfg = TransducerConfig(vocab_size=v, timestep_masking=0.0,
                               channel_masking=0.0)
        torch.save({"kind": "transducer", "model": Transducer(
            cfg, generator=torch.Generator().manual_seed(seed + 75)
        ).state_dict()}, rnnt_ckpt)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        m = test_cli.evaluate(["--root_dir", corpus, "--valid_dataset",
                               "rnnt.tsv", "--checkpoint", rnnt_ckpt,
                               "--transducer", "true", "--beam",
                               str(RNNT_RESCORE_BEAM), "--lm_rescore",
                               lm_dir, "--device", "cuda"])
    check(m["utterances"] == RNNT_RESCORE_CLIPS and math.isfinite(m["wer"]),
          f"cli.test --transducer --lm_rescore: {m}")
    out["transducer"] = {"wer": m["wer"], "utterances": m["utterances"],
                         "eval_seconds": m["eval_seconds"],
                         "wall_s": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    return out, total, err


def phase_decode(tmp: str, seed: int, gen) -> tuple:
    """Phase 21: the device beam (:func:`decode_beam`), the text LM's
    trainer (:func:`decode_lm`) and n-best rescoring through ``cli.test``
    (:func:`decode_rescore`). Returns the launches of the LM runs and of
    the rescoring runs, and the kernels' max errors."""
    with timed("decode_beam"):
        beam = decode_beam(seed)
    emit({"phase": "decode_beam", **beam})
    with timed("decode_lm"):
        lm, lm_dir, lm_launches, worst = decode_lm(tmp, seed, gen)
    emit({"phase": "decode_lm", **lm})
    with timed("decode_rescore"):
        rescore, rescore_launches, err = decode_rescore(tmp, seed, lm_dir,
                                                        gen)
    emit({"phase": "decode_rescore", **rescore})
    worst["ctc_loss"] = err
    emit({"phase": "decode", "config": {
        "beam": f"peaky log-probs {list(beam['shape'])}, beams "
                f"{list(BEAM_WIDTHS)}, beta {BEAM_BETA} (and "
                f"{BONUS_BETA} at beam {BEAM_WIDTHS[-1]})",
        "lm": "CausalTextLM 512 wide, 8 heads, 6 layers, 2048, rpr_k 8, "
              "block 512, batch 32, dropout 0.1 (the JAX defaults)",
        "rescore": f"wav2vec2-base CTC, beam {RESCORE_BEAM}, "
                   f"{RESCORE_CLIPS} clips of 1.5-15 s; transducer at its "
                   f"JAX defaults, beam {RNNT_RESCORE_BEAM}"},
        "lm_launches": lm_launches, "rescore_launches": rescore_launches,
        "kernel_max_abs_err": worst})
    return lm_launches, rescore_launches, worst


def decode_phases(gen) -> int:
    """The build and phase 21 alone (``--decode-phases``), then the phase
    seconds, the card and the last line."""
    with timed("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        lm_launches, rescore_launches, worst = phase_decode(tmp, SEED, gen)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "decode_phases", "lm_launches": lm_launches,
          "rescore_launches": rescore_launches,
          "kernel_max_abs_err": worst})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# phase 22: the Mixture-of-Experts FFN

MOE_EXPERTS = 8
# the pretraining model: top-1 (Switch) at the JAX default capacity
MOE = {"moe_experts": MOE_EXPERTS, "moe_top_k": 1,
       "moe_capacity_factor": 1.25}
MOE_AUX_RTOL = 1e-5  # card vs CPU: the routers run in float32
MOE_TIE = 1e-6  # a token whose two likeliest experts are this close
MOE_BATCH = (20, 71_428)  # the pretraining run's largest batch (T' 222)
MOE_VS_CPU_SAMPLES = 71_428
MOE_PATH = PRETRAIN_PATH
MOE_CTC_PATH = TRAIN_PATH
MOE_CLI = ["--moe_experts", str(MOE_EXPERTS), "--moe_top_k", "2"]
# two CTC steps from the MoE pretraining checkpoint, the first frozen;
# SGD, so the two saves (1.17 GB each) carry no moments
MOE_CTC_FLAGS = ["--target_tokens_per_batch", "700000", "--grad_accum",
                 "1", "--train_steps", "2", "--unfreeze_enc_after_step",
                 "0", "--warmup_steps", "1", "--valid_steps", "1",
                 "--optim", "sgd", "--num_train_workers", "4"]


@contextlib.contextmanager
def moe_routing(stats: list):
    """While the block runs, each MoE layer's forward appends its routing
    to ``stats`` (a global forward hook; it reads the tokens back to the
    host, so it stays out of timed steps): the tokens each expert kept,
    the tokens whose two likeliest experts are within MOE_TIE (a near
    tie, which rounding may flip), and the layer's aux loss."""
    from audio8_tpu_torch.nn.moe import MoEFFN, capacity, route

    def hook(module, args, out):
        if not isinstance(module, MoEFFN):
            return
        with torch.no_grad():
            x = args[0]
            s = x.shape[0] * x.shape[1]
            probs = torch.softmax(module.router(x.reshape(s, -1).float()),
                                  dim=-1)
            cap = capacity(s, module.num_experts, module.top_k,
                           module.capacity_factor)
            slots, _ = route(probs, module.top_k, cap)
            kept = torch.zeros(module.num_experts, dtype=torch.long,
                               device=x.device)
            for idx, pos in slots:
                kept.index_add_(0, idx, (pos < cap).long())
            top = probs.topk(min(3, module.num_experts), dim=-1).values
            gaps = top[:, :-1] - top[:, 1:]
            ties = int((gaps[:, :module.top_k] <= MOE_TIE).any(-1).sum())
        stats.append({"kept": kept.tolist(), "tokens": s, "capacity": cap,
                      "near_ties": ties, "aux": float(out[1])})

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield stats
    finally:
        handle.remove()


def moe_vs_cpu_fields(g: dict, c: dict) -> dict:
    """The MoE readings of :func:`phase_pretrain_vs_cpu` (card ``g``, CPU
    ``c``): ``moe_aux`` within MOE_AUX_RTOL, and in each MoE layer the
    tokens each expert kept equal, or apart by no more than the CPU's
    near ties (each flips one token from one expert to another). The
    failures are listed, not raised, so the line is printed first."""
    aux_err = abs(g["moe_aux"] - c["moe_aux"]) / abs(c["moe_aux"])
    layers, failures = [], []
    for i, (rg, rc) in enumerate(zip(g["routing"], c["routing"])):
        moved = sum(abs(a - b) for a, b in zip(rg["kept"], rc["kept"])) // 2
        layers.append({"kept_card": rg["kept"], "kept_cpu": rc["kept"],
                       "moved": moved, "near_ties": rc["near_ties"],
                       "capacity": rc["capacity"]})
        if moved > rc["near_ties"]:
            failures.append(f"MoE layer {i}: {moved} tokens kept by other "
                            f"experts, {rc['near_ties']} near ties")
    if len(g["routing"]) != len(c["routing"]) or not g["routing"]:
        failures.append(f"MoE layers seen: {len(g['routing'])} card, "
                        f"{len(c['routing'])} CPU")
    if aux_err > MOE_AUX_RTOL:
        failures.append(f"moe_aux card vs CPU {aux_err}")
    return {"moe": MOE, "moe_aux": [g["moe_aux"], c["moe_aux"]],
            "moe_aux_rel_err": aux_err, "moe_aux_rtol": MOE_AUX_RTOL,
            "moe_layers": layers, "moe_failures": failures}


def moe_model(dtype, seed: int, moe: bool = True):
    """The full-width pretraining model (``PretrainConfig()``: 768 wide,
    12 heads, 12 layers, 3072; with MOE its layers 1, 3, ..., 11 hold 8
    experts each) on the card, the JAX init drawn from ``seed``."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    cfg = PretrainConfig(**(MOE if moe else {}))
    return Wav2Vec2Model(cfg, dtype, torch.Generator().manual_seed(
        seed)).cuda()


def moe_predicted(cfg) -> dict:
    """Each kernel's launches in one pretraining step, as the code
    predicts them: kernels 3, 3b and 3c once a k3s2 layer, 2 and 2b once
    a layer, 4 once for every dropout the forward draws (counted on a
    copy at width 32 on the CPU; the MoE FFN draws none) and once more in
    its backward, 5 once."""
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model

    model = Wav2Vec2Model(small_copy(cfg))
    drops = counted_dropouts(lambda: model(
        torch.zeros(2, 4000), PretrainSeeds(1, 2, 3),
        generator=torch.Generator().manual_seed(0)))
    k3s2 = sum(1 for _, k, s in cfg.conv_features if (k, s) == (3, 2))
    return {"conv_k3s2_fwd": k3s2, "conv_k3s2_dgrad": k3s2,
            "conv_k3s2_wgrad": k3s2, "attention_fwd": cfg.num_layers,
            "attention_bwd": cfg.num_layers, "dropout": 2 * drops,
            "adamw": 1}


def moe_split(layer, rows: int, frames: int) -> dict:
    """Device ms of one MoE layer's forward at the step's (rows, frames,
    768) input, split into the router (its f32 product, softmax and aux
    loss), the dispatch (routing and the gather), the expert GEMMs (the
    two batched products, their biases and gelu) and the combine; the
    whole layer forward, and forward and backward; the dispatch's
    costliest kernels by name. The forward and
    backward also run under ``torch.cuda.set_sync_debug_mode("error")``:
    a host read inside the layer raises."""
    from audio8_tpu_torch.nn.layers import gelu
    from audio8_tpu_torch.nn.moe import (capacity, combine, dispatch,
                                         load_balance_loss, route)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    x = torch.randn(rows, frames, layer.wi.shape[1], device="cuda",
                    generator=gen)
    dt = layer.compute_dtype
    s, e = rows * frames, layer.num_experts
    cap = capacity(s, e, layer.top_k, layer.capacity_factor)
    xf = x.reshape(s, -1)
    wi, wo = layer.wi.to(dt), layer.wo.to(dt)
    bi, bo = layer.bi.to(dt)[:, None], layer.bo.to(dt)[:, None]

    def router():
        p = torch.softmax(layer.router(xf.float()), dim=-1)
        return p, load_balance_loss(p)

    probs, _ = router()

    def dispatched():
        slots, weights = route(probs, layer.top_k, cap)
        return slots, weights, dispatch(xf.to(dt), slots, e, cap)

    slots, weights, xe = dispatched()

    def experts():
        return torch.bmm(gelu(torch.bmm(xe, wi) + bi), wo) + bo

    ye = experts()
    xg = x.clone().requires_grad_()

    def fwd_bwd():
        y, aux = layer(xg)
        (y.float().sum() + aux).backward()

    with torch.no_grad():
        out = {name: timed_device_ms(fn) for name, fn in (
            ("router", router), ("dispatch", dispatched),
            ("experts", experts),
            ("combine", lambda: combine(ye, slots, weights)),
            ("layer_forward", lambda: layer(x)))}
    out["layer_forward_backward"] = timed_device_ms(fwd_bwd)
    with torch.no_grad():
        by_name = traced_or_none(dispatched)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fwd_bwd()
        torch.cuda.synchronize()
    except RuntimeError as err:
        check(False, f"a host sync inside the MoE layer: {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    layer.zero_grad(set_to_none=True)
    row = {"input": [rows, frames, int(x.shape[-1])], "capacity": cap,
           "experts": e, "timed_by": sorted({t for _, t in out.values()}),
           **{f"{k}_ms": v for k, (v, _) in out.items()},
           "dispatch_kernels": len(by_name),
           "dispatch_top_kernels_ms": [[k[:80], v] for k, v in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:5]],
           "host_syncs_in_layer": 0}
    row["split_sum_ms"] = sum(row[f"{k}_ms"] for k in (
        "router", "dispatch", "experts", "combine"))
    return row


def moe_timing(seed: int) -> tuple:
    """The MoE pretraining step at MOE_BATCH (the recipe's dropouts and
    masks, AdamW) in f32 and bf16, beside the dense f32 step from the
    same seed, in turns (moe f32, dense f32, moe bf16, moe f32): first
    one MoE f32 step with the launches counted (against
    :func:`moe_predicted`) and the path's calls recorded; then per model
    the wall ms of 3 steps and a trace's device ms and idle share (the
    MoE f32 model's second turn: wall only), peak memory beside the
    three runs' resident memory (their parameters and moments), and the
    MoE layers' device split (:func:`moe_split`). Returns the readings,
    the launches, the prediction, the path's calls, the parameter shapes
    and the f32 model (whose weights the CTC run starts from)."""
    from audio8_tpu_torch.config import CONV_FEATURES, conv_output_length
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    rows, samples = MOE_BATCH
    rng = np.random.default_rng(seed + 72)
    signal = torch.from_numpy(np.stack([
        synthetic_speechlike((samples + 1) / SR, rng)[:samples]
        for _ in range(rows)])).cuda()
    runs = {}
    for name, dt, moe in (("moe_f32", torch.float32, True),
                          ("dense_f32", torch.float32, False),
                          ("moe_bf16", torch.bfloat16, True)):
        model = moe_model(dt, seed + 70, moe)
        state = TrainState(model, create_optimizer(create_lrs(
            2e-5, 100, "constant", warmup_steps=0), weight_decay=0.01))
        runs[name] = (model, state, make_pretrain_steps(model)[0])
    gen = torch.Generator().manual_seed(seed + 73)
    model, state, step = runs["moe_f32"]
    predicted = moe_predicted(model.config)
    calls = {}
    reset_launches()
    with recorded_path_calls(calls):
        _, m = step(state, signal, PretrainSeeds.draw(gen), gen)
    torch.cuda.synchronize()
    launches = {k: n for k, n in read_launches().items() if k in MOE_PATH}
    first = {"loss": float(m["loss"]), "moe_aux": float(m["moe_aux"]),
             "grad_norm": float(m["grad_norm"])}
    check(all(math.isfinite(v) for v in first.values())
          and first["moe_aux"] >= 1.0 - 1e-5, f"moe step {first}")
    check(launches == predicted, f"moe step launches {launches} against "
          f"the prediction {predicted}")
    params = [tuple(p.shape) for p in model.parameters()]
    out = {"shape": [rows, samples], "first_step": first,
           "params": {k: sum(p.numel() for p in v[0].parameters())
                      for k, v in runs.items()}}
    for turn, name in enumerate(("moe_f32", "dense_f32", "moe_bf16",
                                 "moe_f32")):
        model, state, step = runs[name]

        def step_fn(st, flags, step=step):
            step(st, signal, PretrainSeeds.draw(gen), gen)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 1e9  # the three runs'
        if turn < 3:
            t = step_timings(state, step_fn, {"step": {}}, n=3)["step"]
        else:
            t = {"wall_ms": [event_ms(lambda: step_fn(state, {}), 1)
                             for _ in range(3)]}
        t["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        t["resident_gb"] = resident
        # the step's own activations and temporaries (and, in the first
        # step of a run, AdamW's moments)
        t["step_above_resident_gb"] = t["peak_memory_gb"] - resident
        t["audio_s_per_s"] = rows * samples / SR / (
            float(np.median(t["wall_ms"])) / 1e3)
        out.setdefault(name, []).append(t)
    frames = conv_output_length(samples, CONV_FEATURES[16])
    out["moe_layer_split"] = {
        name: moe_split(runs[name][0].encoder.layers[1].moe, rows, frames)
        for name in ("moe_f32", "moe_bf16")}
    model = runs["moe_f32"][0]
    del runs
    torch.cuda.empty_cache()
    return out, launches, predicted, calls, params, model


@contextlib.contextmanager
def moe_ctc_calls(records: list):
    """While the block runs, ``cli.train``'s step factory records every
    fused train step and evaluation as ``(kind, frozen, launches in the
    call, the gradient's sums)``: the routers', the last MoE layer's
    experts' (which no router reads: a frozen step leaves them 0), the
    first layer's attention's and the CTC head's."""
    from audio8_tpu_torch.cli import train as train_cli

    real = train_cli.make_ctc_steps

    def made(model, *args, **kwargs):
        grad_fn, update_fn, eval_fn = real(model, *args, **kwargs)
        real_step = grad_fn.train_step
        last = model.config.num_layers - 1
        groups = {"routers": ".moe.router.",
                  "last_experts": f"layers.{last}.moe.w",
                  "first_attention": "layers.0.self_attn.",
                  "ctc_head": "proj."}

        def train_step(state, batch, generator, freeze=True):
            real_apply = state.apply_gradients

            def apply(grads, *a, **k):
                sums = {g: float(sum(v.abs().sum() for n, v in grads.items()
                                     if pat in n))
                        for g, pat in groups.items()}
                records[-1] = records[-1][:3] + (sums,)
                return real_apply(grads, *a, **k)

            state.apply_gradients = apply
            before = read_launches()
            records.append(("train", freeze, None, None))
            try:
                out = real_step(state, batch, generator, freeze)
            finally:
                del state.apply_gradients
            after = read_launches()
            records[-1] = ("train", freeze, {k: after[k] - before[k]
                                             for k in after},
                           records[-1][3])
            return out

        def evaluate(batch):
            before = read_launches()
            out = eval_fn(batch)
            after = read_launches()
            records.append(("eval", True, {k: after[k] - before[k]
                                           for k in after}, None))
            return out

        grad_fn.train_step = train_step
        return grad_fn, update_fn, evaluate

    train_cli.make_ctc_steps = made
    try:
        yield records
    finally:
        train_cli.make_ctc_steps = real


def moe_ctc(tmp: str, corpus: str, ckpt: str) -> tuple:
    """``cli.train --moe_experts 8 --moe_top_k 2`` from the MoE
    pretraining checkpoint, 2 steps of SGD (MOE_CTC_FLAGS), the first
    with the encoder frozen. As in JAX (``stop_gradient`` on the encoder's
    output), the frozen step's encoder gradient is the aux loss's alone:
    the routers' and the first layer's attention's non-zero, the last
    MoE layer's experts' zero; the unfrozen step's all non-zero. Per
    step, as the code predicts: kernel 1 once, kernels 3 and 2 once a
    k3s2 layer and a layer, and 2b once a layer in both steps (the aux
    reaches every layer; a dense frozen step launches none); per
    evaluation kernels 1, 2 and 3 alike and no backward. Returns the
    readings, the run's launches and the last checkpoint."""
    from audio8_tpu_torch.cli import train as train_cli

    basedir = os.path.join(tmp, "moe_ctc")
    records = []
    reset_launches()
    t0 = time.perf_counter()
    with moe_ctc_calls(records):
        state = train_cli.train([
            "--root_dir", corpus, "--train_dataset", "train.tsv",
            "--valid_dataset", "valid.tsv", "--basedir", basedir,
            "--device", "cuda", "--restart_from", ckpt, *MOE_CLI,
            *MOE_CTC_FLAGS])
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items()
                if k in MOE_CTC_PATH}
    layers = state.model.config.num_layers
    k3s2 = sum(1 for _, k, s in state.model.config.conv_features
               if (k, s) == (3, 2))
    steps = [r for r in records if r[0] == "train"]
    evals = [r for r in records if r[0] == "eval"]
    check([r["frozen"] for r in state.log] == [True, False]
          and all(math.isfinite(r["loss"]) for r in state.log),
          f"moe CTC run: {state.log}")
    check([f for _, f, _, _ in steps] == [True, False] and evals,
          f"moe CTC calls {[(k, f) for k, f, _, _ in records]}")
    for kind, frozen, got, _ in records:
        want = {"ctc_loss": 1, "attention_fwd": layers,
                "conv_k3s2_fwd": k3s2,
                "attention_bwd": layers if kind == "train" else 0}
        check(all(got[k] == n for k, n in want.items()),
              f"moe CTC {kind} (frozen {frozen}) launches {got}, want "
              f"{want}")
    (_, _, _, frozen), (_, _, _, unfrozen) = steps
    check(frozen["routers"] > 0 and frozen["first_attention"] > 0
          and frozen["last_experts"] == 0 and frozen["ctc_head"] > 0,
          f"moe CTC frozen step gradient sums {frozen}")
    check(all(v > 0 for v in unfrozen.values()),
          f"moe CTC unfrozen step gradient sums {unfrozen}")
    out = {"wall_s": wall, "log": state.log, "frozen_grad_abs_sums": frozen,
           "unfrozen_grad_abs_sums": unfrozen,
           "launches_per_call": [{"kind": k, "frozen": f, **{
               n: v for n, v in got.items() if n in MOE_CTC_PATH}}
               for k, f, got, _ in records]}
    del state
    torch.cuda.empty_cache()
    return out, launches, os.path.join(basedir, "checkpoint-step-2.pt")


def moe_serve(tmp: str, corpus: str, ckpt: str, seed: int) -> tuple:
    """The MoE CTC checkpoint served: ``cli.transcribe`` on four WAVs of
    30, 24, 11 and 4 s, and its loader, ``load_acoustic``, in f32, bf16
    and under ``--quantize int8`` dispatching the (4, 30 s) batch (event
    ms, launches, the bf16 texts' agreement with the f32 ones reported;
    the int8 model's quantized Dense count must be the dense model's
    less the two FFN layers of each MoE layer: the routers, 8 wide, and
    the experts stay float, as in JAX), and ``cli.export`` of a 30 s
    entry for the card, whose log-probs must be bitwise the live f32
    forward's (``check_exported``). Returns the readings and the
    launches."""
    import audio8_tpu_torch.cli.transcribe as transcribe
    from scipy.io import wavfile

    from audio8_tpu_torch.cli import export as export_cli
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.export import load_artifact
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.ops.quant import _is_plain_dense

    dict_file = os.path.join(corpus, "dict.ltr.txt")
    sig, lens = export_batch(EXPORT_LENGTHS, seed + 74)
    wavs = []
    for i, n in enumerate(EXPORT_LENGTHS):
        wavs.append(os.path.join(tmp, f"moe_serve{i}.wav"))
        wavfile.write(wavs[-1], SR, (np.clip(sig[i, :n].cpu().numpy(), -1,
                                             1) * 32767).astype(np.int16))
    base = ["--checkpoint", ckpt, "--dict_file", dict_file, "--device",
            "cuda", *MOE_CLI]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        served = transcribe.main([*base, *wavs])
    out = {"cli_s": time.perf_counter() - t0,
           "cli_texts_chars": [len(t) for _, t in served]}
    check(len(served) == len(wavs), f"moe cli.transcribe: {served}")
    launches, lives, texts, counts = {}, {}, {}, []
    real_quantize = transcribe.quantize_model_params

    def counted(model, *args, **kwargs):
        counts.append(real_quantize(model, *args, **kwargs))
        return counts[-1]

    for variant, flags in (("f32", []), ("bf16", ["--bf16"]),
                           ("int8", ["--quantize", "int8"])):
        transcribe.quantize_model_params = counted
        try:
            cfg, live, _, index2vocab, _ = transcribe.load_acoustic(
                transcribe.parse_args(["x.wav", *base, *flags]))
        finally:
            transcribe.quantize_model_params = real_quantize
        with torch.inference_mode():
            reset_launches()
            lp, frames = live(sig, lens)
            torch.cuda.synchronize()
            ran = {k: v for k, v in read_launches().items() if v}
            ms = [event_ms(lambda: live(sig, lens), 1) for _ in range(3)]
        check(ran == {"attention_fwd": 12, "conv_k3s2_fwd": 4},
              f"moe serve {variant}: one dispatch launched {ran}")
        check(bool(torch.isfinite(lp).all()),
              f"moe serve {variant}: non-finite log-probs")
        texts[variant] = greedy_texts(lp, frames, index2vocab)
        out[variant] = {"dispatch_event_ms": ms,
                        "audio_s_per_s": float(lens.sum()) / SR
                        / (float(np.median(ms)) / 1e3),
                        "launches": ran}
        for k, v in ran.items():
            launches[k] = launches.get(k, 0) + v
        lives[variant] = (live, index2vocab)
    out["bf16_texts_equal_f32"] = [a == b for a, b in zip(texts["f32"],
                                                          texts["bf16"])]

    dense = sum(1 for m in Wav2Vec2AcousticModel(AcousticConfig(
        num_labels=cfg.num_labels)).modules() if _is_plain_dense(m, 64))
    every = max(cfg.moe_every, 1)
    moe_layers = sum(1 for i in range(cfg.num_layers)
                     if i % every == every - 1)
    out["int8"].update(quantized=counts, dense_model_quantized=dense,
                       moe_layers=moe_layers)
    check(counts == [dense - 2 * moe_layers],
          f"int8 quantized {counts} Dense, want {dense} - 2 x {moe_layers}")

    path, seconds = os.path.join(tmp, "moe_art"), None
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        export_cli.main([*base, "--output", path, "--seconds", "30",
                         "--platforms", "cuda"])
    seconds = time.perf_counter() - t0
    art = load_artifact(path, "cuda")
    live, index2vocab = lives["f32"]
    with torch.inference_mode():
        row = check_exported("f32", art, live, index2vocab, sig, lens)
    check(row["bitwise"], f"moe export: log-probs not bitwise the live "
          f"forward's ({row['max_abs_err']})")
    out["export"] = {"export_s": seconds, **row}
    del lives, art, live
    torch.cuda.empty_cache()
    return out, launches


def phase_moe(tmp: str, seed: int, gen) -> tuple:
    """Phase 22: the Mixture-of-Experts FFN at full width (module
    docstring). Returns the phase's launches (the timed pretraining
    step's, the CTC run's and the served dispatches' summed) and the
    kernels' max errors at its shapes."""
    from audio8_tpu_torch.models.convert import save_fairseq_pretrained

    corpus = os.path.join(tmp, "moe_corpus")
    os.makedirs(corpus)
    write_corpus(corpus, seed + 75)
    dirs = [corpus, os.path.join(tmp, "moe_pretrain"),
            os.path.join(tmp, "moe_ctc"), os.path.join(tmp, "moe_art")]
    with timed("moe_vs_cpu"):
        vs_cpu = phase_pretrain_vs_cpu(seed + 70, MOE_VS_CPU_SAMPLES,
                                       moe=MOE)
    torch.cuda.empty_cache()
    with timed("moe_timing"):
        timing, launches, predicted, calls, params, model = moe_timing(seed)
    emit({"phase": "moe_step", "card": card_name(), **timing,
          "launches": launches, "predicted": predicted})
    with timed("moe_kernel"):
        worst = ssl_kernels(calls, params, gen, "moe")
    os.makedirs(dirs[1])
    ckpt = os.path.join(dirs[1], "checkpoint-step-6.pt")
    save_fairseq_pretrained(model, ckpt)
    del model
    torch.cuda.empty_cache()
    with timed("moe_ctc"):
        ctc, ctc_launches, ctc_ckpt = moe_ctc(tmp, corpus, ckpt)
    emit({"phase": "moe_ctc", **ctc, "launches": ctc_launches})
    with timed("moe_serve"):
        serve, serve_launches = moe_serve(tmp, corpus, ctc_ckpt, seed)
    emit({"phase": "moe_serve", "card": card_name(), **serve})
    moe_launches = {k: launches.get(k, 0) + ctc_launches.get(k, 0)
                    + serve_launches.get(k, 0) for k in REPLACES}
    emit({"phase": "moe", "config": {
        "pretrain": "wav2vec2-base d768 h12 L12 ff3072, MoE FFN in layers "
                    "1, 3, ..., 11: 8 experts, top-1, capacity factor 1.25",
        "ctc": "the same encoder, top-2, 32 labels"},
        "vs_cpu_moe_aux_rel_err": vs_cpu["moe_aux_rel_err"],
        "launches": moe_launches, "kernel_max_abs_err": worst,
        "bytes_written": tree_bytes(*dirs),
        "bytes_written_by_dir": {os.path.basename(d): tree_bytes(d)
                                 for d in dirs}})
    return moe_launches, worst


def moe_phases(gen) -> int:
    """The build and phase 22 alone (``--moe-phases``), then the phase
    seconds, the card and the last line."""
    with timed("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        launches, worst = phase_moe(tmp, SEED, gen)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "moe_phases", "launches": launches,
          "kernel_max_abs_err": worst})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ------------------------------------------------------------------ phase 23

DP_PATH = ("conv_k3s2_fwd", "attention_fwd", "attention_bwd", "ctc_loss",
           "dropout")
# (a) and (b) run full width at 4 of the 12 layers
DP_LAYERS = 4
# (a): cli.train, 2 SGD steps (each of the two runs writes two small SGD
# checkpoints: validate_on = 1 at 2 steps)
DP_CLI_FLAGS = ["--target_tokens_per_batch", "700000", "--grad_accum", "1",
                "--train_steps", "2", "--unfreeze_enc_after_step", "0",
                "--warmup_steps", "1", "--valid_steps", "1", "--optim",
                "sgd", "--num_layers", str(DP_LAYERS)]
DP_RANKS = 2
DP_CTC_SECONDS = (10.0, 8.0, 6.0, 0.0)  # the global CTC batch; a padding row
DP_PRETRAIN_BATCH = (4, 71_428)  # the global pretraining batch
DP_STEPS = 2
# SGD: the parameters move by the (clipped) gradient, so a rounding-level
# gradient difference stays one (AdamW normalises a noise-level gradient,
# an attention key bias's, into a step of the learning rate)
DP_LR = 1e-4
DP_LOSS_RTOL = 1e-4  # 2 ranks vs 1 on the card: the train_vs_cpu gates
DP_GNORM_RTOL = 1e-3
DP_PARAM_ATOL = 1e-6
DP_STRIDE = 97  # the parameter sample compared across processes


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_env(rank: int, world: int, local_rank: int, port: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))


def dp_env_clear() -> None:
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        os.environ.pop(k, None)


def dp_sample(model) -> dict:
    """Every ``DP_STRIDE``-th value of each parameter, on the host."""
    return {n: p.detach().reshape(-1)[::DP_STRIDE].float().cpu()
            for n, p in model.named_parameters()}


def dp_ctc_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t = int(max(DP_CTC_SECONDS) * SR)
    b = len(DP_CTC_SECONDS)
    signal = np.zeros((b, t), np.float32)
    lengths = np.array([int(s * SR) for s in DP_CTC_SECONDS], np.int32)
    for i, n in enumerate(lengths):
        if n:
            signal[i, :n] = synthetic_speechlike(n / SR + 1e-3, rng)[:n]
    u = 140
    tok_len = np.where(lengths > 0, u - 10 * np.arange(b), 0).astype(
        np.int32)
    tokens = rng.integers(4, 4 + len(LETTERS), size=(b, u)).astype(np.int32)
    tokens[np.arange(u)[None, :] >= tok_len[:, None]] = 1  # fairseq's PAD
    return {"signal": signal, "signal_lengths": lengths,
            "token_ids": tokens, "token_lengths": tok_len}


def dp_steps(rank: int, world: int, group, seed: int) -> dict:
    """Rank ``rank``'s block of phase 23 (b): ``DP_STEPS`` SGD CTC steps
    (unfrozen, every dropout 0.1, the span masks on) and ``DP_STEPS``
    SGD pretraining steps (dropout 0.1) at full wav2vec2-base width and
    ``DP_LAYERS`` layers on its
    rows of the global batches, the seeds drawn from CPU generators seeded
    alike on every rank; ``group`` None and ``world`` 1: one process on
    the whole batches. Returns the global losses, gradient norms, the
    parameters' checksums and samples, and (under a group) the ms of one
    gloo all-reduce of the CTC model's gradients."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import (PretrainSeeds,
                                                  Wav2Vec2AcousticModel,
                                                  Wav2Vec2Model)
    from audio8_tpu_torch.parallel.sharding import (all_reduce_grads,
                                                    checksum,
                                                    global_sum_scalars,
                                                    row_block)
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.train.steps import (make_ctc_steps,
                                              make_pretrain_steps)
    from audio8_tpu_torch.utils import Offsets

    Offsets.remap_fairseq_ctc()  # the CTC trainer's ids, in every process

    def state_of(model):
        return TrainState(model, create_optimizer(create_lrs(
            DP_LR, 10, sched_type="constant", warmup_steps=0), "sgd"))

    out = {"ctc": {"loss": [], "gnorm": []},
           "pretrain": {"loss": [], "gnorm": [], "ppl": [], "accuracy": []}}
    batch = dp_ctc_batch(seed)
    n_real = int((batch["signal_lengths"] > 0).sum())
    lo, b_local, _ = row_block(n_real, len(DP_CTC_SECONDS), rank, world)
    local = {k: torch.from_numpy(v[lo:lo + b_local]).cuda()
             for k, v in batch.items()}
    local["row_offset"] = lo
    cfg = AcousticConfig(num_labels=len(LETTERS) + 4, dropout=0.1,
                         attention_dropout=0.1, timestep_masking=0.5,
                         channel_masking=0.1, freeze_fx=False,
                         num_layers=DP_LAYERS)
    model = Wav2Vec2AcousticModel(
        cfg, generator=torch.Generator().manual_seed(seed)).cuda()
    state = state_of(model)
    grad_fn, update_fn, _ = make_ctc_steps(model, group=group)
    gen = torch.Generator().manual_seed(seed + 1)
    for _ in range(DP_STEPS):
        loss, grads, rows, _ = grad_fn(local, gen, freeze=False)
        state, gnorm = update_fn(state, grads, rows)
        out["ctc"]["loss"].append(
            float(global_sum_scalars([float(loss)], group)[0]))
        out["ctc"]["gnorm"].append(float(gnorm))
    if group is not None:
        zeros = [torch.zeros_like(p) for p in model.parameters()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_grads(zeros, group)
        torch.cuda.synchronize()
        out["gloo_allreduce_ms"] = (time.perf_counter() - t0) * 1e3
        out["allreduce_bytes"] = sum(z.numel() * 4 for z in zeros)
        del zeros
    out["ctc"]["checksum"] = checksum(model)
    out["ctc"]["sample"] = dp_sample(model)
    del model, state, grads
    torch.cuda.empty_cache()

    rows, samples = DP_PRETRAIN_BATCH
    rng = np.random.default_rng(seed + 2)
    sig = np.stack([synthetic_speechlike((samples + 1) / SR, rng)[:samples]
                    for _ in range(rows)])
    b_local = rows // world
    x = torch.from_numpy(sig[rank * b_local:(rank + 1) * b_local]).cuda()
    model = Wav2Vec2Model(PretrainConfig(
        dropout=0.1, dropout_input=0.1, dropout_features=0.1,
        num_layers=DP_LAYERS),
        generator=torch.Generator().manual_seed(seed + 3)).cuda()
    state = state_of(model)
    step, _ = make_pretrain_steps(model, group=group)
    gen = torch.Generator().manual_seed(seed + 4)
    for _ in range(DP_STEPS):
        state, m = step(state, x, PretrainSeeds.draw(gen), gen,
                        rank * b_local)
        for k, key in (("loss", "loss"), ("gnorm", "grad_norm"),
                       ("ppl", "code_perplexity"),
                       ("accuracy", "accuracy")):
            out["pretrain"][k].append(float(m[key]))
    out["pretrain"]["checksum"] = checksum(model)
    out["pretrain"]["sample"] = dp_sample(model)
    del model, state
    torch.cuda.empty_cache()
    return out


def _dp_rank(rank: int, world: int, port: int, out_dir: str,
             seed: int) -> None:
    """One gloo rank of phase 23 (b), sharing the one card
    (``LOCAL_RANK`` 0 on every rank): the process group through
    ``parallel/sharding.py:setup`` with the gloo backend, gloo's
    all-gather of CUDA tensors (``per_rank``, which the MoE routing and
    CLIP's gathered rows use), :func:`dp_steps`, its launches."""
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from audio8_tpu_torch.parallel.sharding import (per_rank, setup,
                                                    world_group)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp_env(rank, world, 0, port)
    setup(True, "cuda:0", backend="gloo")
    group = world_group()
    every = per_rank(torch.full((2,), float(rank), device="cuda"), group)
    gather = every[:, 0].tolist() == [float(r) for r in range(world)]
    reset_launches()
    out = dp_steps(rank, world, group, seed)
    out["launches"] = read_launches()
    out["all_gather_cuda"] = gather
    torch.save(out, os.path.join(out_dir, f"dp_rank{rank}.pt"))
    dist.destroy_process_group()


def dp_close(a: list, b: list, rtol: float, what: str) -> float:
    err = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))
    check(err <= rtol, f"{what}: {a} vs {b} (rel {err} > {rtol})")
    return err


def dp_compare(ranks: list, one: dict, kind: str) -> dict:
    """Ranks bitwise equal to each other (checksums, samples, metrics);
    rank 0 against one process within the gates."""
    r0 = ranks[0][kind]
    for r in ranks[1:]:
        check(r[kind]["checksum"] == r0["checksum"],
              f"dp {kind}: rank parameters differ (checksums)")
        check(all(torch.equal(v, r0["sample"][k])
                  for k, v in r[kind]["sample"].items()),
              f"dp {kind}: rank parameter samples differ")
        check(r[kind]["loss"] == r0["loss"], f"dp {kind}: rank losses")
    errs = {"loss_rel_err": dp_close(r0["loss"], one[kind]["loss"],
                                     DP_LOSS_RTOL, f"dp {kind} loss"),
            "gnorm_rel_err": dp_close(r0["gnorm"], one[kind]["gnorm"],
                                      DP_GNORM_RTOL, f"dp {kind} grad norm")}
    worst = 0.0
    for k, v in r0["sample"].items():
        d = float((v - one[kind]["sample"][k]).abs().max())
        worst = max(worst, d)
        check(d <= DP_PARAM_ATOL, f"dp {kind} {k}: {d} > {DP_PARAM_ATOL}")
    return {**errs, "param_max_abs_err": worst}


def dp_kernels(gen) -> dict:
    """Kernels 4, 2, 2b, 6 and 6b with a nonzero row base against their
    plain versions on the card, in float32 and bfloat16: a rank's rows 2..
    of a (4, 15 s) CTC batch (dropout on the (2, 749, 768) stream, the
    core on (2, 12, 749, 64) in both semantics, the block's forward and
    gradients on (2, 222, 768)), and bases past the 2**32 wrap; plus
    each kernel's event ms at base 0 and at the base, in turns. Returns
    the max errors."""
    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_bwd_plain,
                                                attention_core_plain)
    from audio8_tpu_torch.ops.dropout import fused_dropout, hash_dropout
    from audio8_tpu_torch.ops.hashrand import row_base

    worst = {"dropout": 0.0, "attention_fwd": 0.0, "attention_bwd": 0.0,
             "attention_block": 0.0, "attention_block_bwd": 0.0}
    shape = (2,) + DROPOUT_SHAPE[1:]
    for dtype in (torch.float32, torch.bfloat16):
        x, dy = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                 for _ in range(2))
        for base in (row_base(shape, 2), 2 ** 32 - 1000):
            xg = x.detach().requires_grad_()
            y = fused_dropout(xg, 0.1, DROPOUT_SEED, base)
            (dx,) = torch.autograd.grad(y, xg, dy)
            torch.cuda.synchronize()
            err = max(max_err(y, hash_dropout(x, 0.1, DROPOUT_SEED,
                                              base))[0],
                      max_err(dx, hash_dropout(dy, 0.1, DROPOUT_SEED,
                                               base))[0])
            emit({"phase": "dp_kernel", "kernel": "dropout",
                  "dtype": str(dtype), "shape": list(shape), "base": base,
                  "max_abs_err": err, "tol": 0.0})
            check(err == 0.0, f"dropout base {base} {dtype}: {err}")
            worst["dropout"] = max(worst["dropout"], err)
    b, h, t, dh = 2, 12, 749, 64
    lengths = torch.tensor([612, 0], device="cuda")
    kv = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
    wrap_b0 = 2 ** 32 // (h * t * t) + 1  # xla: the flat index wraps
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn((b, h, t, dh), device="cuda",
                                   generator=gen).to(dtype)
                       for _ in range(4))
        for xla in (True, False):
            for b0 in (2, wrap_b0):
                qs = [a.detach().requires_grad_() for a in (q, k, v)]
                o = attention_core(*qs, kv, dh ** -0.5, 0.1, 4_000_000_000,
                                   xla=xla, b0=b0)
                grads = torch.autograd.grad(o, qs, do)
                torch.cuda.synchronize()
                want = attention_core_plain(q, k, v, kv, dh ** -0.5, 0.1,
                                            4_000_000_000, xla=xla, b0=b0)
                err, scale = max_err(o, want)
                tol = TOL[dtype] * max(1.0, scale)
                check(err <= tol, f"attention_fwd b0 {b0} xla {xla} "
                                  f"{dtype}: {err} > {tol}")
                worst["attention_fwd"] = max(worst["attention_fwd"], err)
                gerr = 0.0
                for g, w in zip(grads, attention_core_bwd_plain(
                        q, k, v, kv, dh ** -0.5, 0.1, 4_000_000_000, do,
                        xla=xla, b0=b0)):
                    e, s = max_err(g, w)
                    check(e <= TOL[dtype] * max(1.0, s),
                          f"attention_bwd b0 {b0} xla {xla} {dtype}: {e}")
                    gerr = max(gerr, e)
                worst["attention_bwd"] = max(worst["attention_bwd"], gerr)
                emit({"phase": "dp_kernel", "kernel": "attention_core",
                      "dtype": str(dtype), "shape": [b, h, t, dh],
                      "key_lengths": [612, 0], "xla": xla, "b0": b0,
                      "rate": 0.1, "max_abs_err": {"fwd": err,
                                                    "bwd": gerr},
                      "tol_factor": TOL[dtype]})
    # kernels 6 and 6b: rows 2.. and rows whose head index seed +
    # (b0 + b) * H wraps past 2**32, forward and the nine gradients
    for dtype in (torch.float32, torch.bfloat16):
        for b0 in (2, 2 ** 32 // BLOCK_HEADS):
            fwd, bwd = check_block("dp_kernel", 2, 222, 768, BLOCK_HEADS,
                                   [200, 0], dtype, gen, b0=b0)
            worst["attention_block"] = max(worst["attention_block"], fwd)
            worst["attention_block_bwd"] = max(worst["attention_block_bwd"],
                                               bwd)

    x = torch.randn(DROPOUT_SHAPE, device="cuda", generator=gen)
    q, k, v = (torch.randn(ATTN_SHAPE, device="cuda", generator=gen)
               for _ in range(3))
    base_ms = {}
    for name, run in (
            ("dropout", lambda base: fused_dropout(x, 0.1, 7, base)),
            ("attention_fwd", lambda base: attention_core(
                q, k, v, None, 0.125, 0.1, 7, xla=True, b0=base))):
        turns = []
        for base in (0, 2, 0, 2):
            turns.append(event_ms(lambda: run(
                row_base(x.shape, base) if name == "dropout" else base),
                calls=10))
        base_ms[name] = {"base0_ms": turns[0::2], "base_ms": turns[1::2]}
    emit({"phase": "dp_kernel_ms", "card": card_name(), **base_ms})
    return worst


def phase_dp(tmp: str, seed: int, gen) -> tuple:
    """Phase 23: data parallelism (module docstring). Returns the launches
    of (a)'s ``--distributed`` run and the kernels' max errors at nonzero
    row bases."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from audio8_tpu_torch.cli.train import train
    from audio8_tpu_torch.parallel.sharding import all_reduce_grads

    corpus = os.path.join(tmp, "dp_corpus")
    os.makedirs(corpus)
    write_corpus(corpus, seed + 80)
    argv = ["--root_dir", corpus, "--train_dataset", "train.tsv",
            "--valid_dataset", "valid.tsv", "--device", "cuda",
            *DP_CLI_FLAGS]
    def max_diff(params, others):
        return max(float((a.detach() - b).abs().max())
                   for a, b in zip(params, others))

    # cuDNN's deterministic algorithms (the positional conv's backward):
    # the plain run is then repeatable, and the --distributed one must be
    # bitwise equal to it
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with timed("dp_cli"):
        plain = train(argv + ["--basedir", os.path.join(tmp, "dp_plain")])
        plain_params = [p.detach().clone() for p in plain.params]
        del plain
        torch.cuda.empty_cache()
        dp_env(0, 1, 0, free_port())
        try:
            reset_launches()
            state = train(argv + ["--basedir", os.path.join(tmp, "dp_run"),
                                  "--distributed", "true"])
            launches = read_launches()
            check(dist.is_initialized()
                  and dist.get_backend() == "nccl"
                  and dist.get_world_size() == 1, "dp: no NCCL group")
            dp_diff = max_diff(state.params, plain_params)
            emit({"phase": "dp", "part": "a_check",
                  "distributed_max_abs_diff": dp_diff})
            check(dp_diff == 0.0, f"dp (a): --distributed (1 rank, NCCL) "
                                  f"parameters differ from the plain "
                                  f"run's by {dp_diff}")
            zeros = [torch.zeros_like(p) for p in state.params]
            allreduce_ms = [event_ms(lambda: all_reduce_grads(zeros,
                                                              None),
                                     calls=5) for _ in range(2)]
            nbytes = sum(z.numel() * 4 for z in zeros)
            log = state.log
            del state, zeros, plain_params
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            dp_env_clear()
            torch.backends.cudnn.deterministic = deterministic
        torch.cuda.empty_cache()
    for k in DP_PATH:
        check(launches[k] > 0, f"dp (a): {k} not launched")
    emit({"phase": "dp", "part": "a", "card": card_name(),
          "flags": DP_CLI_FLAGS, "backend": "nccl", "world": 1,
          "params_bitwise_equal": True,
          "losses": [r["loss"] for r in log],
          "step_seconds": [r["seconds"] for r in log],
          "allreduce_ms": allreduce_ms, "allreduce_bytes": nbytes,
          "launches": {k: launches[k] for k in DP_PATH + ("adamw",)}})

    with timed("dp_ranks"):
        one = dp_steps(0, 1, None, seed + 81)
        torch.cuda.empty_cache()
        out_dir = os.path.join(tmp, "dp_ranks")
        os.makedirs(out_dir)
        mp.start_processes(_dp_rank, args=(DP_RANKS, free_port(), out_dir,
                                           seed + 81),
                           nprocs=DP_RANKS, start_method="spawn", join=True)
        ranks = [torch.load(os.path.join(out_dir, f"dp_rank{r}.pt"))
                 for r in range(DP_RANKS)]
    check(all(r["all_gather_cuda"] for r in ranks),
          "dp (b): gloo's all-gather of CUDA tensors gave wrong values")
    ctc = dp_compare(ranks, one, "ctc")
    pre = dp_compare(ranks, one, "pretrain")
    for k in DP_PATH:
        check(ranks[0]["launches"][k] > 0, f"dp (b): {k} not launched")
    emit({"phase": "dp", "part": "b", "card": card_name(),
          "backend": "gloo (CUDA tensors, one card)", "world": DP_RANKS,
          "ctc_seconds": list(DP_CTC_SECONDS),
          "pretrain_batch": list(DP_PRETRAIN_BATCH), "steps": DP_STEPS,
          "ctc": {**ctc, "loss": ranks[0]["ctc"]["loss"],
                  "one_rank_loss": one["ctc"]["loss"]},
          "pretrain": {**pre, "loss": ranks[0]["pretrain"]["loss"],
                       "one_rank_loss": one["pretrain"]["loss"],
                       "ppl": ranks[0]["pretrain"]["ppl"],
                       "one_rank_ppl": one["pretrain"]["ppl"]},
          "all_gather_cuda": [r["all_gather_cuda"] for r in ranks],
          "gloo_allreduce_ms": [r["gloo_allreduce_ms"] for r in ranks],
          "allreduce_bytes": ranks[0]["allreduce_bytes"],
          "rank0_launches": ranks[0]["launches"]})
    with timed("dp_kernel"):
        worst = dp_kernels(gen)
    emit({"phase": "dp", "launches": {k: launches[k] for k in REPLACES},
          "kernel_max_abs_err": worst,
          "bytes_written": tree_bytes(corpus, os.path.join(tmp, "dp_plain"),
                                      os.path.join(tmp, "dp_run"))})
    return {k: launches[k] for k in REPLACES}, worst


def dp_phases(gen) -> int:
    """The build and phase 23 alone (``--dp-phases``), then the phase
    seconds, the card and the last line."""
    with timed("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        launches, worst = phase_dp(tmp, SEED, gen)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "dp_phases", "launches": launches,
          "kernel_max_abs_err": worst})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ------------------------------------------------------------------ phase 24

ORBAX_GOLDEN = os.path.join(HERE, "tests", "fixtures", "orbax_golden")
# (a): the fixture's tiny models resumed with every dropout at 0.1, so
# the hash dropout (kernel 4) runs; the CTC model's extractor trains, so
# its stride-2 conv runs forward and backward
ORBAX_DROPOUT = 0.1
ORBAX_STEPS = {"ctc": 2, "pretrain": 1}
ORBAX_CTC_PATH = ("conv_k3s2_fwd", "conv_k3s2_dgrad", "conv_k3s2_wgrad",
                  "attention_fwd", "attention_bwd", "dropout", "ctc_loss",
                  "adamw")
# (b): cli.train at full width, 4 of the 12 layers (phase 23's cut), SGD;
# validate_on = 1, so every step writes a checkpoint (about 150 MB each)
ORBAX_LAYERS = DP_LAYERS
ORBAX_SIZE = ["--num_layers", str(ORBAX_LAYERS)]
ORBAX_CLI_FLAGS = ["--target_tokens_per_batch", "700000", "--grad_accum",
                   "1", "--unfreeze_enc_after_step", "0", "--warmup_steps",
                   "1", "--valid_steps", "1", "--optim", "sgd"]
ORBAX_FULL_PATH = ("conv_k3s2_fwd", "attention_fwd", "attention_bwd",
                   "ctc_loss", "dropout")


def orbax_model(kind: str, manifest: dict, device: str):
    """The fixture's ``kind`` model (dropout ORBAX_DROPOUT) and its
    TrainState on ``device``, restored from the fixture's directory by
    ``cli.common.resolve_restart`` (the full state: step 2)."""
    from audio8_tpu_torch.cli.common import resolve_restart
    from audio8_tpu_torch.config import AcousticConfig, PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2AcousticModel,
                                                  Wav2Vec2Model)
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)

    cfg = dict(manifest[kind]["config"])
    cfg["custom_conv_features"] = tuple(map(tuple,
                                            cfg["custom_conv_features"]))
    for k in ("dropout", "attention_dropout", "dropout_input",
              "dropout_features"):
        cfg[k] = ORBAX_DROPOUT
    model = (Wav2Vec2AcousticModel(AcousticConfig(**cfg)) if kind == "ctc"
             else Wav2Vec2Model(PretrainConfig(**cfg))).to(device)
    opt = manifest[kind]
    state = TrainState(model, create_optimizer(
        create_lrs(**manifest["schedule"]), opt["optim"],
        opt["weight_decay"]))
    step = resolve_restart(os.path.join(ORBAX_GOLDEN, kind), state,
                           ctc=kind == "ctc")
    check(step == state.opt_state.count == manifest["steps"],
          f"orbax (a): {kind} restored step {step}, count "
          f"{state.opt_state.count}: not the full state")
    return state


def orbax_resume(kind: str, manifest: dict, device: str, seed: int) -> dict:
    """ORBAX_STEPS[kind] steps of the fixture's TrainState resumed on
    ``device``: the losses, the first step's Gumbel codes (pretraining)
    and, on the card, the launches."""
    from tools.make_orbax_golden_fixtures import ctc_batch, pretrain_signal
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds
    from audio8_tpu_torch.train.steps import (make_ctc_steps,
                                              make_pretrain_steps)

    state = orbax_model(kind, manifest, device)
    model, opt = state.model, manifest[kind]
    losses, codes = [], []
    reset_launches()
    if kind == "ctc":
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 ctc_batch(opt["batch_seed"]).items()}
        grad_fn, update_fn, _ = make_ctc_steps(model, clip=opt["clip"])
        for i in range(ORBAX_STEPS[kind]):
            loss, grads, bsz, _ = grad_fn(
                batch, torch.Generator().manual_seed(seed + i), freeze=False)
            update_fn(state, grads, bsz)
            losses.append(float(loss))
    else:
        signal = torch.from_numpy(pretrain_signal(
            opt["signal_seed"])).to(device)
        step, _ = make_pretrain_steps(
            model, clip=opt["clip"],
            n_negatives=opt["config"]["n_negatives"])
        hook = model.quantizer.register_forward_hook(
            lambda m, i, o: codes.append(o[2].cpu()))
        for i in range(ORBAX_STEPS[kind]):
            _, metrics = step(state, signal, PretrainSeeds(
                mask=seed + 11 * i + 1, gumbel=seed + 11 * i + 2,
                negatives=seed + 11 * i + 3),
                torch.Generator().manual_seed(seed + i))
            losses.append(float(metrics["loss"]))
        hook.remove()
    launches = read_launches()
    check(all(np.isfinite(losses)), f"orbax (a): {kind} losses {losses}")
    return {"losses": losses, "codes": codes, "launches": launches}


def orbax_golden(seed: int) -> dict:
    """Phase 24 (a); returns the card runs' launches, summed."""
    from audio8_tpu_torch.csrc import native
    from audio8_tpu_torch.models.convert import params_from_jax
    from audio8_tpu_torch.train.orbax import load_checkpoint
    from audio8_tpu_torch.utils import Offsets

    with open(os.path.join(ORBAX_GOLDEN, "MANIFEST.json")) as f:
        manifest = json.load(f)
    expected = np.load(os.path.join(ORBAX_GOLDEN, "expected.npz"))
    Offsets.remap_fairseq_ctc()  # the fixture's CTC blank
    t0 = time.perf_counter()
    native.lib()  # the host library's zstd, built outside the timed reads
    emit({"phase": "orbax", "host_library_s": time.perf_counter() - t0})
    launches = {}
    for kind in ("ctc", "pretrain"):
        path = os.path.join(ORBAX_GOLDEN, kind, "checkpoint-step-2")
        t0 = time.perf_counter()
        tree = load_checkpoint(path)
        read_s = time.perf_counter() - t0
        sd, (count, mu, nu) = params_from_jax(tree["params"],
                                              tree["opt_state"])
        got = {"count": np.asarray(count),
               "step": np.asarray(int(tree["step"]))}
        for part, d in (("params", sd), ("mu", mu), ("nu", nu)):
            got.update({f"{part}/{k}": v.numpy() for k, v in d.items()})
        want = {k[len(kind) + 1:] for k in expected.files
                if k.startswith(kind + "/")}
        check(set(got) == want and all(
            np.array_equal(expected[f"{kind}/{k}"], v)
            for k, v in got.items()),
            f"orbax (a): the {kind} fixture does not read bitwise to "
            "expected.npz")
        card = orbax_resume(kind, manifest, "cuda", seed)
        cpu = orbax_resume(kind, manifest, "cpu", seed)
        rtol = TRAIN_LOSS_RTOL
        agree = None
        if kind == "pretrain":
            agree = float((card["codes"][0] == cpu["codes"][0]).float()
                          .mean())
            rtol = TRAIN_LOSS_RTOL if agree == 1.0 else PRETRAIN_LOSS_RTOL
        err = rel(card["losses"][0], cpu["losses"][0])
        path_of = ORBAX_CTC_PATH if kind == "ctc" else PRETRAIN_PATH
        ran = card["launches"]
        emit({"phase": "orbax", "part": "a", "kind": kind,
              "read_s": read_s, "bytes": tree_bytes(path),
              "bitwise_expected": True, "steps": ORBAX_STEPS[kind],
              "losses": card["losses"], "cpu_losses": cpu["losses"],
              "first_loss_rel_err": err, "rtol": rtol,
              "code_agreement": agree,
              "launches": {k: ran[k] for k in path_of}})
        check(err <= rtol, f"orbax (a): {kind} first loss card vs CPU "
                           f"{err} > {rtol}")
        for k in path_of:
            check(ran[k] > 0, f"orbax (a): {k} not launched by the {kind} "
                              "resume")
            launches[k] = launches.get(k, 0) + ran[k]
    return launches


def orbax_full(tmp: str, seed: int) -> dict:
    """Phase 24 (b); returns the launches of the Orbax resume."""
    from scipy.io import wavfile

    from audio8_tpu_torch.cli import convert_checkpoint, transcribe
    from audio8_tpu_torch.cli.train import train
    from audio8_tpu_torch.models.text import read_vocab_list
    from audio8_tpu_torch.train import orbax
    from audio8_tpu_torch.train.checkpoint import find_latest_checkpoint

    corpus = os.path.join(tmp, "orbax_corpus")
    os.makedirs(corpus)
    write_corpus(corpus, seed + 90)
    argv = ["--root_dir", corpus, "--train_dataset", "train.tsv",
            "--valid_dataset", "valid.tsv", "--device", "cuda",
            *ORBAX_CLI_FLAGS, *ORBAX_SIZE]
    run = os.path.join(tmp, "orbax_run")
    with timed("orbax_train"):
        train(argv + ["--basedir", run, "--train_steps", "2"])
    pt, step = find_latest_checkpoint(run)
    check(step == 2 and pt.endswith(".pt"), f"orbax (b): trained {pt}")
    dict_file = os.path.join(corpus, "dict.ltr.txt")
    t0 = time.perf_counter()
    out = convert_checkpoint.main([
        "--input", pt, "--output", os.path.join(tmp, "orbax_conv",
                                                "checkpoint"),
        "--output_format", "orbax", "--ctc", "true", "--num_labels",
        str(len(read_vocab_list(dict_file))), *ORBAX_SIZE])
    convert_s = time.perf_counter() - t0
    written = tree_bytes(out)
    t0 = time.perf_counter()
    tree = orbax.load_checkpoint(out)
    read_s = time.perf_counter() - t0
    check(int(tree["step"]) == 2 and "opt_state" in tree,
          "orbax (b): the converted directory is not the TrainState")
    t0 = time.perf_counter()  # the writer alone, on the same tree
    again = orbax.save_checkpoint(tree, os.path.join(tmp, "orbax_rewrite"),
                                  2)
    write_s = time.perf_counter() - t0
    shutil.rmtree(again)
    del tree
    # the positional conv's backward: cuDNN's deterministic algorithms,
    # so the two resumed runs can be bitwise equal
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with timed("orbax_resume"):
            reset_launches()
            a = train(argv + ["--basedir", os.path.join(tmp, "orbax_a"),
                              "--train_steps", "3", "--restart_from", out])
            launches = read_launches()
            pa = [p.detach().cpu() for p in a.params]
            la = [r["loss"] for r in a.log]
            del a
            torch.cuda.empty_cache()
            b = train(argv + ["--basedir", os.path.join(tmp, "orbax_b"),
                              "--train_steps", "3", "--restart_from", run])
            pb = [p.detach().cpu() for p in b.params]
            lb = [r["loss"] for r in b.log]
            del b
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
    check(len(la) == len(lb) == 1 and la == lb,
          f"orbax (b): resumed losses {la} (Orbax) vs {lb} (.pt)")
    check(diff == 0.0, f"orbax (b): resumed parameters differ by {diff}")
    for k in ORBAX_FULL_PATH:
        check(launches[k] > 0, f"orbax (b): {k} not launched")
    with timed("orbax_transcribe"):
        rng = np.random.default_rng(seed + 91)
        wav = synthetic_speechlike(6.0, rng)
        wav_path = os.path.join(tmp, "orbax_utt.wav")
        wavfile.write(wav_path, SR, (np.clip(wav, -1, 1) * 32767)
                      .astype(np.int16))
        common = ["--dict_file", dict_file, *ORBAX_SIZE, "--device", "cuda"]
        sig = torch.from_numpy(wav.astype(np.float32))[None].cuda()
        lens = torch.tensor([len(wav)], device="cuda")
        lps = []
        for ckpt in (out, pt):
            args = transcribe.parse_args(["--checkpoint", ckpt, *common,
                                          wav_path])
            _, forward, _, _, _ = transcribe.load_acoustic(args)
            lps.append(forward(sig, lens)[0].cpu())
            del forward
            torch.cuda.empty_cache()
        texts = [transcribe.main(["--checkpoint", c, *common, wav_path])
                 for c in (out, pt)]
    check(torch.equal(lps[0], lps[1]),
          "orbax (b): transcribe's log-probs from the Orbax directory are "
          "not the .pt's")
    check(texts[0] == texts[1], f"orbax (b): transcripts {texts}")
    emit({"phase": "orbax", "part": "b", "card": card_name(),
          "layers": ORBAX_LAYERS, "flags": ORBAX_CLI_FLAGS,
          "orbax_dir_bytes": written, "convert_s": convert_s,
          "write_s": write_s, "read_s": read_s,
          "resumed_loss": la, "params_bitwise_equal": True,
          "logprobs_bitwise_equal": True, "transcript": texts[0],
          "launches": {k: launches[k] for k in ORBAX_FULL_PATH}})
    return launches


def phase_orbax(tmp: str, seed: int) -> dict:
    """Phase 24 (module docstring). Returns the launches of (a)'s card
    resumes and (b)'s Orbax resume, summed."""
    start = time.perf_counter()
    with timed("orbax"):
        launches = orbax_golden(seed)
        for k, n in orbax_full(tmp, seed).items():
            launches[k] = launches.get(k, 0) + n
    emit({"phase": "orbax", "seconds": time.perf_counter() - start,
          "bytes_written": tree_bytes(*(os.path.join(tmp, d) for d in (
              "orbax_corpus", "orbax_run", "orbax_conv", "orbax_a",
              "orbax_b", "orbax_utt.wav") if os.path.exists(
                  os.path.join(tmp, d)))),
          "launches": {k: launches.get(k, 0) for k in REPLACES}})
    return {k: launches.get(k, 0) for k in REPLACES}


def orbax_phases() -> int:
    """The build and phase 24 alone (``--orbax-phases``), then the phase
    seconds, the card and the last line."""
    with timed("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_orbax(tmp, SEED)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "orbax_phases", "launches": launches})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ------------------------------------------------------------------ phase 25

ZERO_LAYERS = DP_LAYERS  # full width, 4 of the 12 layers (phase 23's cut)
# (a): cli.train under AdamW, 2 steps (validate_on = 1: a checkpoint each,
# about 0.45 GB with its moments at 4 layers), then one cli.pretrain step
ZERO_CLI_FLAGS = ["--target_tokens_per_batch", "700000", "--grad_accum",
                  "1", "--train_steps", "2", "--unfreeze_enc_after_step",
                  "0", "--warmup_steps", "1", "--valid_steps", "1",
                  "--optim", "adamw", "--weight_decay", "0.01", "--num_layers",
                  str(ZERO_LAYERS)]
ZERO_PRETRAIN_FLAGS = ["--tokens_per_batch", "1400000", "--max_sample_len",
                       "325000", "--train_steps", "1",
                       "--steps_per_checkpoint", "3", "--warmup_steps", "1",
                       "--num_train_workers", "1", "--num_layers",
                       str(ZERO_LAYERS)]
ZERO_PATH = ("conv_k3s2_fwd", "attention_fwd", "attention_bwd", "ctc_loss",
             "dropout", "adamw")
ZERO_RANKS = 2
ZERO_MODES = ("dp", "zero1", "fsdp")
ZERO_LR = 1e-4
ZERO_LOSS_RTOL = 1e-6  # the sharded ranks against the 2-rank DP run
ZERO_PARAM_ATOL = 1e-6


def zero_state(model, optim: str = "adamw"):
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)

    return TrainState(model, create_optimizer(create_lrs(
        ZERO_LR, 10, sched_type="constant", warmup_steps=0), optim, 0.01))


def zero_whole(state, model) -> dict:
    """Every ``DP_STRIDE``-th value of the whole parameters and moments
    and their checksum, read in ``zero.full_state`` (every rank)."""
    from audio8_tpu_torch.parallel.sharding import checksum
    from audio8_tpu_torch.parallel.zero import full_state

    with full_state(state):
        out = {"checksum": checksum(model), "sample": dp_sample(model)}
        for key in ("mu", "nu"):
            if hasattr(state.opt_state, key):
                out[key] = {n: m.detach().reshape(-1)[::DP_STRIDE].cpu()
                            for n, m in zip(state.names,
                                            getattr(state.opt_state, key))}
    return out


def zero_bytes(state, grads) -> dict:
    """This rank's persistent state in bytes: the parameters it keeps
    (whole or its chunks), the gradient storage an update takes (whole, or
    the chunks a sharded backward leaves) and the moments."""
    opt = state.opt_state
    if state.shards is not None:
        stored = state.shards.stored(state)
        params = stored["params"]
    else:
        params = sum(p.numel() for p in state.params)
    moments = sum(m.numel() for m in getattr(opt, "mu", ())) + \
        sum(v.numel() for v in getattr(opt, "nu", ()))
    n_grads = sum(g.numel() for g in grads.values())
    return {"params": 4 * params, "grads": 4 * n_grads,
            "moments": 4 * moments,
            "total": 4 * (params + n_grads + moments)}


def zero_ctc(rank: int, world: int, group, seed: int, mode: str,
             optim: str = "adamw", save: str | None = None) -> dict:
    """``DP_STEPS`` CTC steps of phase 25 (b) on rank ``rank``'s block of
    the global batch (every dropout 0.1, the span masks on, a padding
    row) under ``mode``: the global losses, gradient norms, the rank's
    bytes and the second step's peak, the whole state's samples; with
    ``save``, the checkpoint (rank 0 writes it, every rank gathers)."""
    from audio8_tpu_torch.cli.common import save_on_rank0
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.parallel.sharding import (global_sum_scalars,
                                                    row_block)
    from audio8_tpu_torch.parallel.zero import shard_state
    from audio8_tpu_torch.train.checkpoint import save_checkpoint
    from audio8_tpu_torch.train.steps import make_ctc_steps

    batch = dp_ctc_batch(seed)
    n_real = int((batch["signal_lengths"] > 0).sum())
    lo, b_local, _ = row_block(n_real, len(DP_CTC_SECONDS), rank, world)
    local = {k: torch.from_numpy(v[lo:lo + b_local]).cuda()
             for k, v in batch.items()}
    local["row_offset"] = lo
    cfg = AcousticConfig(num_labels=len(LETTERS) + 4, dropout=0.1,
                         attention_dropout=0.1, timestep_masking=0.5,
                         channel_masking=0.1, freeze_fx=False,
                         num_layers=ZERO_LAYERS)
    model = Wav2Vec2AcousticModel(
        cfg, generator=torch.Generator().manual_seed(seed)).cuda()
    state = zero_state(model, optim)
    shard_state(state, group, zero1=mode == "zero1", fsdp=mode == "fsdp")
    grad_fn, update_fn, _ = make_ctc_steps(model, group=group)
    gen = torch.Generator().manual_seed(seed + 1)
    out = {"loss": [], "gnorm": []}
    for i in range(DP_STEPS):
        if i == DP_STEPS - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        loss, grads, rows, _ = grad_fn(local, gen, freeze=False)
        nbytes = zero_bytes(state, grads)
        state, gnorm = update_fn(state, grads, rows)
        del grads
        out["loss"].append(float(global_sum_scalars([float(loss)],
                                                    group)[0]))
        out["gnorm"].append(float(gnorm))
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["bytes"] = nbytes
    out.update(zero_whole(state, model))
    if save:
        save_on_rank0(group, save_checkpoint, state, save, "ctc")
    del model, state
    torch.cuda.empty_cache()
    return out


def zero_pretrain(rank: int, world: int, group, seed: int,
                  mode: str) -> dict:
    """``DP_STEPS`` AdamW pretraining steps of phase 25 (b) (dropout
    0.1, the span masks on) on rank ``rank``'s rows under ``mode``."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
    from audio8_tpu_torch.parallel.zero import shard_state
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    rows, samples = DP_PRETRAIN_BATCH
    rng = np.random.default_rng(seed + 2)
    sig = np.stack([synthetic_speechlike((samples + 1) / SR, rng)[:samples]
                    for _ in range(rows)])
    b_local = rows // world
    x = torch.from_numpy(sig[rank * b_local:(rank + 1) * b_local]).cuda()
    model = Wav2Vec2Model(PretrainConfig(
        dropout=0.1, dropout_input=0.1, dropout_features=0.1,
        num_layers=ZERO_LAYERS),
        generator=torch.Generator().manual_seed(seed + 3)).cuda()
    state = zero_state(model)
    shard_state(state, group, zero1=mode == "zero1", fsdp=mode == "fsdp")
    step, _ = make_pretrain_steps(model, group=group)
    gen = torch.Generator().manual_seed(seed + 4)
    out = {"loss": [], "gnorm": []}
    for _ in range(DP_STEPS):
        state, m = step(state, x, PretrainSeeds.draw(gen), gen,
                        rank * b_local)
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
    out.update(zero_whole(state, model))
    del model, state
    torch.cuda.empty_cache()
    return out


def zero_collectives(group) -> dict:
    """The group's reduce-scatter and all-gather of CUDA tensors against
    their definitions, then their ms over the 4-layer CTC model's flat
    buffer (one segment, as ZeRO-1 lays it out)."""
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.parallel.sharding import (all_gather_flat,
                                                    reduce_scatter_sum,
                                                    shard_route, world_of)
    from audio8_tpu_torch.parallel.zero import Segment
    import torch.distributed as dist

    world, rank = world_of(group), dist.get_rank(group)
    x = torch.arange(4 * world, dtype=torch.float32, device="cuda") \
        * (rank + 1)
    got = reduce_scatter_sum(x, group)
    want = torch.arange(4 * world, dtype=torch.float32, device="cuda")[
        4 * rank:4 * rank + 4] * (world * (world + 1) / 2)
    gathered = all_gather_flat(torch.full((3,), float(rank), device="cuda"),
                               group)
    ok = bool(torch.equal(got, want)) and gathered.tolist() == [
        float(r) for r in range(world) for _ in range(3)]
    model = Wav2Vec2AcousticModel(AcousticConfig(
        num_labels=len(LETTERS) + 4, num_layers=ZERO_LAYERS))
    seg = Segment.of(range(len(list(model.parameters()))),
                     list(model.parameters()), world)
    del model
    flat = torch.zeros(seg.padded, device="cuda")
    chunk = flat[:seg.chunk].clone()
    ms = {"reduce_scatter": [], "all_gather": []}
    for _ in range(3):
        for name, fn in (("reduce_scatter",
                          lambda: reduce_scatter_sum(flat, group)),
                         ("all_gather",
                          lambda: all_gather_flat(chunk, group))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    del flat, chunk
    torch.cuda.empty_cache()
    return {"collectives_ok": ok, "route": shard_route(group),
            "flat_bytes": 4 * seg.padded, "ms": ms}


def _zero_rank(rank: int, world: int, port: int, out_dir: str,
               seed: int) -> None:
    """One gloo rank of phase 25 (b)-(d), sharing the one card: the
    collectives checked and timed, each mode's CTC steps (DP, ZeRO-1 and
    FSDP save a checkpoint), FSDP's SGD CTC steps, and the DP and FSDP
    pretraining steps; the launches of the sharded runs."""
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from audio8_tpu_torch.parallel.sharding import setup, world_group
    from audio8_tpu_torch.utils import Offsets

    Offsets.remap_fairseq_ctc()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the positional conv's backward: cuDNN's deterministic algorithms,
    # so that the modes' runs can be bitwise equal
    torch.backends.cudnn.deterministic = True
    dp_env(rank, world, 0, port)
    setup(True, "cuda:0", backend="gloo")
    group = world_group()
    out = {"collectives": zero_collectives(group), "ctc": {}}
    launches = {}
    for mode in ZERO_MODES:
        os.makedirs(os.path.join(out_dir, mode), exist_ok=True)
        reset_launches()
        out["ctc"][mode] = zero_ctc(
            rank, world, group, seed, mode,
            save=os.path.join(out_dir, mode,
                              f"checkpoint-step-{DP_STEPS}.pt"))
        launches[mode] = read_launches()
    out["ctc_sgd"] = zero_ctc(rank, world, group, seed, "fsdp", "sgd")
    out["pretrain"] = {m: zero_pretrain(rank, world, group, seed, m)
                       for m in ("dp", "fsdp")}
    out["launches"] = launches
    torch.save(out, os.path.join(out_dir, f"zero_rank{rank}.pt"))
    dist.destroy_process_group()


def zero_adamw_chunk(gen) -> float:
    """Kernel 5 on a ZeRO chunk: the last rank's chunk of the 4-layer CTC
    model's flat buffer at world 2 (its leaves' pieces, the alignment gaps
    and the tail padding, all zero there) cut into three slices that cross
    leaves' boundaries, against ``adamw_update_plain`` on the same slices."""
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.ops.adamw import adamw_update, adamw_update_plain
    from audio8_tpu_torch.parallel.zero import Segment

    model = Wav2Vec2AcousticModel(AcousticConfig(
        num_labels=len(LETTERS) + 4, num_layers=ZERO_LAYERS))
    params = [p.detach().cuda() for p in model.parameters()]
    del model
    seg = Segment.of(range(len(params)), params, ZERO_RANKS)
    rank = ZERO_RANKS - 1
    c0, c1 = rank * seg.chunk, (rank + 1) * seg.chunk
    layout = seg.flatten([torch.ones_like(p) for p in params])[c0:c1]
    del params
    p, g, m = (torch.randn(seg.chunk, device="cuda", generator=gen) * layout
               for _ in range(3))
    v = torch.rand(seg.chunk, device="cuda", generator=gen) * layout
    cuts = [0, seg.chunk // 3 + 17, 2 * seg.chunk // 3 + 5, seg.chunk]
    pieces = [(j, lo, hi) for j, lo, hi in seg.pieces(rank)]
    crosses = all(not any(lo <= cuts[i] and cuts[i + 1] <= hi
                          for _, lo, hi in pieces)
                  for i in range(3))
    padded = float(layout[-1]) == 0.0

    def slices(t):
        return [t[a:b] for a, b in zip(cuts, cuts[1:])]

    copies = [x.clone() for x in (p, m, v)]
    scale = torch.tensor(0.37, device="cuda")
    args = (scale, 3e-4, 0.9, 0.98, 1e-6, 0.01, 1.0 / (1.0 - 0.9 ** 3),
            1.0 / (1.0 - 0.98 ** 3))
    adamw_update(slices(p), slices(g), slices(m), slices(v), *args)
    torch.cuda.synchronize()
    adamw_update_plain(slices(copies[0]), slices(g), slices(copies[1]),
                       slices(copies[2]), *args)
    worst, tol = 0.0, 0.0
    for got, want in zip((p, m, v), copies):
        err, scale_ = max_err(got, want)
        worst, tol = max(worst, err), max(tol, TOL[torch.float32]
                                          * max(1.0, scale_))
    gaps_zero = bool((p[layout == 0] == 0).all())
    emit({"phase": "zero", "kernel": "adamw", "chunk": seg.chunk,
          "slices": [b - a for a, b in zip(cuts, cuts[1:])],
          "leaf_pieces": len(pieces), "slices_cross_leaves": crosses,
          "ends_in_padding": padded, "padding_stays_zero": gaps_zero,
          "max_abs_err": worst, "tol": tol})
    check(crosses and padded, "zero: the chunk's slices do not cross "
                              "leaves or end in padding")
    check(worst <= tol, f"zero: adamw on chunk slices {worst} > {tol}")
    check(gaps_zero, "zero: adamw moved the chunk's padding")
    return worst


def zero_cli(tmp: str, seed: int) -> dict:
    """Phase 25 (a): one NCCL rank (``WORLD_SIZE`` 1, full width, 4 of 12
    layers, cuDNN's deterministic algorithms): ``cli.train`` plain, under
    ``--distributed --zero1`` and ``--fsdp`` (2 AdamW steps each) and
    ``cli.pretrain`` plain and under ``--fsdp`` (1 step); each run's
    parameters bitwise the plain run's; the NCCL collectives' ms over the
    flat buffer. Returns the launches of the sharded runs."""
    import torch.distributed as dist

    from audio8_tpu_torch.cli import pretrain
    from audio8_tpu_torch.cli.train import train
    from audio8_tpu_torch.parallel.sharding import world_group

    corpus = os.path.join(tmp, "zero_corpus")
    os.makedirs(corpus)
    write_corpus(corpus, seed + 100)
    pcorpus = os.path.join(tmp, "zero_pretrain_corpus")
    os.makedirs(pcorpus)
    write_pretrain_corpus(pcorpus, seed + 101)
    argv = {"train": ["--root_dir", corpus, "--train_dataset", "train.tsv",
                      "--valid_dataset", "valid.tsv", "--device", "cuda",
                      *ZERO_CLI_FLAGS],
            "pretrain": ["--manifest_dir", pcorpus, "--device", "cuda",
                         *ZERO_PRETRAIN_FLAGS]}
    run = {"train": train, "pretrain": pretrain.train}
    runs = {"train": ("zero1", "fsdp"), "pretrain": ("fsdp",)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    results, launches, collectives = {}, {}, None
    try:
        for kind in ("train", "pretrain"):
            state = run[kind](argv[kind] + ["--basedir", os.path.join(
                tmp, f"zero_{kind}_plain")])
            plain = [p.detach().clone() for p in state.params]
            plain_loss = [r["loss"] for r in state.log]
            del state
            torch.cuda.empty_cache()
            for mode in runs[kind]:
                dp_env(0, 1, 0, free_port())
                try:
                    reset_launches()
                    state = run[kind](argv[kind] + [
                        "--basedir", os.path.join(tmp, f"zero_{kind}_{mode}"),
                        "--distributed", "true", f"--{mode}", "true"])
                    ran = read_launches()
                    check(dist.is_initialized()
                          and dist.get_backend() == "nccl"
                          and dist.get_world_size() == 1,
                          "zero (a): no NCCL group")
                    diff = max(float((a.detach() - b).abs().max())
                               for a, b in zip(state.params, plain))
                    results[f"{kind}_{mode}"] = {
                        "max_abs_diff": diff,
                        "losses": [r["loss"] for r in state.log],
                        "plain_losses": plain_loss,
                        "step_seconds": [r["seconds"] for r in state.log]}
                    check(diff == 0.0, f"zero (a): {kind} --{mode} (1 rank, "
                                       f"NCCL) differs from the plain run "
                                       f"by {diff}")
                    for k, n in ran.items():
                        launches[k] = launches.get(k, 0) + n
                    if collectives is None:
                        del state
                        torch.cuda.empty_cache()
                        collectives = zero_collectives(world_group())
                finally:
                    if dist.is_initialized():
                        dist.destroy_process_group()
                    dp_env_clear()
                state = None
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for k in ZERO_PATH:
        check(launches[k] > 0, f"zero (a): {k} not launched")
    check(collectives["collectives_ok"], "zero (a): NCCL's reduce-scatter "
                                         "or all-gather gave wrong values")
    emit({"phase": "zero", "part": "a", "card": card_name(),
          "backend": "nccl", "world": 1, "flags": ZERO_CLI_FLAGS,
          "pretrain_flags": ZERO_PRETRAIN_FLAGS, "runs": results,
          "params_bitwise_equal": True, "nccl": collectives,
          "launches": {k: launches[k] for k in ZERO_PATH}})
    return launches


def zero_compare(ranks: list, kind: str, mode: str, ref: str = "dp") -> dict:
    """``mode``'s ranks bitwise equal to each other and held to ``ref``'s
    run: loss rtol ZERO_LOSS_RTOL, parameters and moments
    ZERO_PARAM_ATOL (max differences reported, and whether they are 0)."""
    runs = [r[kind][mode] for r in ranks]
    for r in runs[1:]:
        check(r["checksum"] == runs[0]["checksum"]
              and r["loss"] == runs[0]["loss"],
              f"zero {kind} {mode}: ranks differ")
    mine, want = runs[0], ranks[0][kind][ref]
    loss_err = dp_close(mine["loss"], want["loss"], ZERO_LOSS_RTOL,
                        f"zero {kind} {mode} loss")
    diffs = {}
    for part in ("sample", "mu", "nu"):
        if part in want:
            diffs[part] = max(float((v - want[part][k]).abs().max())
                              for k, v in mine[part].items())
            check(diffs[part] <= ZERO_PARAM_ATOL,
                  f"zero {kind} {mode} {part}: {diffs[part]}")
    return {"loss": mine["loss"], "loss_rel_err": loss_err,
            "max_abs_diff": diffs,
            "bitwise": all(d == 0.0 for d in diffs.values())
            and mine["checksum"] == want["checksum"]}


def zero_resume(path: str, seed: int) -> float:
    """One more CTC step in one plain process on the card from the run
    directory ``path`` (its checkpoint and resume file: the moments and
    count), on the global batch; its loss."""
    from audio8_tpu_torch.cli.common import resolve_restart
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.train.steps import make_ctc_steps

    model = Wav2Vec2AcousticModel(AcousticConfig(
        num_labels=len(LETTERS) + 4, dropout=0.1, attention_dropout=0.1,
        timestep_masking=0.5, channel_masking=0.1, freeze_fx=False,
        num_layers=ZERO_LAYERS)).cuda()
    state = zero_state(model)
    step = resolve_restart(path, state, ctc=True)
    check(step == DP_STEPS == state.opt_state.count,
          f"zero (d): {path} restored step {step}, not the full state")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in dp_ctc_batch(seed).items()}
    grad_fn, update_fn, _ = make_ctc_steps(model)
    loss, grads, rows, _ = grad_fn(batch, torch.Generator().manual_seed(
        seed + 5), freeze=False)
    update_fn(state, grads, rows)
    del model, state, grads
    torch.cuda.empty_cache()
    return float(loss)


def zero_checkpoints(tmp: str, out_dir: str, seed: int) -> dict:
    """Phase 25 (d): the 2-rank checkpoints against the DP run's (whole
    parameters and moments, 1e-6), one step resumed from each in one plain
    process (the DP resume's loss), and ``cli.convert_checkpoint
    --output_format orbax`` of the ZeRO-1 one read back by the port's
    reader bitwise."""
    from audio8_tpu_torch.cli import convert_checkpoint
    from audio8_tpu_torch.models.convert import (from_fairseq_ctc_state,
                                                 params_from_jax,
                                                 read_fairseq_state)
    from audio8_tpu_torch.train import orbax
    from audio8_tpu_torch.train.checkpoint import resume_path

    def read(mode):
        pt = os.path.join(out_dir, mode, f"checkpoint-step-{DP_STEPS}.pt")
        blob = torch.load(resume_path(pt), weights_only=True)
        return pt, torch.load(pt, weights_only=False), blob

    dp_pt, dp_model, dp_blob = read("dp")
    out = {}
    for mode in ("zero1", "fsdp"):
        pt, model, blob = read(mode)
        check(sorted(model["model"]) == sorted(dp_model["model"]),
              f"zero (d): {mode} checkpoint keys")
        diff = max(float((v - dp_model["model"][k]).abs().max())
                   for k, v in model["model"].items())
        mdiff = max(float((blob[key][n] - dp_blob[key][n]).abs().max())
                    for key in ("mu", "nu") for n in dp_blob["names"])
        check(blob["names"] == dp_blob["names"]
              and blob["count"] == dp_blob["count"] == DP_STEPS,
              f"zero (d): {mode} resume file")
        check(diff <= ZERO_PARAM_ATOL and mdiff <= ZERO_PARAM_ATOL,
              f"zero (d): {mode} checkpoint differs from DP's by {diff}, "
              f"moments {mdiff}")
        out[mode] = {"params_max_abs_diff": diff,
                     "moments_max_abs_diff": mdiff}
    losses = {m: zero_resume(os.path.join(out_dir, m), seed)
              for m in ZERO_MODES}
    for mode in ("zero1", "fsdp"):
        out[mode]["resumed_loss"] = losses[mode]
        check(rel(losses[mode], losses["dp"]) <= ZERO_LOSS_RTOL,
              f"zero (d): {mode} resume loss {losses[mode]} vs DP's "
              f"{losses['dp']}")
    pt = os.path.join(out_dir, "zero1", f"checkpoint-step-{DP_STEPS}.pt")
    conv = convert_checkpoint.main([
        "--input", pt, "--output", os.path.join(tmp, "zero_orbax",
                                                "checkpoint"),
        "--output_format", "orbax", "--ctc", "true", "--num_labels",
        str(len(LETTERS) + 4), "--num_layers", str(ZERO_LAYERS)])
    tree = orbax.load_checkpoint(conv)
    sd, (count, mu, nu) = params_from_jax(tree["params"], tree["opt_state"])
    _, _, blob = read("zero1")
    want, _ = from_fairseq_ctc_state(read_fairseq_state(pt))
    bitwise = (int(count) == blob["count"]
               and all(torch.equal(torch.as_tensor(sd[k]), torch.as_tensor(v))
                       for k, v in want.items())
               and all(torch.equal(torch.as_tensor(mu[n]), blob["mu"][n])
                       and torch.equal(torch.as_tensor(nu[n]), blob["nu"][n])
                       for n in blob["names"]))
    check(bitwise, "zero (d): the Orbax directory of the ZeRO-1 save does "
                   "not read back bitwise")
    out.update(dp_resumed_loss=losses["dp"], orbax_bitwise=True,
               orbax_bytes=tree_bytes(conv))
    return out


def phase_zero(tmp: str, seed: int, gen) -> tuple:
    """Phase 25 (module docstring). Returns the launches of (a)'s sharded
    runs and kernel 5's max error on chunk slices."""
    import torch.multiprocessing as mp

    start = time.perf_counter()
    with timed("zero_cli"):
        launches = zero_cli(tmp, seed)
    with timed("zero_ranks"):
        one = {"ctc": zero_ctc(0, 1, None, seed + 110, "dp"),
               "ctc_sgd": zero_ctc(0, 1, None, seed + 110, "dp", "sgd"),
               "pretrain": zero_pretrain(0, 1, None, seed + 110, "dp")}
        out_dir = os.path.join(tmp, "zero_ranks")
        os.makedirs(out_dir)
        mp.start_processes(_zero_rank, args=(ZERO_RANKS, free_port(),
                                             out_dir, seed + 110),
                           nprocs=ZERO_RANKS, start_method="spawn",
                           join=True)
        ranks = [torch.load(os.path.join(out_dir, f"zero_rank{r}.pt"))
                 for r in range(ZERO_RANKS)]
    for r in ranks:
        check(r["collectives"]["collectives_ok"],
              "zero (b): gloo's reduce-scatter or all-gather of CUDA "
              "tensors gave wrong values")
    # (b) the sharded runs against the 2-rank DP run and one process
    held = {f"ctc_{m}": zero_compare(ranks, "ctc", m) for m in ("zero1",
                                                                "fsdp")}
    held["pretrain_fsdp"] = zero_compare(ranks, "pretrain", "fsdp")
    vs_one = {}
    for kind, mode in (("ctc", "dp"), ("ctc", "zero1"), ("ctc", "fsdp"),
                       ("pretrain", "fsdp"), ("ctc_sgd", None)):
        mine = ranks[0][kind] if mode is None else ranks[0][kind][mode]
        want = one[kind]
        name = kind if mode is None else f"{kind}_{mode}"
        vs_one[name] = {
            "loss_rel_err": dp_close(mine["loss"], want["loss"],
                                     DP_LOSS_RTOL, f"zero {name} loss"),
            "gnorm_rel_err": dp_close(mine["gnorm"], want["gnorm"],
                                      DP_GNORM_RTOL, f"zero {name} gnorm")}
    # SGD moves a parameter by its gradient: FSDP's parameters against
    # one process's (AdamW normalises a noise-level gradient into a step
    # of the learning rate, so the AdamW runs are held to the 2-rank DP
    # run instead)
    sgd_diff = max(float((v - one["ctc_sgd"]["sample"][k]).abs().max())
                   for k, v in ranks[0]["ctc_sgd"]["sample"].items())
    vs_one["ctc_sgd"]["param_max_abs_err"] = sgd_diff
    check(sgd_diff <= DP_PARAM_ATOL, f"zero (b): FSDP SGD parameters vs one "
                                     f"process {sgd_diff}")
    for mode in ("zero1", "fsdp"):
        for k in ZERO_PATH:
            check(ranks[0]["launches"][mode][k] > 0,
                  f"zero (b): {k} not launched under {mode}")
    # (c) bytes: ZeRO-1's moments are its chunk's (the padded flat buffer
    # over the ranks), FSDP's parameters, gradients and moments half DP's
    nbytes = {m: [r["ctc"][m]["bytes"] for r in ranks] for m in ZERO_MODES}
    peaks = {m: [r["ctc"][m]["peak_bytes"] for r in ranks]
             for m in ZERO_MODES}
    dp_b, z1_b, fs_b = (nbytes[m][0] for m in ZERO_MODES)
    check(z1_b["moments"] == z1_b["params"],  # 2 x (padded / 2) x 4 B
          f"zero (c): ZeRO-1 moments {z1_b['moments']} vs its flat buffer "
          f"{z1_b['params']}")
    ratio = fs_b["total"] / dp_b["total"]
    check(0.5 <= ratio <= 0.52, f"zero (c): FSDP keeps {ratio} of DP's")
    emit({"phase": "zero", "part": "b", "card": card_name(),
          "backend": "gloo (CUDA tensors, one card)", "world": ZERO_RANKS,
          "route": ranks[0]["collectives"]["route"],
          "ctc_seconds": list(DP_CTC_SECONDS),
          "pretrain_batch": list(DP_PRETRAIN_BATCH), "steps": DP_STEPS,
          "lr": ZERO_LR, "vs_dp": held, "vs_one_process": vs_one,
          "rank0_launches": ranks[0]["launches"]})
    emit({"phase": "zero", "part": "c", "card": card_name(),
          "persistent_bytes": nbytes, "step_peak_bytes": peaks,
          "fsdp_over_dp": ratio,
          "collective_ms": {"gloo": [r["collectives"] for r in ranks]}})
    with timed("zero_ckpt"):
        ckpt = zero_checkpoints(tmp, out_dir, seed + 110)
    emit({"phase": "zero", "part": "d", **ckpt})
    with timed("zero_kernel"):
        err = zero_adamw_chunk(gen)
    emit({"phase": "zero", "seconds": time.perf_counter() - start,
          "bytes_written": tree_bytes(*(os.path.join(tmp, d) for d in
                                        os.listdir(tmp)
                                        if d.startswith("zero"))),
          "launches": {k: launches.get(k, 0) for k in REPLACES}})
    return {k: launches.get(k, 0) for k in REPLACES}, {"adamw": err}


def zero_phases(gen) -> int:
    """The build and phase 25 alone (``--zero-phases``), then the phase
    seconds, the card and the last line."""
    with timed("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        launches, worst = phase_zero(tmp, SEED, gen)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "zero_phases", "launches": launches,
          "kernel_max_abs_err": worst})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0



# ------------------------------------------------------------------ phase 26

# (b): cli.train (2 unfrozen SGD CTC steps; validate_on = 1, so each run
# writes two checkpoints of about 0.38 GB) and cli.pretrain (1 SGD step,
# no checkpoint) at full wav2vec2-base width and depth, every dropout 0.1,
# no warmup: the learning rate of step 0 is not 0, so every step moves
# every parameter the gradient reaches
TP_RANKS = 2
TP_CLI_FLAGS = ["--target_tokens_per_batch", "700000", "--grad_accum", "1",
                "--train_steps", "2", "--unfreeze_enc_after_step", "-1",
                "--warmup_steps", "0", "--valid_steps", "1", "--optim",
                "sgd"]
TP_PRETRAIN_FLAGS = ["--tokens_per_batch", "1400000", "--max_sample_len",
                     "325000", "--train_steps", "1",
                     "--steps_per_checkpoint", "3", "--warmup_steps", "0",
                     "--num_train_workers", "1", "--optim", "sgd"]
TP_MODES = (("tp", []), ("tp_sp", ["--sequence_parallel", "true"]))
# the kernels each run must launch (SGD: no kernel 5; pretraining trains
# the extractor, so its conv backward runs)
TP_PATH = {"train": DP_PATH,
           "pretrain": tuple(k for k in PRETRAIN_PATH if k != "adamw")}
# 2 model ranks against one process: the loss and norm gates of phase 23;
# each parameter after SGD within TP_UPDATE_RTOL of its leaf's largest
# update |p_after - p_before| (one process's), plus a float32 rounding of
# the parameter per step (the sum order of the split products and of the
# norm differs; a gradient that misses a rank's share is off by about the
# update itself)
TP_UPDATE_RTOL = 1e-3
# an attention key bias shifts all of a query's logits by one constant:
# its true gradient is 0 and its computed one rounding noise (updates of
# 1e-14 on the card), so it is held to this bound instead, far below any
# update a gradient makes
TP_KEY_BIAS_ATOL = 1e-9
TP_T0 = 375  # rank 1's first frame of a 749-frame stream split over 2


def tp_run(kind: str, argv: list, basedir: str) -> dict:
    """One trainer run (``kind`` train or pretrain) in this process: its
    log, launches, every update's global gradient norm, the rank's own
    parameter bytes, the checksum of its replicated parameters and a
    sample of the whole parameters before the first step and after the
    last."""
    from audio8_tpu_torch.cli import pretrain
    from audio8_tpu_torch.cli import train as train_cli
    from audio8_tpu_torch.parallel import full_state
    from audio8_tpu_torch.parallel.sharding import checksum
    from audio8_tpu_torch.train.optim import TrainState

    module = train_cli if kind == "train" else pretrain
    before, norms = {}, []
    real_shard, real_apply = module.shard_state, TrainState.apply_gradients

    def shard_state(state, *args, **kwargs):  # the whole state, restored
        before.update(dp_sample(state.model))
        return real_shard(state, *args, **kwargs)

    def apply_gradients(self, *args, **kwargs):
        norm = real_apply(self, *args, **kwargs)
        norms.append(float(norm))
        return norm

    module.shard_state, TrainState.apply_gradients = \
        shard_state, apply_gradients
    reset_launches()
    try:
        state = module.train(argv + ["--basedir", basedir])
    finally:
        module.shard_state, TrainState.apply_gradients = \
            real_shard, real_apply
    launches = read_launches()
    shards = state.tensor_shards
    split = set() if shards is None else {id(p) for p, _ in shards.split}
    rep = torch.nn.ParameterList([p for p in state.model.parameters()
                                  if id(p) not in split])
    names = [] if shards is None else [shards.names[id(p)]
                                       for p, _ in shards.split]
    out = {"log": state.log, "launches": launches, "grad_norms": norms,
           "before": before, "split_names": names,
           "param_bytes": 4 * sum(p.numel() for p in state.params),
           "split_bytes": 4 * sum(p.numel() for p in state.params
                                  if id(p) in split),
           "replicated_checksum": checksum(rep)}
    with full_state(state):
        out["sample"] = dp_sample(state.model)
    del state
    torch.cuda.empty_cache()
    return out


def tp_allreduce_ms(mg) -> dict:
    """The gloo all-reduce of one (4, 749, 768) f32 activation over the
    model group (CUDA tensors staged through the host on one card), the
    region's four per layer (two forward, two backward)."""
    from audio8_tpu_torch.parallel.sharding import all_reduce_sum

    x = torch.randn(DROPOUT_SHAPE, device="cuda")
    all_reduce_sum(x, mg.group)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_sum(x, mg.group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"allreduce_ms": times, "bytes": x.numel() * 4,
            "per_layer_ms": 4 * min(times)}


def _tp_rank(rank: int, world: int, port: int, out_dir: str,
             argv: dict) -> None:
    """One gloo rank of phase 26 (b), sharing the one card: the process
    group through ``parallel/sharding.py:setup`` with the gloo backend,
    then each trainer under ``--distributed true --tensor_parallel 2``,
    sequence parallelism off and on (the entry points lay the model
    group out themselves)."""
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from audio8_tpu_torch.parallel.sharding import setup
    from audio8_tpu_torch.parallel.tensor import current_model_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dp_env(rank, world, 0, port)
    setup(True, "cuda:0", backend="gloo")
    out = {}
    for kind in ("train", "pretrain"):
        for mode, extra in TP_MODES:
            out[f"{kind}_{mode}"] = tp_run(
                kind, argv[kind] + ["--distributed", "true",
                                    "--tensor_parallel", str(world),
                                    *extra],
                os.path.join(out_dir, f"{kind}_{mode}"))
    out["collectives"] = tp_allreduce_ms(current_model_group())
    torch.save(out, os.path.join(out_dir, f"tp_rank{rank}.pt"))
    dist.destroy_process_group()


def tp_kernels(gen) -> dict:
    """Kernels 4, 2, 2b, 6 and 6b at a tensor- or sequence-parallel
    rank's place in a larger tensor, on the card, float32 and bfloat16:
    the dropout of rank 1's frames (from ``TP_T0``) of a (2, 749, 768)
    stream (rows from 2) with the strided index, bitwise its plain
    version and the slice of the whole stream's draw, forward and
    backward; the core on heads 6..11 of 12 of (2, 12, 749, 64) rows from
    2, both semantics, against its plain version and the matching heads
    of the whole call, forward and gradients; the block's forward and
    gradients on heads 6..11 of (2, 222, 768) against its plain version,
    and both halves' outputs and dx summed against the whole block's.
    Returns the max errors."""
    from audio8_tpu_torch.ops.attention import (attention_core,
                                                attention_core_bwd_plain,
                                                attention_core_plain)
    from audio8_tpu_torch.ops.attention_block import (
        attention_block, attention_block_bwd_plain, attention_block_plain)
    from audio8_tpu_torch.ops.dropout import fused_dropout, hash_dropout
    from audio8_tpu_torch.ops.hashrand import strided_index

    worst = {"dropout": 0.0, "attention_fwd": 0.0, "attention_bwd": 0.0,
             "attention_block": 0.0, "attention_block_bwd": 0.0}
    b, t, d = 2, DROPOUT_SHAPE[1], DROPOUT_SHAPE[2]
    n_real = t - TP_T0
    for dtype in (torch.float32, torch.bfloat16):
        x, dy = (torch.randn((b, t, d), device="cuda", generator=gen)
                 .to(dtype) for _ in range(2))
        whole = fused_dropout(x, 0.1, DROPOUT_SEED, 2 * t * d)
        piece = x[:, TP_T0:].contiguous().requires_grad_()
        index = strided_index(piece.shape, (4, t, d), (2, TP_T0, 0))
        y = fused_dropout(piece, 0.1, DROPOUT_SEED, *index)
        (dx,) = torch.autograd.grad(y, piece, dy[:, TP_T0:].contiguous())
        torch.cuda.synchronize()
        err = max(max_err(y, whole[:, TP_T0:])[0],
                  max_err(y, hash_dropout(piece.detach(), 0.1, DROPOUT_SEED,
                                          *index))[0],
                  max_err(dx, hash_dropout(dy[:, TP_T0:].contiguous(), 0.1,
                                           DROPOUT_SEED, *index))[0])
        emit({"phase": "tp_kernel", "kernel": "dropout", "dtype": str(dtype),
              "shape": [b, n_real, d], "t0": TP_T0, "index": list(index),
              "max_abs_err": err, "tol": 0.0})
        check(err == 0.0, f"tp dropout t0 {TP_T0} {dtype}: {err}")
        worst["dropout"] = max(worst["dropout"], err)
    h, t, dh, h0 = 12, 749, 64, 6
    kv = torch.arange(t, device="cuda")[None, :] < torch.tensor(
        [612, 0], device="cuda")[:, None]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn((b, h, t, dh), device="cuda",
                                   generator=gen).to(dtype)
                       for _ in range(4))
        mine = [a[:, h0:].contiguous() for a in (q, k, v, do)]
        for xla in (True, False):
            args = (kv, dh ** -0.5, 0.1, 4_000_000_000)
            full = [a.detach().requires_grad_() for a in (q, k, v)]
            o_full = attention_core(*full, *args, xla=xla, b0=2)
            g_full = torch.autograd.grad(o_full, full, do)
            part = [a.detach().requires_grad_() for a in mine[:3]]
            o = attention_core(*part, *args, xla=xla, b0=2, h0=h0, heads=h)
            grads = torch.autograd.grad(o, part, mine[3])
            torch.cuda.synchronize()
            want = attention_core_plain(*mine[:3], *args, xla=xla, b0=2,
                                        h0=h0, heads=h)
            err, scale = max_err(o, want)
            tol = TOL[dtype] * max(1.0, scale)
            e_full, _ = max_err(o, o_full[:, h0:])
            check(err <= tol and e_full <= tol,
                  f"tp attention_fwd h0 {h0} xla {xla} {dtype}: {err}, "
                  f"{e_full} vs the whole call > {tol}")
            gerr = 0.0
            for g, w, gf in zip(grads, attention_core_bwd_plain(
                    *mine[:3], *args, mine[3], xla=xla, b0=2, h0=h0,
                    heads=h), g_full):
                e, s = max_err(g, w)
                ef, _ = max_err(g, gf[:, h0:])
                check(max(e, ef) <= TOL[dtype] * max(1.0, s),
                      f"tp attention_bwd h0 {h0} xla {xla} {dtype}: {e}, "
                      f"{ef} vs the whole call")
                gerr = max(gerr, e, ef)
            worst["attention_fwd"] = max(worst["attention_fwd"], err, e_full)
            worst["attention_bwd"] = max(worst["attention_bwd"], gerr)
            emit({"phase": "tp_kernel", "kernel": "attention_core",
                  "dtype": str(dtype), "shape": [b, h - h0, t, dh],
                  "h0": h0, "heads": h, "b0": 2, "xla": xla, "rate": 0.1,
                  "max_abs_err": {"fwd": err, "bwd": gerr},
                  "vs_whole_call": {"fwd": e_full}})
    bt, hd = 222, BLOCK_HEADS // 2
    kvb = torch.arange(bt, device="cuda")[None, :] < torch.tensor(
        [200, 0], device="cuda")[:, None]
    for dtype in (torch.float32, torch.bfloat16):
        x, weights = block_inputs(b, bt, d, dtype, gen)
        dy = torch.randn(b, bt, d, device="cuda", generator=gen).to(dtype)
        wq, bq, wk, bk, wv, bv, wo, bo = weights
        scale = (d // BLOCK_HEADS) ** -0.5
        args = (kvb, BLOCK_HEADS, scale, 0.1, 3_000_000_019, 2)
        xf = x.detach().requires_grad_()
        out_full = attention_block(xf, *weights, *args)
        (dx_full,) = torch.autograd.grad(out_full, xf, dy)
        outs, dxs, fwd_err, bwd_err = [], [], 0.0, 0.0
        for r in range(2):
            rows = slice(r * hd * 64, (r + 1) * hd * 64)
            mine = [wq[rows], bq[rows], wk[rows], bk[rows], wv[rows],
                    bv[rows], wo[:, rows], torch.zeros_like(bo)]
            mine = [a.contiguous() for a in mine]
            local = (kvb, hd, scale, 0.1, 3_000_000_019, 2, r * hd,
                     BLOCK_HEADS)
            xs = [a.detach().requires_grad_() for a in (x, *mine)]
            out = attention_block(*xs, *local)
            got = torch.autograd.grad(out, xs, dy)
            torch.cuda.synchronize()
            e, s = max_err(out, attention_block_plain(x, *mine, *local))
            check(e <= TOL[dtype] * max(1.0, s),
                  f"tp attention_block h0 {r * hd} {dtype}: {e}")
            fwd_err = max(fwd_err, e)
            want = attention_block_bwd_plain(x, *mine, kvb, hd, scale, 0.1,
                                             3_000_000_019, dy, b0=2,
                                             h0=r * hd, heads=BLOCK_HEADS)
            for i, (g, w) in enumerate(zip(got, want)):
                if i == 8:  # the zero bias of the partial O projection
                    continue
                e, s = max_err(g, w)
                check(e <= TOL[dtype] * max(1.0, s),
                      f"tp attention_block_bwd h0 {r * hd} {dtype} "
                      f"gradient {i}: {e}")
                bwd_err = max(bwd_err, e)
            outs.append(out.float())
            dxs.append(got[0].float())
        e_sum, s = max_err(outs[0] + outs[1] + bo.float(), out_full.float())
        e_dx, s_dx = max_err(dxs[0] + dxs[1], dx_full.float())
        tol = 4 * TOL[dtype]
        check(e_sum <= tol * max(1.0, s) and e_dx <= tol * max(1.0, s_dx),
              f"tp attention_block halves vs the whole block {dtype}: "
              f"{e_sum}, dx {e_dx}")
        worst["attention_block"] = max(worst["attention_block"], fwd_err)
        worst["attention_block_bwd"] = max(worst["attention_block_bwd"],
                                           bwd_err)
        emit({"phase": "tp_kernel", "kernel": "attention_block",
              "dtype": str(dtype), "shape": [b, bt, d], "heads": [hd,
                                                                  BLOCK_HEADS],
              "max_abs_err": {"fwd": fwd_err, "bwd": bwd_err},
              "halves_vs_whole": {"out": e_sum, "dx": e_dx}})
    return worst


def tp_close(mine: dict, one: dict, before: dict, steps: int,
             split: list, name: str) -> dict:
    """The sampled whole parameters against one process's, each within
    ``TP_UPDATE_RTOL`` times its leaf's largest update (``one - before``)
    plus ``steps`` float32 roundings of ``|one|`` (the key biases within
    ``TP_KEY_BIAS_ATOL``); the leaves in ``split`` (the ones the model
    group splits) moved as a whole (a leaf whose every sampled update
    rounds away is held within its roundings, and listed). Every failing
    leaf is named. Returns the largest difference, the largest difference
    over its leaf's largest update, the key biases' largest difference,
    the largest update of a split leaf and the split leaves that did not
    move."""
    worst, worst_rel, key_bias, most = 0.0, 0.0, 0.0, 0.0
    eps = float(torch.finfo(torch.float32).eps)
    failed, still = [], []
    for k, v in mine.items():
        d = (v - one[k]).abs()
        u = float((one[k] - before[k]).abs().max())
        if k.endswith("k_proj.bias"):
            key_bias = max(key_bias, float(d.max()))
            bad = d > TP_KEY_BIAS_ATOL
        else:
            worst = max(worst, float(d.max()))
            if u > 0.0:
                worst_rel = max(worst_rel, float(d.max()) / u)
            bad = d > TP_UPDATE_RTOL * u + steps * eps * one[k].abs()
            if k in split:
                most = max(most, u)
                if u == 0.0:
                    still.append(k)
        if bool(bad.any()):
            failed.append(f"{k}: {float(d.max())} against an update of {u}")
    check(not failed, f"tp {name}: {failed}")
    check(most > 0.0, f"tp {name}: no split leaf moved")
    return {"param_max_abs_err": worst, "param_err_over_update": worst_rel,
            "key_bias_max_abs_err": key_bias,
            "largest_split_leaf_update": most, "unmoved_split_leaves": still}


def phase_tp(tmp: str, seed: int, gen) -> tuple:
    """Phase 26: tensor and sequence parallelism (module docstring).
    Returns the launches of (b)'s rank 0 and the kernels' max errors."""
    import torch.multiprocessing as mp

    from audio8_tpu_torch.models.convert import load_fairseq_ctc

    start = time.perf_counter()
    with timed("tp_kernel"):
        worst = tp_kernels(gen)
    corpus = os.path.join(tmp, "tp_corpus")
    os.makedirs(corpus)
    write_corpus(corpus, seed + 120)
    pcorpus = os.path.join(tmp, "tp_pretrain_corpus")
    os.makedirs(pcorpus)
    write_pretrain_corpus(pcorpus, seed + 121)
    argv = {"train": ["--root_dir", corpus, "--train_dataset", "train.tsv",
                      "--valid_dataset", "valid.tsv", "--device", "cuda",
                      *TP_CLI_FLAGS],
            "pretrain": ["--manifest_dir", pcorpus, "--device", "cuda",
                         *TP_PRETRAIN_FLAGS]}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with timed("tp_one"):
            one = {kind: tp_run(kind, argv[kind],
                                os.path.join(tmp, f"tp_{kind}_one"))
                   for kind in ("train", "pretrain")}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out_dir = os.path.join(tmp, "tp_ranks")
    os.makedirs(out_dir)
    with timed("tp_ranks"):
        mp.start_processes(_tp_rank, args=(TP_RANKS, free_port(), out_dir,
                                           argv),
                           nprocs=TP_RANKS, start_method="spawn", join=True)
        ranks = [torch.load(os.path.join(out_dir, f"tp_rank{r}.pt"))
                 for r in range(TP_RANKS)]
    results = {}
    for kind in ("train", "pretrain"):
        for mode, _ in TP_MODES:
            name = f"{kind}_{mode}"
            r0 = ranks[0][name]
            for r in ranks[1:]:
                check(r[name]["replicated_checksum"]
                      == r0["replicated_checksum"],
                      f"tp {name}: the ranks' replicated parameters differ")
                check(all(torch.equal(v, r0["sample"][k])
                          for k, v in r[name]["sample"].items()),
                      f"tp {name}: the ranks' whole parameters differ")
                check([x["loss"] for x in r[name]["log"]]
                      == [x["loss"] for x in r0["log"]],
                      f"tp {name}: the ranks' losses differ")
            check(all(torch.equal(v, one[kind]["before"][k])
                      for k, v in r0["before"].items()),
                  f"tp {name}: the run did not start from one process's "
                  "parameters")
            loss = [x["loss"] for x in r0["log"]]
            want = [x["loss"] for x in one[kind]["log"]]
            res = {"loss": loss, "one_process_loss": want,
                   "loss_rel_err": dp_close(loss, want, DP_LOSS_RTOL,
                                            f"tp {name} loss"),
                   "grad_norm": r0["grad_norms"],
                   "one_process_grad_norm": one[kind]["grad_norms"],
                   "gnorm_rel_err": dp_close(
                       r0["grad_norms"], one[kind]["grad_norms"],
                       DP_GNORM_RTOL, f"tp {name} grad norm"),
                   **tp_close(r0["sample"], one[kind]["sample"],
                              one[kind]["before"], len(loss),
                              r0["split_names"], name),
                   "rank_param_bytes": [r[name]["param_bytes"]
                                        for r in ranks],
                   "rank_split_bytes": [r[name]["split_bytes"]
                                        for r in ranks],
                   "one_process_param_bytes": one[kind]["param_bytes"],
                   "step_seconds": [x["seconds"] for x in r0["log"]],
                   "one_process_step_seconds": [x["seconds"] for x in
                                                one[kind]["log"]]}
            for k in TP_PATH[kind]:
                check(r0["launches"][k] > 0, f"tp {name}: {k} not launched")
            res["launches"] = {k: r0["launches"][k] for k in TP_PATH[kind]}
            results[name] = res
    # the TP run's last checkpoint, read in this process, is its whole
    # state
    ckpt = load_fairseq_ctc(os.path.join(out_dir, "train_tp",
                                         "checkpoint-step-2.pt"))
    ckpt_equal = all(torch.equal(ckpt[k].reshape(-1)[::DP_STRIDE].float(),
                                 v) for k, v in
                     ranks[0]["train_tp"]["sample"].items())
    check(ckpt_equal, "tp: the saved .pt is not the run's whole state")
    emit({"phase": "tp", "part": "b", "card": card_name(),
          "backend": "gloo (CUDA tensors, one card)", "world": TP_RANKS,
          "tensor_parallel": TP_RANKS, "flags": TP_CLI_FLAGS,
          "pretrain_flags": TP_PRETRAIN_FLAGS, "runs": results,
          "checkpoint_loads_whole": ckpt_equal,
          "host_staged_allreduce": {
              "note": "gloo over CUDA tensors staged through the host, two "
                      "ranks on one card: not a scaling number",
              "ranks": [r["collectives"] for r in ranks]}})
    launches = ranks[0]["train_tp"]["launches"]
    emit({"phase": "tp", "seconds": time.perf_counter() - start,
          "bytes_written": tree_bytes(*(os.path.join(tmp, n) for n in
                                        os.listdir(tmp)
                                        if n.startswith("tp_"))),
          "launches": {k: launches.get(k, 0) for k in REPLACES},
          "kernel_max_abs_err": worst})
    return {k: launches.get(k, 0) for k in REPLACES}, worst


def tp_phases(gen) -> int:
    """The build and phase 26 alone (``--tp-phases``), then the phase
    seconds, the card and the last line."""
    with timed("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        launches, worst = phase_tp(tmp, SEED, gen)
    emit({"phase": "phase_seconds", **PHASE_SECONDS})
    emit({"phase": "tp_phases", "launches": launches,
          "kernel_max_abs_err": worst})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
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
    if argv == ["--dp-timing"]:
        return dp_timing(gen)
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
    if argv == ["--transducer-phases"]:
        return transducer_timing(gen)
    if argv == ["--ssl-phases"]:
        return ssl_phases(gen)
    if argv == ["--decode-phases"]:
        return decode_phases(gen)
    if argv == ["--moe-phases"]:
        return moe_phases(gen)
    if argv == ["--dp-phases"]:
        return dp_phases(gen)
    if argv == ["--orbax-phases"]:
        return orbax_phases()
    if argv == ["--zero-phases"]:
        return zero_phases(gen)
    if argv == ["--tp-phases"]:
        return tp_phases(gen)
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
        rnnt_launches, errs = phase_transducer(tmp, SEED, gen)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
        ssl_launches, ssl_cli_launches, errs = phase_ssl(tmp, SEED, gen)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
        lm_launches, rescore_launches, errs = phase_decode(tmp, SEED, gen)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
        torch.cuda.empty_cache()
        moe_launches, errs = phase_moe(tmp, SEED, gen)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
        torch.cuda.empty_cache()
        dp_launches, errs = phase_dp(tmp, SEED, gen)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
        torch.cuda.empty_cache()
        orbax_launches = phase_orbax(tmp, SEED)
        torch.cuda.empty_cache()
        zero_launches, errs = phase_zero(tmp, SEED, gen)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
        torch.cuda.empty_cache()
        tp_launches, errs = phase_tp(tmp, SEED, gen)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
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
         "transducer_launches": rnnt_launches.get(name, 0),
         "ssl_step_launches": ssl_launches.get(name, 0),
         "ssl_cli_launches": ssl_cli_launches.get(name, 0),
         "decode_lm_launches": lm_launches.get(name, 0),
         "decode_rescore_launches": rescore_launches.get(name, 0),
         "moe_launches": moe_launches.get(name, 0),
         "dp_launches": dp_launches.get(name, 0),
         "orbax_launches": orbax_launches.get(name, 0),
         "zero_launches": zero_launches.get(name, 0),
         "tp_launches": tp_launches.get(name, 0),
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
