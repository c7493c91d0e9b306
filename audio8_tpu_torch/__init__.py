"""audio8-tpu on PyTorch and CUDA: the port of ``audio8_tpu`` to an NVIDIA
H100.

The package imports ``torch`` and never ``jax``, ``flax`` or anything of
``audio8_tpu``: the host code it needs from the JAX package is copied
here (``config``, ``utils``, ``data/audio``, ``serve``), with the same
names and defaults.

Module layout mirrors ``audio8_tpu``: ``nn/`` (layers, transformer,
dropout), ``models/`` (wav2vec2, checkpoint conversion, vocab), ``ops/``
(the hand-written CUDA kernels' wrappers, hash randomness, masks, CTC,
metrics, beam search, the ARPA LM), ``train/`` (optimizer, step
factories, checkpoints and resume files, preemption), ``data/`` (audio,
datasets), ``serve.py`` and ``cli/`` (``transcribe``, ``serve``,
``train``, ``pretrain``, ``test``, ``convert_checkpoint``). Kernel
sources are in ``csrc/``, beside the C++ host library (edit distance,
beam search, LM readers, FLAC) and its ctypes bindings
(``csrc/native.py``).
"""
