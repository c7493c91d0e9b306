"""audio8-tpu on PyTorch and CUDA: the port of ``audio8_tpu`` to an NVIDIA
H100.

The package imports ``torch`` and never ``jax`` or ``flax``. Host code of
the JAX package that is already jax-free is shared by import, not copied:
``audio8_tpu.config`` (model configs and conv geometry),
``audio8_tpu.utils`` (special-token registry, helpers),
``audio8_tpu.data.audio`` (audio file decoding) and ``audio8_tpu.serve``
(chunk geometry and batching, subclassed in ``serve.py``).

Module layout mirrors ``audio8_tpu``: ``nn/`` (layers, transformer),
``models/`` (wav2vec2, checkpoint conversion, vocab), ``ops/`` (the
hand-written CUDA kernels' wrappers and decoding helpers), ``serve.py``
and ``cli/`` (``transcribe``, ``serve``). Kernel sources are in ``csrc/``.
"""
