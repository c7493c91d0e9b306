"""Ops of the PyTorch port: the hand-written CUDA kernels' wrappers
(``conv``, ``attention``, ...) and host-side decoding: metrics, the
prefix beam search (``beam``) and the ARPA LM (``lm``).

Importing the package registers every kernel as a ``torch.library``
custom op in the ``a8t`` namespace (``a8t::conv_k3s2``,
``a8t::attention_core``, ...), which a loaded ``torch.export`` artifact
needs and nothing else of the port."""
from audio8_tpu_torch.ops import (adamw, attention, attention_block,  # noqa
                                  conv, ctc, dropout)
