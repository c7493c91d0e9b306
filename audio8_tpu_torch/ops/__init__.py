"""Ops of the PyTorch port: the hand-written CUDA kernels' wrappers
(``conv``, ``attention``, ...) and host-side decoding: metrics, the
prefix beam search (``beam``) and the ARPA LM (``lm``)."""
