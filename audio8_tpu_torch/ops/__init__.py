"""Ops of the PyTorch port: the hand-written CUDA kernels' wrappers
(``conv``, ``attention``) and host-side decoding helpers."""
