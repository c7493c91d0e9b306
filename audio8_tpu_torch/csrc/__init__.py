"""CUDA C++ sources of the port's kernels and their ``nvcc`` build."""
