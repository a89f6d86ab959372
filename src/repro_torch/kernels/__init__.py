"""The port's kernels: ten hand-written CUDA kernels for Hopper
(``csrc/``), each beside its plain PyTorch version, and their dispatch
(``ops``)."""
