"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(counterpart of ``repro.kernels``). Sources are in ``repro_torch/csrc/``
and are built with ``nvcc`` at first use (``_build``)."""
