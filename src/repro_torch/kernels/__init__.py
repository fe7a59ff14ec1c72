"""Hand-written CUDA kernels of the port, their plain PyTorch versions,
and the dispatch between them (twin of ``src/repro/kernels``)."""
