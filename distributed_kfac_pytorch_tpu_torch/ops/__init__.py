"""Factor statistics, linear algebra and the CUDA kernels of the port."""
