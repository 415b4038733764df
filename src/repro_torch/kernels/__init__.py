"""Hand-written CUDA kernels of the round and their plain versions."""
