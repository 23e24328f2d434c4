"""PyTorch/CUDA port of the repro package: llama2-110m served through the
paged Engine on one NVIDIA H100, with hand-written CUDA kernels."""
