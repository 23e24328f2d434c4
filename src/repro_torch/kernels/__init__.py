"""The port's CUDA kernels (csrc/), their build, wrappers and plain
versions."""
