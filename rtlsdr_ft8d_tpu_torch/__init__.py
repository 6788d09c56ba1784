"""PyTorch + CUDA port of the single-window FT8 decode path.

Mirrors the layout of `rtlsdr_ft8d_tpu` (ops/, pipeline.py, host/) and
reuses its JAX-free modules (protocol/, host/{io,synth,reporter,log},
native/) by import. Every Pallas kernel on the decode path has a CUDA C++
counterpart in csrc/, built with nvcc at first use (ops/build.py).
"""
