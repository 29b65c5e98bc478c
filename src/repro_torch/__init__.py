"""PyTorch/CUDA port of the P²M system (`repro`), built for one NVIDIA H100.

The JAX package `repro` is the reference; this package mirrors its module
layout and public functions.  It imports `torch` and never `jax`, and
nothing of `repro`: what it needs from a JAX-free module of the reference
is kept here as its own copy.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).  Every kernel the reference wrote in Pallas is a
kernel written by hand for Hopper, beside a plain PyTorch version of the
same function that runs only for tensors on the CPU.
"""
