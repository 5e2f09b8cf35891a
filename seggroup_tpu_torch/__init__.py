"""PyTorch / CUDA port of seggroup_tpu for one NVIDIA H100.

The JAX package `seggroup_tpu` is the reference this package is held
against; the module layout and public names follow it. This package imports
torch and numpy only. Entry points run on the card (`device="cuda"`) unless
the caller passes `device="cpu"`, which selects the plain PyTorch versions of
the hand-written kernels."""
