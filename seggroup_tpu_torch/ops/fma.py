"""float32 dot products in the order XLA's CPU backend computes them.

Compiled under jit, as the JAX package runs them, XLA on the CPU contracts a
length-3 `jnp.sum(a*b, -1)` and a float32 dot over 3 columns into a chain of
fused multiply-adds,
fma(a2,b2, fma(a1,b1, a0*b0)), which plain float32 `a0*b0+a1*b1+a2*b2`
matches in only about four fifths of the values. The JAX reference takes its
FPS picks, kNN neighbours and spatial-fallback argmins from such values, so
the port computes them in the same order. Each fused multiply-add is
emulated as one float64 multiply-add rounded to float32 (the float32 product
is exact in float64); the result is the same on the CPU and on the card."""

from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c), emulated in float64."""
    return (a.double() * b.double() + c.double()).float()


def dot_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis of broadcastable float32 tensors as
    the fused chain fma(a_{D-1}, b_{D-1}, ... fma(a1, b1, a0*b0))."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = fma32(a[..., i], b[..., i], acc)
    return acc
