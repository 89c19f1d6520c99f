"""Matrix product with float32 accumulation."""

from __future__ import annotations


def dot32(a, b):
    """``a @ b`` accumulated and returned in float32: the counterpart of
    JAX's ``preferred_element_type=float32``. Inputs already rounded to a
    low-precision dtype keep that rounding; their products are exact in
    float32."""
    return a.float() @ b.float()
