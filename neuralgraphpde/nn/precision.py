"""Mixed-precision policy as a layer transform (bf16 compute).

The recipe is f32 *master* parameters with bf16 *compute*: the GPU's
tensor cores multiply bf16 operands at twice the TF32 rate, and bf16 halves
every byte the activations move through device memory. JAX's idiom for this
is a function transform, not a module rewrite — so ``Precision`` wraps any
explicit layer (``y, st = layer(x, ps, st)``) and, at call time, casts the
floating-point leaves of ``x`` and ``ps`` to ``compute_dtype``, runs the
wrapped layer unmodified, and casts the output back to ``output_dtype``.

Because the cast is ``convert_element_type`` (whose VJP casts the cotangent
back), gradients arrive in the *master* dtype — the standard mixed-precision
loss-scaling-free bf16 setup (bf16 keeps f32's exponent range, so no scaling
is needed, unlike fp16).

The reference has no dtype policy (Julia/Lux trains f32 throughout); this is
an addition. Composes with the graph-in-state machinery: ``update_graph``
recurses into the nested state.

Precision of float32 itself: on this GPU, default-precision f32 products run
in TF32 (10-bit mantissa). A true-f32 reference therefore runs under
``jax.default_matmul_precision("highest")``. Whether ``bf16(model)`` pays
on a given model has not been measured on the GPU yet; on narrow widths
(the VMH tutorial's 60/40) the halved bytes are small next to the per-call
casts.

Usage::

    model = bf16(vmh_model(...))       # or Precision(layer, ...)
    ps, st = setup(key, model)         # ps stays f32 (master copy)
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .core import ContainerLayer, Layer


def _cast_floats(tree, dtype):
    def leaf(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree_util.tree_map(leaf, tree)


@dataclasses.dataclass(frozen=True, eq=False)
class Precision(ContainerLayer):
    """Run ``layer`` in ``compute_dtype``; keep params and outputs in the
    master/output dtypes. See module docstring."""

    layer: Layer
    compute_dtype: jnp.dtype = jnp.bfloat16
    output_dtype: jnp.dtype = jnp.float32

    layer_names = ("layer",)

    def __call__(self, x, ps, st):
        x_c = _cast_floats(x, self.compute_dtype)
        ps_c = _cast_floats(self.child_params("layer", ps),
                            self.compute_dtype)
        y, st_l = self.layer(x_c, ps_c, st["layer"])
        return _cast_floats(y, self.output_dtype), {"layer": st_l}


def bf16(layer: Layer) -> Precision:
    """f32 master params, bf16 compute, f32 outputs."""
    return Precision(layer)
