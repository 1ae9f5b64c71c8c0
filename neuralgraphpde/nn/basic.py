"""Basic explicit layers: Dense, Chain, MLP, activation resolution.

Equivalents of the Lux building blocks the reference composes with
(``Lux.Dense``/``Chain``, reference src/layers.jl:490, tutorials' MLPs,
docs/src/tutorials/VMH.md:75-80). Row-major convention: inputs are
``(batch/nodes/edges, features)``; weights are stored ``(in, out)`` so the
forward is a single ``x @ W`` matmul.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple, Union

import jax
import jax.numpy as jnp

from .core import ContainerLayer, Layer

# ------------------------------------------------------------- initializers
def glorot_uniform(rng, shape, dtype=jnp.float32):
    fan_in, fan_out = shape[0], shape[1]
    limit = jnp.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(rng, shape, dtype, -limit, limit)


def glorot_normal(rng, shape, dtype=jnp.float32):
    fan_in, fan_out = shape[0], shape[1]
    std = jnp.sqrt(2.0 / (fan_in + fan_out))
    return std * jax.random.normal(rng, shape, dtype)


def zeros_init(rng, shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


def ones_init(rng, shape, dtype=jnp.float32):
    return jnp.ones(shape, dtype)


_ACTIVATIONS = {
    "identity": lambda x: x,
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "gelu": jax.nn.gelu,
    "swish": jax.nn.swish,
    "silu": jax.nn.silu,
    "softplus": jax.nn.softplus,
    "elu": jax.nn.elu,
    "leaky_relu": jax.nn.leaky_relu,
}


def resolve_activation(act: Union[None, str, Callable]) -> Callable:
    if act is None:
        return _ACTIVATIONS["identity"]
    if callable(act):
        return act
    return _ACTIVATIONS[act]


@dataclasses.dataclass(frozen=True, eq=False)
class Dense(Layer):
    """``y = act(x @ W + b)`` with explicit params (Lux ``Dense`` analog)."""

    in_dims: int
    out_dims: int
    activation: Union[None, str, Callable] = None
    use_bias: bool = True
    init_weight: Callable = glorot_uniform
    init_bias: Callable = zeros_init

    def initialparameters(self, rng):
        wk, bk = jax.random.split(rng)
        ps = {"weight": self.init_weight(wk, (self.in_dims, self.out_dims))}
        if self.use_bias:
            ps["bias"] = self.init_bias(bk, (1, self.out_dims))
        return ps

    def parameterlength(self):
        return self.out_dims * (self.in_dims + (1 if self.use_bias else 0))

    def __call__(self, x, ps, st):
        y = jnp.dot(x, ps["weight"], preferred_element_type=x.dtype)
        if self.use_bias:
            y = y + ps["bias"]
        return resolve_activation(self.activation)(y), st


@dataclasses.dataclass(frozen=True, eq=False)
class Chain(ContainerLayer):
    """Sequential container; children named ``layer_1..layer_N`` to match the
    Lux naming the reference tests rely on (test/runtests.jl:184)."""

    layers: Tuple[Layer, ...]

    def __post_init__(self):
        names = tuple(f"layer_{i + 1}" for i in range(len(self.layers)))
        object.__setattr__(self, "layer_names", names)

    def _children(self):
        return {f"layer_{i + 1}": l for i, l in enumerate(self.layers)}

    def initialparameters(self, rng):
        # Chains never flatten single children (Lux keeps names in Chain).
        children = self._children()
        keys = jax.random.split(rng, max(len(children), 1))
        return {name: child.initialparameters(k)
                for (name, child), k in zip(children.items(), keys)}

    def __call__(self, x, ps, st):
        new_st = dict(st)
        for i, layer in enumerate(self.layers):
            name = f"layer_{i + 1}"
            x, sub_st = layer(x, ps[name], st[name])
            new_st[name] = sub_st
        return x, new_st


def chain(*layers: Layer) -> Chain:
    return Chain(tuple(layers))


@dataclasses.dataclass(frozen=True, eq=False)
class MLP(ContainerLayer):
    """Multilayer perceptron: Dense stack with one hidden activation
    (the tutorials' ϕ/γ nets, reference docs/src/tutorials/VMH.md:75-80)."""

    dims: Tuple[int, ...]  # (in, hidden..., out)
    activation: Union[str, Callable] = "tanh"
    final_activation: Union[None, str, Callable] = None
    use_bias: bool = True

    def __post_init__(self):
        layers = []
        n = len(self.dims) - 1
        for i in range(n):
            act = self.activation if i < n - 1 else self.final_activation
            layers.append(Dense(self.dims[i], self.dims[i + 1], act,
                                use_bias=self.use_bias))
        object.__setattr__(self, "_chain", Chain(tuple(layers)))

    def initialparameters(self, rng):
        return self._chain.initialparameters(rng)

    def initialstates(self, rng):
        return self._chain.initialstates(rng)

    def __call__(self, x, ps, st):
        return self._chain(x, ps, st)


@dataclasses.dataclass(frozen=True, eq=False)
class WrappedFunction(Layer):
    """Stateless, parameterless function as a layer (Lux ``WrappedFunction``;
    the tutorial's ``diffeqsol_to_array`` slot, docs/src/tutorials/
    graph_node.md:81)."""

    fn: Callable

    def __call__(self, x, ps, st):
        return self.fn(x), st
