"""Complex arithmetic as explicit (re, im) float64 pairs.

Every complex quantity on device is carried as a pair of real float64
arrays.  ``Cx`` is a lightweight pytree pair
with the arithmetic the spectral solvers need.  Host-side numpy code converts
freely between ``Cx`` and numpy complex via :func:`from_np` / :func:`to_np`.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
class Cx:
    """A complex array stored as (re, im) real float64 arrays."""

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

    # -- pytree plumbing ----------------------------------------------------
    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- basic properties ----------------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.re)

    @property
    def dtype(self):
        return jnp.result_type(self.re)

    def __repr__(self):
        return f"Cx(shape={self.shape})"

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re + o.re, self.im + o.im)
        return Cx(self.re + o, self.im)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re - o.re, self.im - o.im)
        return Cx(self.re - o, self.im)

    def __rsub__(self, o):
        return Cx(o - self.re, -self.im)

    def __neg__(self):
        return Cx(-self.re, -self.im)

    def __mul__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re * o.re - self.im * o.im,
                      self.re * o.im + self.im * o.re)
        return Cx(self.re * o, self.im * o)

    __rmul__ = __mul__

    def conj(self):
        return Cx(self.re, -self.im)

    def abs2(self):
        return self.re * self.re + self.im * self.im

    def mul_i(self):
        """Multiply by the imaginary unit."""
        return Cx(-self.im, self.re)

    def reshape(self, *shape):
        return Cx(self.re.reshape(*shape), self.im.reshape(*shape))

    def ravel(self):
        return Cx(self.re.ravel(), self.im.ravel())

    def __getitem__(self, idx):
        return Cx(self.re[idx], self.im[idx])

    def transpose(self, *axes):
        return Cx(jnp.transpose(self.re, axes or None),
                  jnp.transpose(self.im, axes or None))

    @property
    def T(self):
        return Cx(self.re.T, self.im.T)


def czeros(shape, dtype=jnp.float64) -> Cx:
    return Cx(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def from_np(z: Any) -> Cx:
    """Host conversion: numpy complex (or real) array -> Cx of jnp arrays."""
    z = np.asarray(z)
    return Cx(jnp.asarray(np.real(z), jnp.float64),
              jnp.asarray(np.imag(z) if np.iscomplexobj(z) else np.zeros_like(z, dtype=np.float64), jnp.float64))


def to_np(c: Cx) -> np.ndarray:
    """Host conversion: Cx -> numpy complex128."""
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def matmul(a, b):
    """Matmul supporting Cx/real operands in any combination.

    All matmuls use HIGHEST precision so XLA keeps genuine f64 semantics.
    """
    dot = lambda x, y: jnp.matmul(x, y, precision=jax.lax.Precision.HIGHEST)
    a_cx = isinstance(a, Cx)
    b_cx = isinstance(b, Cx)
    if a_cx and b_cx:
        return Cx(dot(a.re, b.re) - dot(a.im, b.im),
                  dot(a.re, b.im) + dot(a.im, b.re))
    if a_cx:
        return Cx(dot(a.re, b), dot(a.im, b))
    if b_cx:
        return Cx(dot(a, b.re), dot(a, b.im))
    return dot(a, b)
