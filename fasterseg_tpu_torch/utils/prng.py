"""The JAX package's random draws, in numpy: threefry-2x32 keys, `fold_in`,
`normal`, and flax's key for a parameter.

With these the port's training init draws the same initial weights as the
JAX package's `create_derived(plan, PRNGKey(seed))`: most values bit for
bit, the rest within a few ulps (XLA's log1p and fused multiply-adds round
a few apart; tests/test_torch_init_draw.py). A curve the port trains then
sets beside the JAX package's with the initial draw taken out of the
difference. They follow JAX's default threefry implementation with
partitionable bits (`jax_threefry_partitionable`, the default since JAX
0.5) and flax's `LazyRng` fold of a module path (flax/core/scope.py
`_fold_in_static`).
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Tuple, Union

import numpy as np

Key = np.ndarray                      # uint32[2]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's single-precision erfinv (Giles' polynomials, xla/client/lib/math.cc)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds on the counter words (x0, x1)."""
    k0, k1 = np.asarray(key, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` for a seed below 2**32."""
    return np.array([0, seed], np.uint32)


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)`."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return np.concatenate([y0, y1])


def flax_param_key(root: Key, path: Iterable[str], counter: int = 1) -> Key:
    """The key flax hands the `counter`-th parameter made in the module at
    `path` (its scope names from the root) under `init(root, ...)`: one
    fold of the SHA-1 of the names and the counter."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def _erfinv_f32(u: np.ndarray) -> np.ndarray:
    # each step rounds once to float32, as XLA's fused multiply-adds do
    f32 = lambda a: np.asarray(a, np.float64).astype(np.float32)
    w = f32(-np.log1p(-np.float64(1) * (u * u)))
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(np.maximum(w, np.float32(0))) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(a), np.float32(b))
        p = f32(c.astype(np.float64) + p.astype(np.float64) * w)
    return p * u


def normal(key: Key, shape: Union[int, Tuple[int, ...]]) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`: uniform bits on
    (nextafter(-1, 0), 1) through sqrt(2) * erfinv."""
    n = int(np.prod(shape))
    if n >= 2 ** 32:
        raise ValueError("a draw of 2**32 values or more")
    y0, y1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    bits = (y0 ^ y1) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * np.float32(2.0) + lo)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).reshape(shape)


def kaiming_normal(key: Key, hwio: Tuple[int, ...]) -> np.ndarray:
    """The JAX package's conv init (ops/conv.py `KAIMING`, flax
    `variance_scaling(2, "fan_in", "normal")`) of an HWIO kernel."""
    fan_in = int(np.prod(hwio[:-1]))
    std = np.sqrt(np.float32(2.0 / fan_in))
    return normal(key, hwio) * std
