"""The JAX package's random streams: threefry2x32 keys, ``split``,
``uniform`` and ``gumbel``, with the bits of ``jax.random`` (jax 0.9.0,
``jax_threefry_partitionable=True``).

A key is a ``(..., 2)`` int64 tensor holding two uint32 words, the words
of ``jax.random.PRNGKey``.  Every function takes a leading batch of keys
and draws for each key what ``jax.vmap`` of the jax function draws, so a
whole plan's stream is one pass of elementwise tensor ops.  The uint32
arithmetic runs in int64, masked to 32 bits wherever the next op needs
the word: every intermediate stays below 2**61, so ``>>`` on int64 is a
logical shift here.  The same code runs on the CPU and on CUDA and gives the same
bits on both; it calls no library RNG.

Reference: ``jax/_src/prng.py`` (``_threefry2x32_lowering``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``)
and ``jax/_src/random.py`` (``_uniform``, ``_gumbel``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000  # float32 1.0
F32_TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 off: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) % (1 << 32)], dtype=torch.int64, device=device)


def as_key(x, device="cpu") -> torch.Tensor:
    """A key tensor (..., 2) of uint32 words from a key tensor, a numpy
    array (e.g. ``np.asarray`` of a jax key) or a sequence of words."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype.kind not in "ui":
            raise ValueError(f"key words must be integers, got {x.dtype}")
        x = torch.from_numpy(x.astype(np.int64))
    k = x.to(device=device, dtype=torch.int64)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key is (..., 2) uint32 words, got shape {tuple(k.shape)}")
    if bool(((k < 0) | (k > MASK32)).any()):
        raise ValueError("key words must lie in [0, 2**32)")
    return k


def key_data(k: torch.Tensor) -> np.ndarray:
    """The key's words as a numpy uint32 array (..., 2), as
    ``np.asarray(jax_key)`` gives them."""
    return k.detach().cpu().numpy().astype(np.uint32)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counter pair (x0, x1) under the key
    (k1, k2): 20 rounds of ``x0 += x1; x1 = rotl(x1, r) ^ x0``, the key
    injected after every 4 with ``+ i + 1`` on the second word.  Arguments
    broadcast; all hold uint32 words in int64.

    Only the low 32 bits of x0 ever reach x1, so x0 is masked once, at the
    end (25 additions of words keep it below 2**37); x1 is masked after
    each round, which ``rotl`` (below 2**61 before the mask) needs: six
    elementwise ops a round."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & MASK32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0 & MASK32, x1


def _counts(shape: Sequence[int], batch_dims: int, device):
    """The (hi, lo) words of the flat index over ``shape``, with
    ``batch_dims`` leading singleton axes for the keys to broadcast over."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(
        (1,) * batch_dims + tuple(shape))
    return idx >> 32, idx & MASK32


def _hash(keys: torch.Tensor, shape: Sequence[int]):
    """(bits1, bits2), each (..., *shape): every key of the batch hashes
    the flat index of ``shape``."""
    shape = tuple(int(d) for d in shape)
    batch = keys.dim() - 1
    hi, lo = _counts(shape, batch, keys.device)
    expand = (...,) + (None,) * len(shape)
    return threefry2x32(keys[..., 0][expand], keys[..., 1][expand], hi, lo)


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split`` (the foldlike split): keys (..., 2) ->
    (..., n, 2)."""
    bits1, bits2 = _hash(keys, (int(n),))
    return torch.stack([bits1, bits2], dim=-1)


def uniform(keys: torch.Tensor, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: keys (..., 2) -> (..., *shape)
    in [minval, maxval), from the 32 random bits ``bits1 ^ bits2`` of each
    element's flat index."""
    bits1, bits2 = _hash(keys, shape)
    bits = ((bits1 ^ bits2) >> 9) | _ONE_BITS  # < 2**31: fits int32
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return f  # f * 1 + 0, and f >= 0
    # XLA fuses f * (max - min) + min into one fma.  A float32 product is
    # exact in float64, so the float64 sum rounded once to float32 gives the
    # fma's bits (it could differ only where that sum lies exactly halfway
    # between two float32s)
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    fma = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fma)


def gumbel(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low":
    ``-log(-log(uniform(minval=tiny)))``."""
    return -torch.log(-torch.log(uniform(keys, shape, minval=F32_TINY)))
