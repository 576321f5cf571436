"""Explicit random keys: the port's counterpart of ``jax.random`` keys.

Every random number of the port comes from a :class:`RandomKeys` object that
the caller passes in; no code calls a global generator.  The object is split
where the JAX package splits its key, so a stand-in with the same methods
can replay ``jax.random``'s values call site for call site (the parity tests
do that).  The methods:

* ``split(n)`` -- ``n`` new keys of the same batch shape (``jax.random.split``
  unpacked: ``k0, k1 = key.split(2)``);
* ``split_stack(n)`` -- one key whose batch shape gains a trailing axis of
  ``n``: the array ``jax.random.split(key, n)`` that JAX scans or vmaps over;
* ``uniform(shape, low, high)`` and ``normal(shape)`` -- float64 draws of
  shape ``batch + shape``; ``low`` and ``high`` broadcast against the batch;
* ``randint(low, high)`` -- one Python int in ``[low, high)`` from an
  unbatched key (``jax.random.randint(key, (), low, high)``; validation seeds
  numpy's selection with it).

A key is an integer seed (63 bits where a split derives it; a checkpoint may
carry any seed below 2^64, see :mod:`gple_tpu_torch.io.checkpoint`).  A split hashes the parent's seed with the child's
position (``numpy.random.SeedSequence``) into the child's seed, and a draw
seeds a fresh ``torch.Generator`` on the key's device with the key's seed, so
the same seed gives the same run, a split costs no device work, and a
batched key draws its whole batch in one call.
"""

from __future__ import annotations

import numpy as np
import torch


class RandomKeys:
    def __init__(self, seed: int, device, batch: tuple = ()):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.batch = tuple(batch)

    def _derive(self, *tag: int) -> int:
        words = np.random.SeedSequence(self.seed, spawn_key=tag).generate_state(2, np.uint32)
        return int(words[0]) | (int(words[1] & 0x7FFFFFFF) << 32)

    def split(self, n: int = 2):
        return tuple(RandomKeys(self._derive(0, i), self.device, self.batch)
                     for i in range(n))

    def split_stack(self, n: int) -> "RandomKeys":
        return RandomKeys(self._derive(1, n), self.device, self.batch + (n,))

    def _generator(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        return gen

    def uniform(self, shape, low=0.0, high=1.0):
        u = torch.rand(self.batch + tuple(shape), generator=self._generator(),
                       dtype=torch.float64, device=self.device)
        low, high = (_batched(v, len(shape), self.device) for v in (low, high))
        return u * (high - low) + low

    def normal(self, shape):
        return torch.randn(self.batch + tuple(shape), generator=self._generator(),
                           dtype=torch.float64, device=self.device)

    def randint(self, low: int, high: int) -> int:
        if self.batch:
            raise ValueError(f"randint draws one number; this key has batch {self.batch}")
        return int(torch.randint(low, high, (), generator=self._generator(),
                                 device=self.device).item())


def _batched(value, n_trailing: int, device):
    """A bound given per batch element (a tensor of the batch's shape) with
    ``n_trailing`` singleton axes appended; Python numbers pass through."""
    if not isinstance(value, torch.Tensor):
        return value
    return value.to(device=device, dtype=torch.float64).reshape(
        value.shape + (1,) * n_trailing)
