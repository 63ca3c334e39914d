"""Training data: memory-mapped token shards and a deterministic,
resumable batch loader with double-buffered copies to the card.

The port of the JAX package's `utils/data.py`:

- a shard is a flat file of token ids of any integer dtype behind a
  64-byte ``MFATOK1`` header (`write_shard`, `open_shard`): the same
  bytes as the JAX package's, read through `np.memmap`;
- `TokenLoader` cuts windows of ``seq_len + 1`` tokens (inputs and the
  shifted targets in one draw) at positions drawn from
  ``np.random.SeedSequence([seed, step])``, shards weighted by size: a
  batch is a pure function of (seed, step), so the port yields the JAX
  package's batches token for token, and ``state()`` / `from_state`
  resume the stream (with `utils.checkpoint`);
- prefetch: batch k + 1 is assembled in a pinned host buffer and copied
  with ``non_blocking=True`` on a side stream before batch k is yielded;
  the consumer's stream waits on the copy's event, so the copy runs
  under the step's compute.  This is the torch form of the JAX
  package's ``jax.device_put`` of the next batch.

Batches are ``torch.int32 [batch, seq_len + 1]`` on ``device``, the card
unless the caller passes ``device="cpu"``.  With ``sharding=``
(`parallel.mesh.NamedSharding`, such as P(DATA_AXIS, None) over the
training mesh) every rank draws the same batch, which stays a pure
function of (seed, step), and keeps its own block of it: JAX's
``jax.device_put(batch, sharding)`` cut to this rank's addressable
shard.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from metal_flash_attention_tpu_torch.parallel.mesh import (
    NamedSharding,
    block_slices,
    check_mesh,
)
from metal_flash_attention_tpu_torch.utils.device import resolve_device

HEADER_BYTES = 64


def write_shard(path: str, tokens: np.ndarray) -> None:
    """Write a flat token array as a shard (its dtype and size in the
    header)."""
    tokens = np.ascontiguousarray(tokens)
    with open(path, "wb") as f:
        header = f"MFATOK1 {tokens.dtype.str} {tokens.size}\n".encode()
        f.write(header.ljust(HEADER_BYTES, b" "))
        f.write(tokens.tobytes())


def open_shard(path: str) -> np.ndarray:
    """Memory-map a shard written by `write_shard`."""
    with open(path, "rb") as f:
        header = f.read(HEADER_BYTES).decode().split()
    if not header or header[0] != "MFATOK1":
        raise ValueError(f"not a token shard: {path}")
    dtype, size = np.dtype(header[1]), int(header[2])
    return np.memmap(path, dtype=dtype, mode="r", offset=HEADER_BYTES,
                     shape=(size,))


class TokenLoader:
    """Deterministic, resumable batches over token shards.

    >>> loader = TokenLoader(["shard0.bin"], batch=8, seq_len=4096)
    >>> for tokens in loader.take(steps):   # int32 [8, 4097] on the card
    ...     params, state, loss = step_fn(params, state, tokens)

    ``state()`` -> (seed, step), the position of the next batch;
    `from_state` resumes there.  ``sharding``: a `NamedSharding` of the
    [batch, seq_len + 1] batch; each yielded tensor is this rank's
    block."""

    def __init__(self, shard_paths, batch: int, seq_len: int, *,
                 seed: int = 0, step: int = 0, device=None, sharding=None):
        self.block = (slice(None), slice(None))
        if sharding is not None:
            if not isinstance(sharding, NamedSharding):
                raise TypeError(f"sharding must be a NamedSharding, got "
                                f"{type(sharding).__name__}")
            check_mesh(sharding.mesh)
            self.block = block_slices((batch, seq_len + 1), sharding.spec,
                                      sharding.mesh)
        if not shard_paths:
            raise ValueError("need at least one shard")
        self.paths = list(shard_paths)
        self.shards = [open_shard(p) for p in self.paths]
        self.sizes = np.asarray([s.size for s in self.shards], np.int64)
        if not all(self.sizes >= seq_len + 1):
            raise ValueError("every shard must hold at least seq_len + 1 "
                             "tokens")
        self.batch = batch
        self.seq_len = seq_len
        self.block_shape = tuple(len(range(n)[b]) for b, n in zip(
            self.block, (batch, seq_len + 1)))
        self.seed = seed
        self.step = step
        self.device = resolve_device(device)
        self._stream = None
        self._pinned: list = []

    # -- resumability ----------------------------------------------------

    def state(self) -> tuple[int, int]:
        return (self.seed, self.step)

    @classmethod
    def from_state(cls, shard_paths, batch: int, seq_len: int,
                   state: tuple[int, int], **kw) -> "TokenLoader":
        seed, step = state
        return cls(shard_paths, batch, seq_len, seed=seed, step=step, **kw)

    # -- sampling --------------------------------------------------------

    def _host_batch(self, step: int, out: Optional[np.ndarray] = None
                    ) -> np.ndarray:
        """This rank's block of batch ``step`` on the host (the whole batch
        without ``sharding``), written into ``out`` when given: a pure
        function of (seed, step), the JAX package's draw for draw.  Every
        row is drawn, so each rank's stream of draws is the same."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        span = self.seq_len + 1
        probs = self.sizes / self.sizes.sum()
        rows, cols = self.block
        kept = range(self.batch)[rows]
        if out is None:
            out = np.empty(self.block_shape, np.int32)
        for i in range(self.batch):
            s = rng.choice(len(self.shards), p=probs)
            start = rng.integers(0, self.sizes[s] - span + 1)
            if i in kept:
                out[kept.index(i)] = self.shards[s][start:start + span][cols]
        return out

    def _put(self, step: int):
        """Start this rank's block of batch ``step`` on its way to the
        device: -> (tensor, the copy's event or None)."""
        if self.device.type != "cuda":
            return torch.from_numpy(self._host_batch(step)).to(
                self.device), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pinned = [[torch.empty(self.block_shape,
                                         dtype=torch.int32).pin_memory(),
                             None] for _ in range(2)]
        slot = self._pinned[step % 2]
        if slot[1] is not None:
            slot[1].synchronize()       # its last copy has left the buffer
        self._host_batch(step, slot[0].numpy())
        with torch.cuda.stream(self._stream):
            dev = slot[0].to(self.device, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record(self._stream)
        return dev, slot[1]

    def __iter__(self) -> Iterator[torch.Tensor]:
        # Double buffering: batch k + 1's copy is issued before batch k
        # is yielded, so it overlaps the consumer's compute.
        nxt = self._put(self.step)
        while True:
            cur, event = nxt
            self.step += 1
            nxt = self._put(self.step)
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                cur.record_stream(stream)
            yield cur

    def take(self, n: int) -> Iterator[torch.Tensor]:
        it = iter(self)
        for _ in range(n):
            yield next(it)
