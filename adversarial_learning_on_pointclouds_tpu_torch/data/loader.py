"""Host-side batch iteration with background prefetch + device transfer.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/data/
loader.py``. Replaces the reference's ``torch.utils.data.DataLoader(
batch_size=32, shuffle=True, num_workers=4, drop_last=...)`` plumbing
(SURVEY.md §2.1). Batches are assembled as numpy on the host and moved to
the device ahead of consumption, from pinned host memory with
``non_blocking=True`` when the device is a card, so the copy overlaps the
previous step's work.

Three layers, composable:

* ``host_batch_iterator`` — pure-host numpy batch assembly (shuffle,
  drop-last / pad+mask), the analogue of the reference's Dataset+Sampler.
  It and the index streams (``host_index_iterator``,
  ``cycling_host_indices``, ``cycling_host_batches``) and
  ``num_batches`` are copies of the JAX package's: both runners define
  their epochs by the same permutations, bit for bit.
* ``device_batches`` — the device stage: optional K-stacking for the
  ``--scan K`` step forms ([K, B, ...] groups, one transfer per group),
  the copy to the device, threaded prefetch (the ``--workers`` knob).
  There is one device, so no sharding argument.
* ``batch_iterator`` — the one-call convenience wrapping both (the
  reference's ``DataLoader`` surface).

``cycling_host_batches`` reproduces the reference adversarial trainer's
unlabeled-stream semantics: an iterator that reshuffles and restarts
whenever exhausted (``upstream:train_adversarial*.py``'s
``try: next(loader_iter) except StopIteration: loader_iter = iter(loader)``
pattern), with its position persisting across labeled epochs.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch


def host_batch_iterator(arrays: Sequence[np.ndarray], batch_size: int,
                        shuffle: bool = True, drop_last: bool = True,
                        seed: int = 0, epoch: int = 0,
                        ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield numpy batch tuples from parallel host arrays.

    ``drop_last=True`` matches the reference's training loader (keeps every
    batch shape static for XLA); with ``False`` (eval) EVERY batch gets a
    boolean validity mask appended (all-True for full batches; the final
    ragged batch is padded up to ``batch_size`` with pad rows masked out) —
    constant tuple arity for consumers.

    Row selection delegates to ``host_index_iterator`` — ONE source of
    truth for the permutation stream, so the device-data path (which
    gathers ``pool[idx]`` on device from the index twin) is
    bit-identical by construction.
    """
    n = arrays[0].shape[0]
    for item in host_index_iterator(n, batch_size, shuffle, drop_last,
                                    seed, epoch):
        if drop_last:
            yield tuple(a[item] for a in arrays)
        else:
            idx, mask = item
            yield tuple(a[idx] for a in arrays) + (mask,)


def cycling_host_batches(arrays: Sequence[np.ndarray], batch_size: int,
                         seed: int = 0, start_epoch: int = 0,
                         ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Infinite shuffled host batches: reshuffle + restart on exhaustion.

    The reference's unlabeled-stream iterator for adversarial training
    cycles like this, its position persisting across labeled epochs.
    """
    pass_idx = start_epoch
    while True:
        yield from host_batch_iterator(arrays, batch_size, shuffle=True,
                                       drop_last=True, seed=seed,
                                       epoch=pass_idx)
        pass_idx += 1


def host_index_iterator(n: int, batch_size: int, shuffle: bool = True,
                        drop_last: bool = True, seed: int = 0,
                        epoch: int = 0) -> Iterator:
    """THE permutation stream: ``[batch_size]`` int32 row-index batches.

    ``host_batch_iterator`` gathers rows from these on the host; the
    device-resident data path ships them as-is and gathers ``pool[idx]``
    inside the jitted step — same indices, bit-identical batches.

    ``drop_last=True`` yields bare index vectors. ``drop_last=False``
    yields ``(idx, mask)`` pairs (the final ragged batch is padded with
    row 0 and the pad rows masked out; full batches get all-True masks) —
    a consumer without the mask could not distinguish pad rows from a
    genuine row-0 occurrence."""
    n_ = int(n)
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    order = rng.permutation(n_) if shuffle else np.arange(n_)
    for start in range(0, n_, batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size:
            if drop_last:
                return
            mask = np.concatenate([np.ones(len(idx), bool),
                                   np.zeros(batch_size - len(idx), bool)])
            idx = np.concatenate(
                [idx, np.zeros(batch_size - len(idx), idx.dtype)])
        else:
            mask = np.ones(batch_size, bool)
        yield (idx.astype(np.int32) if drop_last
               else (idx.astype(np.int32), mask))


def cycling_host_indices(n: int, batch_size: int, seed: int = 0,
                         start_epoch: int = 0) -> Iterator[np.ndarray]:
    """Index-only twin of ``cycling_host_batches`` (same index stream)."""
    pass_idx = start_epoch
    while True:
        yield from host_index_iterator(n, batch_size, shuffle=True,
                                       drop_last=True, seed=seed,
                                       epoch=pass_idx)
        pass_idx += 1


def device_batches(host_batches: Iterable[Tuple[np.ndarray, ...]],
                   device="cuda", k_stack: int = 0, prefetch: int = 2,
                   ) -> Iterator[Tuple[Tuple[torch.Tensor, ...], bool]]:
    """Device stage: optional K-stacking, transfer to ``device``, prefetch.

    Yields ``(batch_tuple, stacked)`` pairs. With ``k_stack > 1``,
    consecutive host batches are grouped and stacked to ``[K, B, ...]``
    (``stacked=True``) for the K-step forms — one host->device transfer
    per K steps; a final partial group is yielded as plain single batches
    (``stacked=False``) so the consumer never sees a ragged K.
    """
    device = torch.device(device)

    def gen():
        if k_stack > 1:
            group = []
            for batch in host_batches:
                group.append(batch)
                if len(group) == k_stack:
                    stacked = tuple(np.stack(parts)
                                    for parts in zip(*group))
                    yield to_device(stacked, device), True
                    group = []
            for batch in group:  # ragged tail -> single steps
                yield to_device(batch, device), False
        else:
            for batch in host_batches:
                yield to_device(batch, device), False

    return _prefetched(gen(), prefetch)


def batch_iterator(arrays: Sequence[np.ndarray], batch_size: int,
                   shuffle: bool = True, drop_last: bool = True,
                   seed: int = 0, epoch: int = 0, device="cuda",
                   prefetch: int = 2,
                   ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Device-resident batch tuples — ``host_batch_iterator`` + transfer
    + prefetch in one call (the reference's ``DataLoader`` surface)."""
    host = host_batch_iterator(arrays, batch_size, shuffle, drop_last,
                               seed, epoch)
    for batch, _ in device_batches(host, device, k_stack=0,
                                   prefetch=prefetch):
        yield batch


def num_batches(n: int, batch_size: int, drop_last: bool = True) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


def to_device(arrays: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, ...]:
    """numpy arrays -> tensors on ``device``; on a card each is copied into
    pinned host memory and moved with ``non_blocking=True`` (queued on the
    current stream, behind the work already there)."""
    device = torch.device(device)
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def _prefetched(gen: Iterator, prefetch: int) -> Iterator:
    """Run ``gen`` in a producer thread, ``prefetch`` items ahead."""
    if prefetch <= 0:
        yield from gen
        return
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _SENTINEL = object()

    def producer():
        try:
            for item in gen:
                q.put(item)
            q.put(_SENTINEL)
        except BaseException as e:  # propagate to the consumer
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
