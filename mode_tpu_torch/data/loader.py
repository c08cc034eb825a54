"""The threaded batching data loader (``mode_tpu/data/loader.py``).

It takes the place of torch's multi-process ``DataLoader``, which every
reference CLI uses (``train_disparity.py:257-258``): a pool of threads
decodes (numpy, PIL and the native library release the GIL, so threads
scale), batches are collated into numpy arrays, and a bounded queue keeps a
few batches in flight ahead of the device. Threads, not worker processes:
a process forked after the CLI has initialised CUDA cannot use it. Each CLI
moves a batch to its device in one copy per array.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Sequence

import numpy as np


def default_collate(items: Sequence[dict]) -> dict:
  """Stack numpy leaves; collect non-array leaves (names) into lists."""
  out: dict[str, Any] = {}
  for key in items[0]:
    vals = [it[key] for it in items]
    if isinstance(vals[0], np.ndarray):
      out[key] = np.stack(vals)
    elif isinstance(vals[0], (int, float, np.floating, np.integer)):
      out[key] = np.asarray(vals)
    else:
      out[key] = list(vals)
  return out


class DataLoader:
  """Iterable over collated batches with background prefetch.

  Args mirror torch's: dataset (len/getitem), batch_size, shuffle (epoch-
  seeded), num_workers (decode threads), drop_last, prefetch (batches kept
  in flight). ``rows`` (``rows(n) -> slice``, a data-parallel rank's
  ``parallel.mesh.batch_sharding``) makes each batch only those rows of
  the global batch of ``batch_size``: every rank shuffles the same way and
  decodes its own rows.
  """

  def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
               num_workers: int = 4, drop_last: bool = False,
               seed: int = 0, prefetch: int = 2, rows=None):
    self.dataset = dataset
    self.batch_size = batch_size
    self.shuffle = shuffle
    self.num_workers = max(1, num_workers)
    self.drop_last = drop_last
    self.seed = seed
    self.prefetch = max(1, prefetch)
    self.rows = rows
    self.epoch = 0

  def set_epoch(self, epoch: int):
    self.epoch = epoch

  def __len__(self):
    n = len(self.dataset)
    if self.drop_last:
      return n // self.batch_size
    return (n + self.batch_size - 1) // self.batch_size

  def _batches(self) -> list[list[int]]:
    idx = np.arange(len(self.dataset))
    if self.shuffle:
      rng = np.random.default_rng(self.seed + self.epoch)
      rng.shuffle(idx)
    batches = [idx[i:i + self.batch_size].tolist()
               for i in range(0, len(idx), self.batch_size)]
    if self.drop_last and batches and len(batches[-1]) < self.batch_size:
      batches.pop()
    if self.rows is not None:
      batches = [b[self.rows(len(b))] for b in batches]
    return batches

  def __iter__(self) -> Iterator[dict]:
    batches = self._batches()
    q: queue.Queue = queue.Queue(maxsize=self.prefetch)
    stop = threading.Event()
    get_batch = getattr(self.dataset, "get_batch", None)

    def put(item) -> bool:
      """Queue ``item`` unless the consumer has stopped; False if it has."""
      while not stop.is_set():
        try:
          q.put(item, timeout=0.05)
          return True
        except queue.Full:
          continue
      return False

    def produce():
      with ThreadPoolExecutor(self.num_workers) as pool:
        try:
          for batch_idx in batches:
            batch = None
            if get_batch is not None:
              batch = get_batch(batch_idx, self.num_workers)
            if batch is None:     # no fast path, or the dataset declined
              batch = default_collate(
                  list(pool.map(self.dataset.__getitem__, batch_idx)))
            if not put(batch):
              return
        except Exception as e:  # raised again in the consumer
          put(e)
        finally:
          put(None)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
      while True:
        item = q.get()
        if item is None:
          return
        if isinstance(item, Exception):
          raise item
        yield item
    finally:
      # a consumer that stops early (``--max_batches``) ends the producer
      # after the batch it is decoding
      stop.set()
      t.join()
