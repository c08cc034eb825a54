"""Start one process per rank on this host, as ``torchrun`` does.

    results = run_ranks(fn, world=2, args=(...), timeout=300, device="cpu")

Each rank is a process of its own (``spawn``), with ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` on
the loopback address and a free ``MASTER_PORT``). It joins the process
group (``mesh.join_group``, also at a world of one), calls ``fn(*args)``
and hands back its result, its tensors as numpy arrays. ``fn`` must be importable by name
(a module-level function). A rank that raises, dies or outlives the
timeout makes :func:`run_ranks` raise after every rank has been stopped.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import torch

from mode_tpu_torch.parallel import mesh as pmesh


def free_port() -> int:
  """A TCP port on the loopback address that nothing listens on now."""
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def to_host(obj):
  """``obj`` with its tensors as numpy arrays (what a rank hands back)."""
  if isinstance(obj, torch.Tensor):
    return obj.detach().cpu().numpy()
  if isinstance(obj, dict):
    return {k: to_host(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return type(obj)(to_host(v) for v in obj)
  return obj


def _rank_main(fn, rank, world, port, args, device, backend, threads,
               results):
  os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                     "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                     "MASTER_PORT": str(port)})
  if threads:
    torch.set_num_threads(threads)
  try:
    pmesh.join_group(device, backend)
    try:
      out = to_host(fn(*args))
    finally:
      torch.distributed.destroy_process_group()
    results.put((rank, True, out))
  except BaseException:  # reported to the parent, which raises
    results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, args: tuple = (), *, timeout: float,
              device: str | None = None, backend: str | None = None,
              threads: int | None = None) -> list:
  """``[fn(*args) on rank r for r in range(world)]``, each in its own
  process (module docstring). ``device``/``backend`` as
  ``mesh.join_group`` takes them; ``threads`` sets each rank's
  CPU threads. Raises ``RuntimeError`` naming the ranks that failed, and
  ``TimeoutError`` if any has not finished ``timeout`` seconds after the
  start."""
  ctx = mp.get_context("spawn")
  results = ctx.Queue()
  port = free_port()
  procs = [ctx.Process(target=_rank_main, args=(
      fn, rank, world, port, args, device, backend, threads, results))
           for rank in range(world)]
  for p in procs:
    p.start()
  deadline = time.monotonic() + timeout
  got, failed = {}, {}
  try:
    while len(got) + len(failed) < world:
      left = deadline - time.monotonic()
      if left <= 0 and not failed:
        raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} "
                           f"did not finish in {timeout} s")
      if left <= 0:
        break               # the others wait on the rank that failed
      if failed:            # give them a little time to report, no more
        deadline = min(deadline, time.monotonic() + 10)
      try:
        rank, ok, out = results.get(timeout=min(left, 1.0))
      except queue.Empty:
        dead = [r for r, p in enumerate(procs)
                if not p.is_alive() and r not in got and r not in failed
                and p.exitcode not in (0, None)]
        for r in dead:
          failed[r] = f"exited with code {procs[r].exitcode}"
        continue
      (got if ok else failed)[rank] = out
  finally:
    for p in procs:
      p.join(timeout=5 if not failed else 0.5)
      if p.is_alive():
        p.kill()
        p.join()
    results.close()
  if failed:
    raise RuntimeError("ranks failed:\n" + "\n".join(
        f"rank {r}: {msg}" for r, msg in sorted(failed.items())))
  return [got[r] for r in range(world)]
