"""Work started in a thread of the test process, so that it overlaps
other work there: a JAX reference step compiling (XLA's compiler releases
the GIL), PyTorch's CPU kernels, or ``run_ranks`` waiting on its rank
processes. Tracing and the host's Python take turns. A test file joins
what it started before any test that patches the JAX package runs."""

import concurrent.futures


def started(fn, *args, **kwargs) -> concurrent.futures.Future:
  """``fn(*args, **kwargs)`` started in a thread of its own: its future."""
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
  future = pool.submit(fn, *args, **kwargs)
  pool.shutdown(wait=False)
  return future


def in_threads(calls: dict) -> dict:
  """Each ``calls[key]()`` in a thread of its own, all at once:
  ``{key: its result}``."""
  runs = {key: started(fn) for key, fn in calls.items()}
  return {key: run.result() for key, run in runs.items()}
