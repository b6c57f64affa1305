# Port copy of src/repro/checkpoint/straggler.py: host-only, logic unchanged.
"""Straggler mitigation for storage-side work: speculative resubmission.

``speculative_map`` runs independent tasks on a worker pool; any task that has
not completed within ``timeout`` seconds is speculatively resubmitted to a spare
worker (both attempts race; first completion wins, results are idempotent by
construction — writes go to distinct tmp files and rename atomically). This is
the classic tail-latency defence for checkpoint shard writers hitting a slow
disk/object-store connection.

The trainer's other straggler defences live elsewhere: host data prefetch
(``repro_torch.data``), write-behind async checkpointing (``repro_torch.checkpoint``).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Callable, List, Sequence, TypeVar

__all__ = ["speculative_map"]

T = TypeVar("T")
R = TypeVar("R")


def speculative_map(fn: Callable[[T], R], items: Sequence[T], *,
                    timeout: float = 30.0, workers: int = 4,
                    max_attempts: int = 3) -> List[R]:
    """Map ``fn`` over ``items`` with speculative re-execution of stragglers.

    Returns results in input order. Raises the task's exception if every
    attempt of a task fails.
    """
    results: dict = {}
    errors: dict = {}
    lock = threading.Lock()

    def run_one(idx: int, item: T):
        try:
            r = fn(item)
            with lock:
                results.setdefault(idx, r)
        except BaseException as e:  # recorded; a speculative retry may still win
            with lock:
                errors.setdefault(idx, []).append(e)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        attempts = {i: 1 for i in range(len(items))}
        futures = {pool.submit(run_one, i, it): i for i, it in enumerate(items)}
        deadline = {i: time.monotonic() + timeout for i in range(len(items))}
        pending = set(futures)
        while pending:
            done, pending = wait(pending, timeout=0.05, return_when=FIRST_COMPLETED)
            now = time.monotonic()
            with lock:
                missing = [i for i in range(len(items))
                           if i not in results and len(errors.get(i, [])) < attempts[i]]
            # resubmit overdue tasks
            for i in list(missing):
                if now > deadline[i] and attempts[i] < max_attempts:
                    attempts[i] += 1
                    deadline[i] = now + timeout
                    f = pool.submit(run_one, i, items[i])
                    pending.add(f)
            with lock:
                if len(results) == len(items):
                    break
                hard_failed = [i for i in range(len(items))
                               if i not in results and len(errors.get(i, [])) >= max_attempts]
            if hard_failed:
                raise errors[hard_failed[0]][-1]
            if not pending and len(results) < len(items):
                # all futures drained; resubmit whatever is missing
                with lock:
                    todo = [i for i in range(len(items)) if i not in results]
                for i in todo:
                    if attempts[i] >= max_attempts:
                        raise errors.get(i, [RuntimeError(f"task {i} lost")])[-1]
                    attempts[i] += 1
                    pending.add(pool.submit(run_one, i, items[i]))
    return [results[i] for i in range(len(items))]
