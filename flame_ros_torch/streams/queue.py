"""Bounded thread-safe queue with drop-newest backpressure.

A copy of `flame_ros_tpu/streams/queue.py` (host code; the port imports
nothing of the JAX package).

Capability parity with ros_sensor_streams::ThreadSafeQueue (reference:
src/ros_sensor_streams/thread_safe_queue.h:38-128): a bounded push that
*drops the incoming item* when full (h:70-83), blocking front/pop via a
condition variable (h:88-103), and an exposed condition for consumers that
want to wait on non-empty themselves (h:109-120).
"""
from __future__ import annotations

import collections
import threading
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class ThreadSafeQueue(Generic[T]):
    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._items: collections.deque = collections.deque()
        self._mutex = threading.RLock()
        self._non_empty = threading.Condition(self._mutex)
        self.num_dropped = 0

    def push(self, item: T) -> bool:
        """Append; drop the *new* item if full (reference drop semantics)."""
        with self._mutex:
            if len(self._items) >= self.maxsize:
                self.num_dropped += 1
                return False
            self._items.append(item)
            self._non_empty.notify()
            return True

    def front(self, timeout: Optional[float] = None) -> Optional[T]:
        """Block until non-empty; return (but do not remove) the head."""
        with self._non_empty:
            if not self._non_empty.wait_for(lambda: len(self._items) > 0,
                                            timeout):
                return None
            return self._items[0]

    def pop(self, timeout: Optional[float] = None) -> Optional[T]:
        with self._non_empty:
            if not self._non_empty.wait_for(lambda: len(self._items) > 0,
                                            timeout):
                return None
            return self._items.popleft()

    def __len__(self) -> int:
        with self._mutex:
            return len(self._items)

    def empty(self) -> bool:
        return len(self) == 0

    @property
    def mutex(self) -> threading.RLock:
        return self._mutex

    @property
    def non_empty(self) -> threading.Condition:
        return self._non_empty
