"""File-id sequencers. Port of seaweedfs_tpu/utils/sequence.py, whole.

Reference: weed/sequence — snowflake or raft-replicated max. A plain
counter resets on master restart, and a reused needle id OVERWRITES the
existing blob in its volume; snowflake ids (timestamp | node | seq) stay
unique across restarts with no persisted state.
"""

from __future__ import annotations

import threading
import time

_EPOCH_MS = 1_600_000_000_000  # 2020-09-13; keeps ids in 63 bits for decades
_NODE_BITS = 10
_SEQ_BITS = 12


class SnowflakeSequencer:
    """64-bit ids: [timestamp_ms(41) | node(10) | seq(12)], monotonic."""

    def __init__(self, node_id: int = 0):
        self.node_id = node_id & ((1 << _NODE_BITS) - 1)
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_id(self) -> int:
        with self._lock:
            now = int(time.time() * 1000)
            if now < self._last_ms:
                now = self._last_ms  # clock went backwards: hold position
            if now == self._last_ms:
                self._seq += 1
                if self._seq >= (1 << _SEQ_BITS):
                    # 4096 ids in one ms: borrow the next tick instead of
                    # busy-waiting with the lock held (a stepped-back
                    # clock would otherwise stall assigns for seconds)
                    now += 1
                    self._seq = 0
            else:
                self._seq = 0
            self._last_ms = now
            return (
                ((now - _EPOCH_MS) << (_NODE_BITS + _SEQ_BITS))
                | (self.node_id << _SEQ_BITS)
                | self._seq
            )


class CounterSequencer:
    """Monotonic in-memory counter (tests / ephemeral clusters)."""

    def __init__(self, start: int = 0):
        self._lock = threading.Lock()
        self._n = start

    def next_id(self) -> int:
        with self._lock:
            self._n += 1
            return self._n
