"""Host bookkeeping: the data layer's window packing and the serving
engines' KV page allocator and FCFS request scheduler (counterpart of
magicdec_tpu/native/__init__.py ``window_pack``, ``PageAllocator`` and
``Scheduler``).

Pure Python and numpy with the semantics of the JAX package's native
runtime (``runtime.cpp``) and its Python fallbacks: the windows are packed
once when a corpus loads, and the engines call the allocator and the
scheduler once per admission wave and drain, never inside the decode loop,
so there is nothing here for the card to speed up.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def tile_windows(windows: np.ndarray, repeats: int) -> np.ndarray:
    """[n, seq_len] windows tiled ``repeats`` times: [n * repeats, seq_len],
    the whole matrix once a repeat (``md_tile_windows``)."""
    windows = np.ascontiguousarray(windows, dtype=np.int32)
    return np.tile(windows, (max(int(repeats), 0), 1))


def window_pack(tokens: np.ndarray, seq_len: int, bos_id: Optional[int],
                repeats: int = 1) -> np.ndarray:
    """Token stream -> [n * repeats, seq_len] int32 windows, n = len(tokens)
    // seq_len, each with ``bos_id`` forced at its position 0 (``None``: the
    tokens as they are), tiled ``repeats`` times.  ``seq_len`` <= 0 or a
    stream shorter than ``seq_len`` gives 0 windows (``md_window_pack``)."""
    tokens = np.ascontiguousarray(tokens, dtype=np.int32).reshape(-1)
    if seq_len <= 0 or len(tokens) < seq_len:
        return np.empty((0, max(int(seq_len), 0)), np.int32)
    n = len(tokens) // seq_len
    out = tokens[: n * seq_len].reshape(n, seq_len).copy()
    if bos_id is not None:
        out[:, 0] = bos_id
    return out if repeats == 1 else tile_windows(out, repeats)


class PageAllocator:
    """Free-list KV page allocator: a request admitted with ``initial_len``
    rows takes ceil(initial_len / page_size) pages, lowest free page id
    first, into the lowest free request slot, and gives them back at
    ``release``."""

    def __init__(self, total_pages: int, page_size: int, max_requests: int,
                 pages_per_request_cap: int):
        self.shape = (max_requests, pages_per_request_cap)
        self.page_size = page_size
        self._free = list(range(total_pages))[::-1]
        self._table = np.full(self.shape, -1, np.int32)
        self._num = np.zeros(max_requests, np.int32)
        self._len = np.zeros(max_requests, np.int32)
        self._active = np.zeros(max_requests, np.uint8)

    def free_pages(self) -> int:
        return len(self._free)

    def admit(self, initial_len: int) -> int:
        """The request slot that now holds ``initial_len`` rows, or -1 when
        no slot or not enough pages are free."""
        need = -(-initial_len // self.page_size)
        if need > self.shape[1] or len(self._free) < need:
            return -1
        for s in range(self.shape[0]):
            if not self._active[s]:
                self._active[s] = 1
                self._len[s] = initial_len
                self._num[s] = need
                for i in range(need):
                    self._table[s, i] = self._free.pop()
                return s
        return -1

    def release(self, slot: int) -> None:
        if slot < 0 or not self._active[slot]:
            return
        for i in range(int(self._num[slot])):
            self._free.append(int(self._table[slot, i]))
            self._table[slot, i] = -1
        self._num[slot] = 0
        self._len[slot] = 0
        self._active[slot] = 0

    def tables(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(page_indices [R, cap] int32 with -1 past a slot's pages, lengths
        [R] int32, active [R] bool)."""
        return self._table.copy(), self._len.copy(), self._active.astype(bool)


class Scheduler:
    """FCFS continuous-batching scheduler: ``submit`` queues a request,
    ``assign`` pairs queued requests with free slots in ascending slot
    order, ``complete`` frees a slot and accounts the request's latency."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._q: List[Tuple[int, int]] = []
        self._slot_req = [-1] * n_slots
        self._slot_start = [0] * n_slots
        self._served = 0
        self._sum_q = 0.0
        self._sum_s = 0.0

    def submit(self, req_id: int, arrival_us: int = 0) -> None:
        self._q.append((req_id, arrival_us))

    def assign(self, now_us: int = 0, max_n: Optional[int] = None) -> list:
        """[(req_id, slot), ...], at most ``max_n`` pairs."""
        max_n = self.n_slots if max_n is None else min(max_n, self.n_slots)
        pairs = []
        for slot in range(self.n_slots):
            if len(pairs) >= max_n:
                break
            if self._slot_req[slot] >= 0 or not self._q:
                continue
            rid, arr = self._q.pop(0)
            self._sum_q += now_us - arr
            self._slot_req[slot] = rid
            self._slot_start[slot] = now_us
            pairs.append((rid, slot))
        return pairs

    def complete(self, slot: int, now_us: int = 0) -> int:
        """The request that held ``slot`` (-1 when it was free)."""
        if slot < 0 or self._slot_req[slot] < 0:
            return -1
        rid = self._slot_req[slot]
        self._slot_req[slot] = -1
        self._sum_s += now_us - self._slot_start[slot]
        self._served += 1
        return rid

    def counts(self) -> Tuple[int, int, int]:
        """(queued, running, served)."""
        running = sum(r >= 0 for r in self._slot_req)
        return len(self._q), running, self._served

    def stats(self) -> Tuple[float, float]:
        """(mean queue us, mean service us)."""
        assigned = self._served + sum(r >= 0 for r in self._slot_req)
        return (self._sum_q / assigned if assigned else 0.0,
                self._sum_s / self._served if self._served else 0.0)
