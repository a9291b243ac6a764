"""Annotation rows and a prefetching loader (torch twin of
llava_align_tpu/framework/data.py): JsonlDataset (jsonl through the port's
native line index, framework/native), and copies of ListDataset and
PrefetchLoader, the POPE runner's host prefetch threads (tokenize and
decode images ahead of the device).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Iterator, List, Optional


class JsonlDataset:
    """Annotation dataset over a jsonl (or json-list) file.

    With use_native=True (default), jsonl files are served by the C++ mmap
    line index (framework/native.py) — O(1) random access, no Python
    materialization; falls back to in-memory rows when the toolchain is
    absent or the file is a json list. `native` says which path serves."""

    def __init__(
        self,
        path: str,
        transform: Optional[Callable[[dict], Any]] = None,
        use_native: bool = True,
    ):
        path = os.path.expanduser(path)
        self.transform = transform
        self.rows: Optional[List[dict]] = None
        self._native = None
        with open(path) as f:
            head = f.read(1)
        if head != "[" and use_native:
            try:
                from llava_align_tpu_torch.framework.native import NativeJsonl

                self._native = NativeJsonl(path)
            except Exception:
                self._native = None
        if self._native is None:
            with open(path) as f:
                if head == "[":
                    self.rows = json.load(f)
                else:
                    self.rows = [json.loads(line) for line in f if line.strip()]

    @property
    def native(self) -> bool:
        return self._native is not None

    def __len__(self) -> int:
        return len(self._native) if self._native is not None else len(self.rows)

    def __getitem__(self, i: int):
        row = self._native[i] if self._native is not None else self.rows[i]
        return self.transform(row) if self.transform else row


class ListDataset:
    """In-memory rows + transform (collate partner for PrefetchLoader)."""

    def __init__(self, rows: List[Any], transform: Optional[Callable[[Any], Any]] = None):
        self.rows = rows
        self.transform = transform

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int):
        row = self.rows[i]
        return self.transform(row) if self.transform else row


class PrefetchLoader:
    """Iterate a dataset with worker threads preparing samples ahead of the
    consumer; order-preserving. `collate` groups `batch_size` prepared samples.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        num_workers: int = 2,
        prefetch: int = 4,
        collate: Optional[Callable[[List[Any]], Any]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate = collate or (lambda x: x)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        results: dict = {}
        lock = threading.Lock()
        cond = threading.Condition(lock)
        next_to_fetch = [0]
        error: List[BaseException] = []
        # set when the consumer abandons the iterator (GeneratorExit via
        # itertools.islice, an exception in the training loop, ...) — without
        # it the workers would block in cond.wait forever once the prefetch
        # window fills, leaking num_workers threads + the decoded window per
        # abandoned epoch (Runner.train_epoch islices every inner epoch)
        stopped = [False]

        def worker():
            while True:
                with lock:
                    i = next_to_fetch[0]
                    if i >= n or error or stopped[0]:
                        return
                    # bounded prefetch window; re-enter the wait after
                    # re-reading next_to_fetch — between a wakeup and the
                    # claim another worker may have refilled the window, and
                    # claiming anyway would overshoot the bound by up to
                    # num_workers decoded items
                    while True:
                        while (len(results) >= self.prefetch * self.batch_size
                               and not (error or stopped[0])):
                            cond.wait(timeout=0.1)
                        if error or stopped[0]:
                            return
                        i = next_to_fetch[0]
                        if i >= n:
                            return
                        if len(results) < self.prefetch * self.batch_size:
                            break
                    next_to_fetch[0] = i + 1
                try:
                    item = self.dataset[i]
                except BaseException as e:  # surface in consumer
                    with lock:
                        error.append(e)
                        cond.notify_all()
                    return
                with lock:
                    results[i] = item
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            batch: List[Any] = []
            for i in range(n):
                with lock:
                    while i not in results and not error:
                        cond.wait(timeout=0.1)
                    if error:
                        raise error[0]
                    item = results.pop(i)
                    cond.notify_all()
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate(batch)
                    batch = []
            if batch:
                yield self.collate(batch)
        finally:
            with lock:
                stopped[0] = True
                results.clear()
                cond.notify_all()
