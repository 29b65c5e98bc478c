"""Host-side data pipeline: checkpointable cursor, background prefetch,
placement on a device; port of `repro.data.pipeline`.

The pipeline's only state is its integer ``step`` cursor (datasets are
addressable by step), so checkpoint/restore and restarts are exact: save
``pipeline.state_dict()``, restore with ``load_state_dict``.  Prefetch
runs the (numpy) generation of the next batches on a thread.  With
``device`` set, each batch array leaves `__next__` as a tensor on that
device; without it, as the dataset's numpy array.  (The reference's
``sharding_fn`` comes with scale-out.)
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable

import torch


class DataPipeline:
    def __init__(self, dataset: Any, *, start_step: int = 0,
                 prefetch: int = 2,
                 transform: Callable[[dict], dict] | None = None,
                 device=None):
        self._dataset = dataset
        self._step = start_step
        self._transform = transform
        self._device = None if device is None else torch.device(device)
        self._prefetch_n = prefetch
        self._q: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        if prefetch > 0:
            self._start_prefetch()

    # ------------------------------------------------------------- state

    def state_dict(self) -> dict:
        return {"step": self._step}

    def load_state_dict(self, state: dict) -> None:
        self._restart_at(int(state["step"]))

    def _restart_at(self, step: int) -> None:
        self._shutdown()
        self._step = step
        if self._prefetch_n > 0:
            self._start_prefetch()

    # ------------------------------------------------------------- prefetch

    def _start_prefetch(self) -> None:
        self._stop.clear()
        self._q = queue.Queue(maxsize=self._prefetch_n)
        self._fetch_step = self._step

        def worker():
            while not self._stop.is_set():
                batch = self._make(self._fetch_step)
                self._fetch_step += 1
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _shutdown(self) -> None:
        if self._thread is not None:
            self._stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            self._thread = None

    # ------------------------------------------------------------- iterate

    def _make(self, step: int) -> dict:
        batch = self._dataset.batch_at(step)
        if self._transform is not None:
            batch = self._transform(batch)
        return batch

    def _place(self, batch: dict) -> dict:
        if self._device is None:
            return batch
        return {k: torch.as_tensor(v).to(self._device)
                for k, v in batch.items()}

    def __next__(self) -> dict:
        if self._q is not None:
            batch = self._q.get()
        else:
            batch = self._make(self._step)
        self._step += 1
        return self._place(batch)

    def __iter__(self):
        return self

    def close(self):
        self._shutdown()
