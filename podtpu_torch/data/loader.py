"""Fixed-shape batching + threaded prefetch loader (the port's copy of
``podtpu/data/loader.py``: the same samples, seeds and batches).

* a **config-fixed** ``max_annots`` pad (-1 fill), so every batch has the
  same shape;
* per-host sharding: host ``i`` of ``n`` reads indices ``i::n`` (the
  DistributedSampler analog), equalized so every host runs as many batches;
* a thread pool decoding/augmenting ahead of the step (cv2 releases the GIL
  in its hot paths) and a bounded prefetch queue; ``worker_mode="process"``
  for a process pool instead.

Determinism: sample seeds derive from (base_seed, epoch, index), so a resume
at epoch k reproduces the same stream regardless of worker count.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

# Process-pool workers receive the dataset once (initializer), so
# per-sample IPC ships only the result arrays, not the dataset.
_WORKER_DATASET = None


def _init_pool_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _pool_get(args):
    index, seed = args
    return _WORKER_DATASET.get(index, seed)


def pad_annotations(boxes_list, max_annots: int) -> np.ndarray:
    """[B, max_annots, 5] with -1 padding; overflow annotations drop."""
    b = len(boxes_list)
    out = np.full((b, max_annots, 5), -1.0, np.float32)
    for i, boxes in enumerate(boxes_list):
        n = min(len(boxes), max_annots)
        if n:
            out[i, :n] = boxes[:n]
    return out


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool,
        max_annots: int = 64,
        workers: int = 8,
        seed: int = 0,
        drop_last: bool | None = None,
        host_id: int = 0,
        host_count: int = 1,
        prefetch: int = 4,
        worker_mode: str = "thread",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_annots = max_annots
        self.workers = max(1, workers)
        self.seed = seed
        self.drop_last = shuffle if drop_last is None else drop_last
        self.host_id = host_id
        self.host_count = host_count
        self.prefetch = prefetch
        # "thread" (default; cv2 releases the GIL in its hot paths) or
        # "process" (GIL-proof for numpy-heavy augmentation mixes; the
        # in-RAM image cache is then per worker, not shared)
        assert worker_mode in ("thread", "process")
        self.worker_mode = worker_mode
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        """This host's shard, equalized across hosts: when
        ``n % host_count != 0`` the short shards wrap around and repeat
        their first indices (torch DistributedSampler's padding) so all
        shards have ``ceil(n / host_count)`` samples. ``n_valid`` only marks
        the ragged final batch's padding, not these."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        else:
            order = np.arange(n)
        shard = order[self.host_id :: self.host_count]
        if self.host_count > 1:
            target = -(-n // self.host_count)
            if len(shard) < target:
                shard = np.concatenate([shard, shard[: target - len(shard)]])
        return shard

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _sample_seed(self, index: int) -> int:
        return int(
            np.random.SeedSequence([self.seed, self.epoch, int(index)])
            .generate_state(1)[0]
        )

    def __iter__(self):
        """Yields {img, annot, n_valid}. Every batch has the full static
        ``batch_size``: a ragged final batch (eval, drop_last=False) is padded
        by repeating its last sample, with ``n_valid`` recording how many rows
        are real; metrics slice by n_valid."""
        indices = self._indices()
        nb = len(self)
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(nb)
        ]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            # Any worker exception must reach the consumer: a silently dead
            # producer would deadlock the training loop on q.get().
            try:
                if self.worker_mode == "process":
                    # spawn, not fork: the pool is created from a producer
                    # thread and cv2 holds internal locks; forking a
                    # threaded process deadlocks in the children
                    import multiprocessing as mp

                    pool_cm = ProcessPoolExecutor(
                        self.workers, mp_context=mp.get_context("spawn"),
                        initializer=_init_pool_worker,
                        initargs=(self.dataset,))
                else:
                    pool_cm = ThreadPoolExecutor(self.workers)
                with pool_cm as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        n_valid = len(batch_idx)
                        if n_valid < self.batch_size:
                            pad = self.batch_size - n_valid
                            batch_idx = np.concatenate(
                                [batch_idx, np.repeat(batch_idx[-1:], pad)]
                            )
                        work = [(int(i), self._sample_seed(i))
                                for i in batch_idx]
                        if self.worker_mode == "process":
                            samples = list(pool.map(_pool_get, work))
                        else:
                            samples = list(pool.map(
                                lambda w: self.dataset.get(*w), work))
                        imgs = np.stack([s[0] for s in samples])
                        annots = pad_annotations(
                            [s[1] for s in samples], self.max_annots
                        )
                        batch = {"img": imgs, "annot": annots,
                                 "n_valid": n_valid}
                        if len(samples[0]) > 2:
                            # device_geom: per-sample (sx, sy, bx, by) rows
                            batch["geom"] = np.stack(
                                [s[2] for s in samples])
                        q.put(batch)
            except BaseException as exc:  # propagate to the consumer
                q.put(exc)
            else:
                q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so a blocked producer can observe `stop` and exit
            while not q.empty():
                q.get_nowait()
            # then wait for it: close() must not return while pool workers
            # are still decoding (callers may delete the data directory
            # right after, and an un-joined pool keeps stealing CPU from
            # the next consumer)
            thread.join(timeout=30.0)
