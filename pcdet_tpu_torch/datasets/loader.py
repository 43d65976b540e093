"""Prefetching data loader on the host.

The port's copy of `pcdet_tpu.datasets.loader` (in place of the reference's
torch DataLoader + DistributedSampler): a worker pool maps `dataset[i]`
over a shuffled, per-host strided index shard, and a bounded queue keeps
`prefetch` collated batches ready ahead of the device step.

Two worker modes (`worker_mode`):
  - 'thread' (default): the pipeline is numpy and native code, which
    release the GIL;
  - 'process': a fork pool, for the GIL-bound Python parts (the DB
    sampler's loops, the part targets).  It forks at every epoch's
    `__iter__`, possibly after CUDA is up in the parent: the workers touch
    only numpy and the host native libraries, never torch.cuda, and run
    their OpenMP regions on one thread (`host_native.serial_openmp`).
Batches are bit-identical across modes and worker counts because each
sample's augmentation RandomState is keyed on (seed, epoch, index).
`batch_transform` (SECOND's host books, `ops/host_books.
make_batch_transform`) runs in the parent's producer thread.
`num_workers=0` gives a synchronous loader.
"""
import multiprocessing
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops import host_native
from .dataset import collate_batch

# fork-inherited state for 'process' workers: set in the parent immediately
# before the pool is created; children see it via copy-on-write (zero
# per-task dataset pickling)
_WORKER_DATASET = None


def _worker_get(index):
    return _WORKER_DATASET[index]


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, num_workers=4,
                 seed=0, host_id=0, num_hosts=1, drop_last=True, prefetch=4,
                 worker_mode='thread', batch_transform=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        # post-collate hook run in the producer thread (e.g. host-built
        # sparse rulebooks, ops/host_books.py) — overlapped with device
        # compute like the rest of the pipeline; mutable so callers that
        # build the model after the loader can attach it later
        self.batch_transform = batch_transform

    def set_epoch(self, epoch):
        """DistributedSampler.set_epoch equivalent — reshuffles per epoch."""
        self.epoch = epoch

    def _epoch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # per-host strided shard (DistributedSampler equivalent)
        idx = idx[self.host_id::self.num_hosts]
        if self.drop_last:
            usable = (len(idx) // self.batch_size) * self.batch_size
            idx = idx[:usable]
        return idx

    def __len__(self):
        n = len(self.dataset)
        per_host = (n + self.num_hosts - 1) // self.num_hosts
        if self.drop_last:
            return per_host // self.batch_size
        return (per_host + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if hasattr(self.dataset, 'set_sample_seed'):
            # per-sample deterministic augmentation streams (independent of
            # worker count / thread arrival order)
            self.dataset.set_sample_seed(self.seed, self.epoch)
        indices = self._epoch_indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if not batches:
            return iter(())
        if self.num_workers <= 0:
            def gen():
                for b in batches:
                    batch = collate_batch([self.dataset[i] for i in b])
                    if self.batch_transform is not None:
                        batch = self.batch_transform(batch)
                    yield batch
            return gen()
        return _PrefetchIterator(self, batches)


class _PrefetchIterator:
    def __init__(self, loader, batches):
        self.loader = loader
        self.batches = batches
        self.q = queue.Queue(maxsize=loader.prefetch)
        if loader.worker_mode == 'process':
            global _WORKER_DATASET
            _WORKER_DATASET = loader.dataset  # fork inherits (epoch seed too)
            # multiprocessing.Pool, NOT ProcessPoolExecutor: Pool workers
            # are daemonic (die with the parent even if a forked worker
            # wedges on an inherited lock) and terminate() is public
            self.pool = multiprocessing.get_context('fork').Pool(
                processes=loader.num_workers,
                initializer=host_native.serial_openmp)
            self._get = _worker_get
        else:
            self.pool = ThreadPoolExecutor(max_workers=loader.num_workers)
            self._get = loader.dataset.__getitem__
        self.done = object()
        self.thread = threading.Thread(target=self._producer, daemon=True)
        self.thread.start()

    def _producer(self):
        try:
            for b in self.batches:
                examples = list(self.pool.map(self._get, b))
                batch = collate_batch(examples)
                if self.loader.batch_transform is not None:
                    batch = self.loader.batch_transform(batch)
                self.q.put(batch)
        except Exception as e:  # surface worker errors to the consumer
            self.q.put(e)
        finally:
            self.q.put(self.done)
            if isinstance(self.pool, ThreadPoolExecutor):
                self.pool.shutdown(wait=False)
            else:
                self.pool.terminate()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self.done:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item
