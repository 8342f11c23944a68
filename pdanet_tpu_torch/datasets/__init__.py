"""Dataset registry and loader, copied from ``pdanet_tpu/datasets/__init__.py``
(``pcdet/datasets/__init__.py`` :9-76).

The torch DataLoader is replaced by a thin numpy batcher, as in the JAX
package: the pipeline is pure numpy, batches are dense fixed-shape arrays,
and the train and eval loops move them to the device in one copy each.
The KITTI and ONCE datasets are ported.
"""

import numpy as np

from .dataset import DatasetTemplate
from .kitti.kitti_dataset import KittiDataset
from .once.once_dataset import ONCEDataset
from .random_draws import sample_generator

__all__ = {
    "DatasetTemplate": DatasetTemplate,
    "KittiDataset": KittiDataset,
    "ONCEDataset": ONCEDataset,
}


def get_dataset_class(name):
    if name in __all__:
        return __all__[name]
    raise KeyError(f"unknown dataset {name}")


class SimpleLoader:
    """Minimal epoch loader: shards sample indices across processes
    (replaces torch DistributedSampler), shuffles per epoch with a seeded
    RNG, and yields dense collated batches.

    ``workers > 0`` prefetches samples on a thread pool (the reference uses
    4 torch DataLoader workers, datasets/__init__.py:66-73): ``__getitem__``
    is numpy-heavy (augmentor, gt-sampling) and numpy releases the GIL, so
    threads overlap host preprocessing with the device step.
    A sliding window of ~2 batches is kept in flight.  Each sample then
    draws from its own ``RandomState``, seeded from (``seed``, epoch,
    sample index) (``random_draws``), so a pass gives the same batches
    whatever the number of threads and their order; ``workers=0`` draws
    from numpy's global RNG, in the JAX package's order."""

    def __init__(self, dataset, batch_size, shuffle, seed=0, rank=0, world=1,
                 drop_last=None, workers=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world = world
        self.epoch = 0
        self.workers = workers
        self.drop_last = shuffle if drop_last is None else drop_last

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        per_rank = (n + self.world - 1) // self.world
        if self.drop_last:
            return per_rank // self.batch_size
        return (per_rank + self.batch_size - 1) // self.batch_size

    def _sample_plan(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(n)
        # pad+stride shard (reference eval DistributedSampler :24-44)
        per_rank = (n + self.world - 1) // self.world
        padded = np.concatenate([order, order[: per_rank * self.world - n]])
        my = padded[self.rank :: self.world]
        chunks = []
        for start in range(0, len(my), self.batch_size):
            chunk = my[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            chunks.append([int(i) for i in chunk])
        return chunks

    def _load(self, index):
        """Sample ``index`` under its own generator."""
        rs = np.random.RandomState([int(self.seed), int(self.epoch), int(index)])
        with sample_generator(rs):
            return self.dataset[index]

    def __iter__(self):
        chunks = self._sample_plan()
        if self.workers <= 0:
            for chunk in chunks:
                yield self.dataset.collate_batch(
                    [self.dataset[i] for i in chunk]
                )
            return
        from concurrent.futures import ThreadPoolExecutor

        flat = [i for chunk in chunks for i in chunk]
        window = max(2 * self.batch_size, self.workers)
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures = {}
            cursor = 0
            pos = 0
            for chunk in chunks:
                while cursor < len(flat) and cursor < pos + window:
                    futures[cursor] = pool.submit(self._load, flat[cursor])
                    cursor += 1
                batch = [futures.pop(pos + j).result() for j in range(len(chunk))]
                pos += len(chunk)
                yield self.dataset.collate_batch(batch)


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False,
                     root_path=None, workers=4, seed=0, logger=None,
                     training=True, merge_all_iters_to_one_epoch=False,
                     total_epochs=0, rank=0, world=1):
    """Mirror of the reference signature (datasets/__init__.py:47-76)."""
    dataset_cls = get_dataset_class(dataset_cfg.DATASET)
    dataset = dataset_cls(
        dataset_cfg=dataset_cfg,
        class_names=class_names,
        root_path=root_path,
        training=training,
        logger=logger,
    )
    if merge_all_iters_to_one_epoch:
        dataset._merge_all_iters_to_one_epoch = True
        dataset.total_epochs = total_epochs
    loader = SimpleLoader(
        dataset, batch_size, shuffle=training, seed=seed, rank=rank,
        world=world, workers=workers,
    )
    return dataset, loader, loader
