"""Where the data pipeline draws its random numbers.

Every draw of the pipeline (the world augmentors, the gt sampler, the point
processors and the dataset's re-roll of a frame left without gt) goes
through :func:`rng`.  With no generator set, that is numpy's global
functions (``np.random``), in the JAX package's order.  ``SimpleLoader``
with ``workers > 0`` loads each sample under :func:`sample_generator`,
which sets, for the thread that loads it, the sample's own
``RandomState`` seeded from (loader seed, epoch, sample index): what a
sample draws then does not depend on the order in which the threads run.
"""

import threading
from contextlib import contextmanager

import numpy as np

_local = threading.local()


def own_generator():
    """The ``RandomState`` set for this thread's sample, or None."""
    return getattr(_local, "rs", None)


def rng():
    """The generator to draw from: this thread's sample's own, or numpy's
    global functions (``np.random`` has the ``RandomState`` methods)."""
    rs = own_generator()
    return np.random if rs is None else rs


@contextmanager
def sample_generator(rs):
    """Draw from ``rs`` in this thread while the block runs."""
    old = own_generator()
    _local.rs = rs
    try:
        yield rs
    finally:
        _local.rs = old
