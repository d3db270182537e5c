"""Scene-batch prefetching (port of ``gpudrive_lab_tpu/scene/prefetch.py``).

A runtime component with no reference equivalent (the reference parses the
scene JSONs inside Manager::setMaps, stalling training at every resample,
reference: src/mgr.cpp:590-654): a thread pool compiles the NEXT batch's
worlds while the current batch trains, so that ``swap_data_batch`` finds
them in ``compile_world``'s cache.

``compile_world`` runs the native C++ compiler (``gpudrive_lab_torch.native``)
through ctypes, which releases the interpreter lock for the foreign call,
so the threads parse and compile beside the training loop's host code; the
numpy inverse actions and the Python around the call still take the lock
(with ``GPUDRIVE_TORCH_NO_NATIVE`` set, the whole compile does).  What the
overlap buys on the card is measured by ``chip_smoke.py``'s dataset and
ingest phases.
"""

from __future__ import annotations

import concurrent.futures
from typing import List, Optional

from gpudrive_lab_torch.core.types import Params
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.scene.compiler import compile_world


class PrefetchingSceneLoader:
    """Wraps a SceneDataLoader; ``next_batch()`` returns paths whose
    ``compile_world`` results are already cached, and at once begins
    compiling the following batch in the background."""

    def __init__(self, loader: SceneDataLoader, params: Params,
                 num_workers: int = 2):
        self.loader = loader
        self.params = params
        self._it = iter(loader)
        self._pool = concurrent.futures.ThreadPoolExecutor(num_workers)
        self._pending: Optional[tuple] = None
        self._kick()

    def _advance(self) -> List[str]:
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)

    def _kick(self):
        paths = self._advance()
        # pass the default `deleted` explicitly: lru_cache keys on the
        # literal arguments, and build_scene calls with three
        futures = [
            self._pool.submit(compile_world, p, self.params, frozenset())
            for p in paths
        ]
        self._pending = (paths, futures)

    def next_batch(self) -> List[str]:
        """Wait until the prefetched batch is compiled, return its paths,
        and start prefetching the next one."""
        paths, futures = self._pending
        for f in futures:
            f.result()  # fills compile_world's cache; raises its errors
        self._kick()
        return paths

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
