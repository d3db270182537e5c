"""Scene dataset iteration (port of ``gpudrive_lab_tpu/env/dataset.py``).

The reference's deterministic scene-batch iterator and selection disciplines
(reference: gpudrive/env/dataset.py:12-126,
gpudrive/env/scene_selector.py:8-94).  Both are host Python over
``random.Random``, so the port draws the same batches as the JAX package for
the same seed: ``__iter__`` redraws the index list (which consumes draws of
``random_gen`` even with replacement), and ``__next__`` with replacement
draws each batch from ``Random(seed + current_index)``.
"""

from __future__ import annotations

import dataclasses
import os
import random
from math import ceil
from typing import Iterator, List, Optional

from gpudrive_lab_torch.env.config import SceneConfig, SelectionDiscipline


@dataclasses.dataclass
class SceneDataLoader:
    """Deterministic batch iterator over scene JSON paths
    (reference: gpudrive/env/dataset.py:12-126)."""

    root: str
    batch_size: int
    dataset_size: int
    sample_with_replacement: bool = False
    file_prefix: str = "tfrecord"
    seed: int = 42
    shuffle: bool = False
    scene_nums: Optional[List[int]] = None

    def __post_init__(self):
        if not os.path.exists(self.root):
            raise FileNotFoundError(
                f"The specified path does not exist: {self.root}")
        self.random_gen = random.Random(self.seed)
        self.dataset = [
            os.path.join(self.root, scene)
            for scene in sorted(os.listdir(self.root))
            if scene.startswith(self.file_prefix)
        ]
        if not self.dataset:
            raise ValueError(
                f"no scene files starting with {self.file_prefix!r} in "
                f"{self.root} (the reference's WOMD naming convention, "
                "reference: gpudrive/env/dataset.py:13)"
            )
        self.dataset = self.dataset[: min(self.dataset_size,
                                          len(self.dataset))]
        if self.scene_nums is not None:
            # checked against the files present, not dataset_size
            if sorted(self.scene_nums)[-1] >= len(self.dataset):
                raise ValueError(
                    "scene_nums out of bounds for the "
                    f"{len(self.dataset)} scenes found"
                )
            self.dataset = [self.dataset[i] for i in self.scene_nums]
        # a directory with fewer files than a batch repeats them
        self.dataset_size = len(self.dataset)
        if len(self.dataset) < self.batch_size:
            repeat = (self.batch_size // max(len(self.dataset), 1)) + 1
            self.dataset = (self.dataset * repeat)[: self.batch_size]
        if self.shuffle:
            self.random_gen.shuffle(self.dataset)
        self._reset_indices()

    def _reset_indices(self):
        if self.sample_with_replacement:
            self.indices = [
                self.random_gen.randint(0, len(self.dataset) - 1)
                for _ in range(len(self.dataset))
            ]
        else:
            self.indices = list(range(len(self.dataset)))
        self.current_index = 0

    def __iter__(self) -> Iterator[List[str]]:
        self._reset_indices()
        return self

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __next__(self) -> List[str]:
        if self.sample_with_replacement:
            gen = random.Random(self.seed + self.current_index)
            batch_indices = [
                gen.randint(0, len(self.dataset) - 1)
                for _ in range(self.batch_size)
            ]
            self.current_index += 1
            return [self.dataset[i] for i in batch_indices]
        if self.current_index >= len(self.indices):
            raise StopIteration
        end = min(self.current_index + self.batch_size, len(self.indices))
        batch = [self.dataset[i]
                 for i in self.indices[self.current_index:end]]
        self.current_index = end
        return batch


def select_scenes(config: SceneConfig) -> List[str]:
    """reference: gpudrive/env/scene_selector.py:8-94."""
    if not (config.path and os.path.isdir(config.path)
            and os.listdir(config.path)):
        raise ValueError("The data directory does not exist or is empty.")
    all_scenes = [
        s for s in sorted(os.listdir(config.path)) if s.startswith("tfrecord")
    ]
    if not all_scenes:
        raise ValueError("The data directory contains no traffic scenes.")

    def random_sample(k):
        rand = random.Random(
            config.seed if config.seed is not None else 0x5CA1AB1E)
        return rand.sample(all_scenes, k)

    def repeat_to_n(scenes):
        return (scenes * ceil(config.num_scenes / len(scenes)))[
            : config.num_scenes]

    d = config.discipline
    if d == SelectionDiscipline.FIRST_N:
        selected = all_scenes[: config.num_scenes]
    elif d == SelectionDiscipline.RANDOM_N:
        selected = random_sample(config.num_scenes)
    elif d == SelectionDiscipline.PAD_N:
        selected = repeat_to_n(all_scenes)
    elif d == SelectionDiscipline.EXACT_N:
        if len(all_scenes) != config.num_scenes:
            raise ValueError(f"EXACT_N: {len(all_scenes)} scenes found, "
                             f"num_scenes={config.num_scenes}")
        selected = all_scenes
    elif d == SelectionDiscipline.K_UNIQUE_N:
        if not (config.k_unique_scenes and config.k_unique_scenes > 0):
            raise ValueError("K_UNIQUE_N needs k_unique_scenes > 0")
        selected = repeat_to_n(random_sample(config.k_unique_scenes))
    elif d == SelectionDiscipline.RANGE_N:
        selected = all_scenes[config.start_idx:
                              config.start_idx + config.num_scenes]
    else:  # CUSTOM_N
        selected = [all_scenes[i] for i in config.custom_idx]

    if not selected:
        raise ValueError("No scenes selected — check the data path.")
    return [os.path.join(os.path.abspath(config.path), s) for s in selected]
