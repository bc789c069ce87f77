"""Subject-level split manager with persistence (the port's own copy of
multimodal_neuroimage_tpu/data/splits.py: the same file format and the same
permutation, so either package reads the other's split files).

* split by SUBJECT into train/val/test with ``train_split``/``val_split``
  fractions, a ``numpy.random.default_rng(seed)`` permutation;
* persist to ``splits/<dataset_name>/seed_<seed>.txt`` in the reference's
  text format ('train_subjects' header line, then one subject per line,
  then 'val_subjects', 'test_subjects');
* an existing split file always wins over a new draw, so runs are
  resumable and comparable.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


class SplitManager:
    def __init__(self, base_path: str, dataset_name: str, seed: int,
                 train_split: float = 0.7, val_split: float = 0.15):
        self.folder = os.path.join(base_path, "splits", dataset_name)
        os.makedirs(self.folder, exist_ok=True)
        self.path = os.path.join(self.folder, f"seed_{seed}.txt")
        self.seed = seed
        self.train_split = train_split
        self.val_split = val_split

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, train: Sequence[str], val: Sequence[str],
             test: Sequence[str]) -> None:
        with open(self.path, "w") as f:
            for name, subj_list in (("train_subjects", train),
                                    ("val_subjects", val),
                                    ("test_subjects", test)):
                f.write(name + "\n")
                for s in subj_list:
                    f.write(str(s) + "\n")

    def load(self) -> Tuple[List[str], List[str], List[str]]:
        """Reference text format parse (dataloaders.py:173-182)."""
        with open(self.path) as f:
            lines = [ln.rstrip("\n") for ln in f.readlines()]
        ti = next(i for i, ln in enumerate(lines) if "train" in ln)
        vi = next(i for i, ln in enumerate(lines) if "val" in ln)
        si = next(i for i, ln in enumerate(lines) if "test" in ln)
        return lines[ti + 1:vi], lines[vi + 1:si], lines[si + 1:]

    def split(self, subjects: Sequence[str]
              ) -> Tuple[List[str], List[str], List[str]]:
        """Load the persisted split if present, else draw and persist a new
        subject-level random split (dataloaders.py:158-171)."""
        if self.exists():
            train, val, test = self.load()
            known = set(map(str, subjects))
            return ([s for s in train if s in known],
                    [s for s in val if s in known],
                    [s for s in test if s in known])
        subjects = list(map(str, subjects))
        S = len(subjects)
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(S)
        n_train = int(S * self.train_split)
        n_val = int(S * self.val_split)
        train = [subjects[i] for i in perm[:n_train]]
        val = [subjects[i] for i in perm[n_train:n_train + n_val]]
        test = [subjects[i] for i in perm[n_train + n_val:]]
        self.save(train, val, test)
        return train, val, test
