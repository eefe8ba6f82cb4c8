"""Sequence windowing for training (port of
``pylidar_slam_tpu.dataset.sequence_dataset``).

``DatasetOfSequences`` windows `sequence_len` consecutive frames of each
underlying sequence into one example: the list of data_dicts plus stacked
arrays where the shapes allow.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


class DatasetOfSequences:
    """Concatenates windowed views over several map-style sequence datasets."""

    def __init__(self, sequence_len: int, datasets: List, sequence_ids=None,
                 transform: Optional[Callable] = None, stride: int = 1):
        self.sequence_len = sequence_len
        self.datasets = datasets
        self.sequence_ids = sequence_ids or [str(i) for i in range(len(datasets))]
        self.transform = transform or (lambda x: x)
        self.stride = stride
        self._index = []  # (dataset_idx, start_frame)
        for di, ds in enumerate(datasets):
            n_windows = (len(ds) - sequence_len) // stride + 1
            for k in range(max(n_windows, 0)):
                self._index.append((di, k * stride))

    def __len__(self):
        return len(self._index)

    def __getitem__(self, idx) -> dict:
        di, start = self._index[idx]
        ds = self.datasets[di]
        window = [self.transform(ds[start + k]) for k in range(self.sequence_len)]
        out: dict = {"window": window, "sequence_id": self.sequence_ids[di],
                     "start_index": start}
        # stackable numpy keys, stacked under the suffix _seq
        for key in set(window[0].keys()):
            values = [frame.get(key) for frame in window]
            if all(isinstance(v, np.ndarray) for v in values) and \
                    len({v.shape for v in values}) == 1:
                out[f"{key}_seq"] = np.stack(values)
        return out
