"""UCF101 dataset plumbing: split lists, class index, clip records.

The port's own copy of ``video_analytics_tpu/io/dataset.py``.  UCF101
ships the annotation files ``classInd.txt`` (``<id> <ClassName>``,
1-indexed) and ``trainlist0{1,2,3}.txt`` / ``testlist0{1,2,3}.txt``
(``<Class>/<clip>.avi [label]``); ``eval-ucf101`` reports split-1 top-1
clip accuracy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class ClipRecord:
    path: str          # absolute path to the video file
    label: int         # 0-indexed class id
    class_name: str


def read_class_index(path: str) -> Dict[str, int]:
    """classInd.txt → {class_name: 0-indexed id}."""
    mapping = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            idx, name = line.split()
            mapping[name] = int(idx) - 1
    return mapping


def read_split_list(list_path: str, videos_root: str,
                    class_index: Dict[str, int]) -> List[ClipRecord]:
    """trainlist/testlist → ClipRecords.

    Train lists carry an explicit 1-indexed label column; test lists
    don't, so the label is derived from the ``<Class>/`` path prefix.
    """
    records = []
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            rel = parts[0]
            class_name = rel.split("/")[0]
            if len(parts) > 1:
                label = int(parts[1]) - 1
            else:
                label = class_index[class_name]
            records.append(ClipRecord(
                path=os.path.join(videos_root, rel),
                label=label, class_name=class_name))
    return records


@dataclasses.dataclass
class UCF101:
    """UCF101 dataset rooted at a videos dir + annotations dir."""

    videos_root: str
    annotations_root: str
    split: int = 1

    def __post_init__(self):
        self.class_index = read_class_index(
            os.path.join(self.annotations_root, "classInd.txt"))
        self.classes = [None] * len(self.class_index)
        for name, idx in self.class_index.items():
            self.classes[idx] = name

    def _list(self, which: str) -> List[ClipRecord]:
        path = os.path.join(self.annotations_root,
                            f"{which}list{self.split:02d}.txt")
        return read_split_list(path, self.videos_root, self.class_index)

    def train_records(self) -> List[ClipRecord]:
        return self._list("train")

    def test_records(self) -> List[ClipRecord]:
        return self._list("test")


class ProgressManifest:
    """Resumable progress of a long run: one line per completed clip, so
    a restarted run skips what is done."""

    def __init__(self, path: str):
        self.path = path
        self._done = set()
        if os.path.exists(path):
            with open(path) as f:
                self._done = {line.strip() for line in f if line.strip()}

    def is_done(self, key: str) -> bool:
        return key in self._done

    def mark_done(self, key: str) -> None:
        if key in self._done:
            return
        self._done.add(key)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(key + "\n")

    def __len__(self) -> int:
        return len(self._done)
