"""UCF101 annotation files: the class index.

The port's own copy of what it uses from
``video_analytics_tpu/io/dataset.py``.  UCF101 ships ``classInd.txt``
with one ``<id> <ClassName>`` per line, 1-indexed.
"""

from __future__ import annotations

from typing import Dict


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
