"""video_analytics_tpu_torch — the PyTorch/CUDA port of video_analytics_tpu.

The JAX package beside it is the reference: this package mirrors its
layout and names module for module (``flow/tvl1.py`` ↔
``flow/tvl1.py``, ``runtime/serve.py`` ↔ ``runtime/serve.py``), runs
plain tensor code in PyTorch, and runs every computation that the JAX
package wrote as a Pallas TPU kernel as a CUDA kernel written by hand for
Hopper (``csrc/``, built by ``ops/cuda/_build.py`` at first use).

The slice ported so far is the two-stream serve path under
``PipelineConfig()``: TV-L1 flow, two ResNet-18s, late fusion, and the
``ClipServer`` line protocol (``tpuva-torch serve``).

Importing this package imports no JAX; the configuration dataclasses
are shared with the JAX package (``video_analytics_tpu_torch.config``).
"""

__version__ = "0.1.0"

from video_analytics_tpu_torch.utils import device as _device  # noqa: F401  (TF32 off)
