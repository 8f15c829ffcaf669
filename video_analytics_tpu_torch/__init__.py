"""video_analytics_tpu_torch — the PyTorch/CUDA port of video_analytics_tpu.

The JAX package beside it is the reference: this package mirrors its
layout and names module for module (``flow/tvl1.py`` ↔
``flow/tvl1.py``, ``runtime/serve.py`` ↔ ``runtime/serve.py``), runs
plain tensor code in PyTorch, and runs every computation that the JAX
package wrote as a Pallas TPU kernel as a CUDA kernel written by hand for
Hopper (``csrc/``, built by ``ops/cuda/_build.py`` at first use).

The port covers every module of the JAX package but the few names
``tests/test_torch_surface.py`` lists as not ported, each with its
reason: the two-stream serve path (TV-L1, Farneback or the learned SpyNet
flow, two ResNets, late fusion, the ``ClipServer`` line protocol:
``tpuva-torch serve``), the stage chain ``extract-frames`` →
``compute-flow`` → ``extract-features`` / ``classify-clip`` (also as the
console scripts ``extract-frames-torch`` ...), checkpoints in the
reference's msgpack format and their asynchronous writer, the UCF101
evaluation ``eval-ucf101``, ``convert-weights``, ``train``, ``warmup``,
several processes with the model axis (``parallel/mesh.py``), the
sliding windows of a long clip and the metrics sinks.  Each subpackage's
``__init__`` re-exports what the reference's does; the root, the
configuration dataclasses.

Importing this package imports no JAX and nothing of the JAX package: it
keeps its own copies of the configuration dataclasses (``config.py``) and
of the host-side video and flow I/O (``io/``).
"""

__version__ = "0.1.0"

from video_analytics_tpu_torch.utils import device as _device  # noqa: F401  (TF32 off)
from video_analytics_tpu_torch.config import (  # noqa: F401
    FarnebackConfig,
    TVL1Config,
    PreprocessConfig,
    PipelineConfig,
)
