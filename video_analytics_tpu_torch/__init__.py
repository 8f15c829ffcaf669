"""video_analytics_tpu_torch — the PyTorch/CUDA port of video_analytics_tpu.

The JAX package beside it is the reference: this package mirrors its
layout and names module for module (``flow/tvl1.py`` ↔
``flow/tvl1.py``, ``runtime/serve.py`` ↔ ``runtime/serve.py``), runs
plain tensor code in PyTorch, and runs every computation that the JAX
package wrote as a Pallas TPU kernel as a CUDA kernel written by hand for
Hopper (``csrc/``, built by ``ops/cuda/_build.py`` at first use).

Ported so far: the two-stream serve path (TV-L1 or Farneback flow, two
ResNets, late fusion, the ``ClipServer`` line protocol: ``tpuva-torch
serve``) and the stage chain ``extract-frames`` → ``compute-flow`` (at the
native resolution) → ``extract-features`` / ``classify-clip``, with
checkpoints in the reference's msgpack format; the UCF101 evaluation
``eval-ucf101`` (sequential and batched, threaded decode) on the synthetic
UCF101 or the real one, and ``convert-weights``.

Importing this package imports no JAX and nothing of the JAX package: it
keeps its own copies of the configuration dataclasses (``config.py``) and
of the host-side video and flow I/O (``io/``).
"""

__version__ = "0.1.0"

from video_analytics_tpu_torch.utils import device as _device  # noqa: F401  (TF32 off)
