"""Device selection and the float32 precision settings of the port.

TF32 is switched off for matrix products and cuDNN convolutions as soon
as the package is imported:

- flow needs full float32: ARCHITECTURE.md ("Flow precision") measured
  10x worse cv2 parity on the TPU with reduced-precision f32, and the
  pyramid resizes and preprocessing crop run as matrix products;
- the serve CNN is float32 in the reference (``TwoStreamModel.create``
  defaults to ``dtype=jnp.float32``; ``PipelineConfig.compute_dtype`` is
  read nowhere), and cuDNN would otherwise run f32 convolutions in TF32,
  which keeps about three decimal digits.
"""

from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def require_cuda(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, raising when it names a CUDA device that
    this process cannot use.  Never falls back to the CPU: a run asked
    for the GPU either gets it or fails."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False (torch {torch.__version__}, CUDA "
                f"{torch.version.cuda})")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    return dev
