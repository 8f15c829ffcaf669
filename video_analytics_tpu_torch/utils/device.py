"""Device selection and the precision settings of the port.

TF32 is switched off for matrix products and cuDNN convolutions as soon
as the package is imported:

- flow needs full float32: ARCHITECTURE.md ("Flow precision") measured
  10x worse cv2 parity on the TPU with reduced-precision f32, and the
  pyramid resizes and preprocessing crop run as matrix products;
- the command line's CNN is float32, as the reference's (its commands
  build ``TwoStreamModel.create`` at the default ``dtype``;
  ``PipelineConfig.compute_dtype`` is read nowhere), and cuDNN would
  otherwise run f32 convolutions in TF32, which keeps about three decimal
  digits.

The reference's ``dtype=torch.bfloat16`` option (``models/resnet``,
``models/spynet``: bfloat16 activations, float32 parameters, cast in each
layer's ``forward``, no autocast) is untouched by these switches, which
concern float32 operands only.  cuBLAS may reduce bfloat16 products in
reduced precision (``allow_bf16_reduced_precision_reduction``, PyTorch's
default, True); it stays on: on the full-width bfloat16 ``fc`` (16×512
by 512×101, a split-K product) it changed nothing, the output equal to a
float64 sum rounded to bfloat16 (chip_smoke ``bf16``, on an NVIDIA H100
80GB HBM3 at 700 W).
"""

from __future__ import annotations

import subprocess
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


def card_name(device: Union[str, torch.device]) -> str:
    """The card's "name, power.limit" as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` reports them (its first line;
    ``torch.cuda.get_device_name`` where nvidia-smi cannot be run), the
    card and limit every timing is read beside; the device type ("cpu")
    off the GPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)
