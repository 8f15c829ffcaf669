"""Build and load the port's CUDA kernels.

All sources in ``video_analytics_tpu_torch/csrc/`` go through ``nvcc``
(one process per source, all started together, then one link) into one
shared library with a plain C interface, for ``sm_90a`` (Hopper), which
is loaded with ``ctypes``.  Nothing includes PyTorch's headers, so the
build takes seconds.  It runs at first use, from the
checkout's sources only, into ``video_analytics_tpu_torch/_build/<key>/``
(listed in ``.gitignore``), where ``<key>`` hashes the sources, the
generated median network and the flags: an edit rebuilds, an unchanged
tree reuses the library.  A failed build raises with nvcc's output.

Nothing here runs at import: ``nvcc`` and ``ctypes`` are touched only by
``library()``, which the kernel wrappers call when they launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("warp_prep.cu", "tvl1_pd.cu", "median.cu", "fb_prologue.cu",
           "fb_warp_neq.cu", "sep_corr.cu", "fb_window_solve.cu",
           "tvl1_pd_chunk.cu", "tvl1_pd_warp.cu", "bn_act.cu",
           "short_attn.cu")
HEADERS = ("common.cuh", "fb_neq.cuh")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every entry point of the library (csrc/*.cu).
_SIGNATURES = {
    "va_warp_prep": (_P, _P, _P, _P, _I, _I, _I, _P),
    "va_pd_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                   _F, _P),
    "va_median": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
    "va_fb_prologue": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                       _P, _P, _F, _F, _F, _F, _I, _P),
    "va_fb_prologue_smem": (_I, _I, _I, _I, _I),
    "va_fb_warp_neq": (_P, _P, _P, _P, _I, _I, _I, _P, _P),
    "va_sep_corr": (_P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _P),
    "va_sep_corr_smem": (_I,),
    "va_pd_chunk": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _I, _I, _F, _F, _F, _F, _I, _P),
    "va_pd_scale": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                    _F, _F, _F, _P),
    "va_fb_window_solve": (_P, _P, _I, _I, _I, _P, _P, _I, _P),
    "va_fb_iteration": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P),
    "va_fb_window_smem": (_I, _I),
    "va_pd_scale_smem": (_I, _I, _I),
    "va_pd_warp_max_clusters": (_I, _I, _I, _I),
    "va_bn_act": (_P, _P, _P, _P, _P, _P, _F, _L, _I, _I, _I, _P),
    "va_short_attn": (_P, _P, _P, _I, _I, _I, _P),
    "va_error_string": (_I,),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}


def median_network_header() -> str:
    """C source of ``va_median9`` / ``va_median25`` (the pruned selection
    networks of ``ops.median._median_network``, unrolled; the in-kernel
    medians of the TV-L1 solvers) and of ``va_median_tile3`` /
    ``va_median_tile5`` (the tile schedules of
    ``ops.median.separable_median_schedule``, which csrc/median.cu runs)."""
    from video_analytics_tpu_torch.ops.median import (
        MEDIAN_TILE, _median_network, separable_median_schedule)
    lines = ["// Generated by video_analytics_tpu_torch/ops/cuda/_build.py",
             "// from ops/median._median_network and",
             "// ops/median.separable_median_schedule; do not edit.",
             "#pragma once", ""]
    for k2 in (9, 25):
        network, wire = _median_network(k2)
        lines.append(f"__device__ __forceinline__ float va_median{k2}"
                     f"(float* w) {{")
        for i, j in network:
            if j < 0:
                lines.append(f"  w[{i}] = w[{-1 - j}];")
            else:
                lines.append(f"  {{ const float lo = fminf(w[{i}], w[{j}]);"
                             f" const float hi = fmaxf(w[{i}], w[{j}]);"
                             f" w[{i}] = lo; w[{j}] = hi; }}")
        lines.append(f"  return w[{wire}];")
        lines.append("}")
        lines.append("")
    th, tw = MEDIAN_TILE
    lines += [f"#define VA_MEDIAN_TILE_ROWS {th}",
              f"#define VA_MEDIAN_TILE_COLS {tw}", ""]
    for k in (3, 5):
        rows, cols, ops, outputs = separable_median_schedule(k)
        n_in = rows * cols

        def name(wire: int) -> str:
            return f"v[{wire}]" if wire < n_in else f"t{wire}"

        batcher = 2 * sum(j >= 0 for _, j in _median_network(k * k)[0])
        lines += [f"// k = {k}: the medians of a {th} x {tw} tile of outputs "
                  f"from its {rows} x {cols}",
                  f"// inputs v (row-major) into o (row-major): {len(ops)} "
                  f"min/max, {len(ops) / (th * tw):g} an output",
                  f"// (va_median{k * k}: {batcher}).",
                  f"__device__ __forceinline__ void va_median_tile{k}"
                  f"(const float* v, float* o) {{"]
        for kind, out, a, b in ops:
            fn = "fminf" if kind == "min" else "fmaxf"
            lines.append(f"  const float t{out} = {fn}({name(a)}, {name(b)});")
        lines += [f"  o[{i}] = {name(wire)};"
                  for i, wire in enumerate(outputs)]
        lines += ["}", ""]
    return "\n".join(lines)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin:"
                           " the CUDA kernels cannot be built")
    return path


def _key(header: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(header.encode())
    h.update(" ".join((ARCH,) + FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out_dir: str, header: str) -> str:
    lib_path = os.path.join(out_dir, "libva_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "median_network.h"), "w") as f:
        f.write(header)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as obj_dir:
        objects = [os.path.join(obj_dir, s[:-3] + ".o") for s in SOURCES]
        cmds = [[nvcc, ARCH, *FLAGS, "-I", CSRC, "-I", out_dir, "-c", "-o",
                 obj, os.path.join(CSRC, src)]
                for src, obj in zip(SOURCES, objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outputs = [proc.communicate()[0] for proc in procs]
        failed = [i for i, proc in enumerate(procs) if proc.returncode != 0]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        if not failed:
            cmds.append([nvcc, ARCH, "-shared", "-o", tmp, *objects])
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            outputs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed = [len(cmds) - 1]
    seconds = time.perf_counter() - t0
    log = "\n".join(" ".join(cmd) + "\n" + text
                    for cmd, text in zip(cmds, outputs))
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
        f.write(log)
    if failed:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            " ".join(cmds[i]) + "\n" + outputs[i] for i in failed))
    os.replace(tmp, lib_path)   # atomic: a concurrent process sees all or none
    build_info.update(seconds=seconds, log=log)
    return lib_path


def build_dir() -> str:
    """The directory that holds (or will hold) the library built from the
    checkout's sources: ``_build/<key>/``."""
    return os.path.join(BUILD_ROOT, _key(median_network_header()))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            header = median_network_header()
            out_dir = os.path.join(BUILD_ROOT, _key(header))
            path = _compile(out_dir, header)
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.va_error_string.restype = ctypes.c_char_p
            build_info.setdefault("seconds", 0.0)
            build_info["path"] = path
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().va_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


GRID_YZ_MAX = 65535    # blocks a CUDA grid holds along y and along z


def expect_grid_batch(n: int, what: str) -> None:
    """Raise ValueError where `n`, the count a launch puts on its grid's
    y or z dimension (images, frames or planes of a batch), passes the
    65,535 that dimension holds: the launch would fail with a CUDA error
    instead of computing the batch."""
    if n > GRID_YZ_MAX:
        raise ValueError(f"{what}: a batch of {n} puts {n} blocks on a grid "
                         f"dimension that holds {GRID_YZ_MAX}; split the "
                         f"batch")


def expect(t, name: str, shape, device) -> None:
    """Raise unless `t` is a contiguous float32 tensor of `shape` on
    `device`: what every kernel wrapper takes, checked before a pointer
    goes to C."""
    import torch
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
