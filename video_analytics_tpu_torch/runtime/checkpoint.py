"""Checkpoints in the reference's file format.

Port of ``save_variables`` / ``load_variables`` of
``video_analytics_tpu/runtime/checkpoint.py``: one portable file, written
with an atomic replace, in the flax msgpack format
(``flax.serialization.to_bytes`` of the variable tree).  A file written
by either package loads in the other; together with
``models/convert.flax_to_torch`` / ``torch_to_flax`` this is how weights
cross between them.

The format is msgpack: nested maps with string keys whose array leaves
are extension type 1, itself the msgpack of ``(shape, dtype name, raw
row-major bytes)``; numpy scalars are extension type 3 in the same
encoding; a leaf above 2³⁰ bytes is a map ``{"__msgpack_chunked_array__":
True, "shape": {"0": ...}, "chunks": {"0": ...}}`` of flat pieces.  This
module carries its own small reader and writer of the msgpack subset
that needs (no ``flax`` or ``msgpack`` package is imported).

``AsyncCheckpointer`` is the counterpart of the reference's orbax-backed
one: the same contract (a save that returns once the tree is on the host,
the write on a background thread, ``.prev`` rotation, a torn-save
fallback, restore into a template's placement) in the port's own format,
one msgpack file in a directory committed by an atomic rename.
"""

from __future__ import annotations

import os
import shutil
import struct
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_CHUNK_BYTES = 2 ** 30


# -- writer -----------------------------------------------------------------

def _pack_uint(n: int) -> bytes:
    if n < 0x80:
        return struct.pack("B", n)
    if n < 1 << 8:
        return b"\xcc" + struct.pack("B", n)
    if n < 1 << 16:
        return b"\xcd" + struct.pack(">H", n)
    if n < 1 << 32:
        return b"\xce" + struct.pack(">I", n)
    return b"\xcf" + struct.pack(">Q", n)


def _pack_int(n: int) -> bytes:
    if n >= 0:
        return _pack_uint(n)
    if n >= -32:
        return struct.pack("b", n)
    if n >= -(1 << 7):
        return b"\xd0" + struct.pack("b", n)
    if n >= -(1 << 15):
        return b"\xd1" + struct.pack(">h", n)
    if n >= -(1 << 31):
        return b"\xd2" + struct.pack(">i", n)
    return b"\xd3" + struct.pack(">q", n)


def _pack_str(s: str) -> bytes:
    data = s.encode("utf-8")
    n = len(data)
    if n < 32:
        head = struct.pack("B", 0xa0 | n)
    elif n < 1 << 8:
        head = b"\xd9" + struct.pack("B", n)
    elif n < 1 << 16:
        head = b"\xda" + struct.pack(">H", n)
    else:
        head = b"\xdb" + struct.pack(">I", n)
    return head + data


def _pack_bin(data: bytes) -> bytes:
    n = len(data)
    if n < 1 << 8:
        head = b"\xc4" + struct.pack("B", n)
    elif n < 1 << 16:
        head = b"\xc5" + struct.pack(">H", n)
    else:
        head = b"\xc6" + struct.pack(">I", n)
    return head + data


def _pack_array_header(n: int) -> bytes:
    if n < 16:
        return struct.pack("B", 0x90 | n)
    if n < 1 << 16:
        return b"\xdc" + struct.pack(">H", n)
    return b"\xdd" + struct.pack(">I", n)


def _pack_map_header(n: int) -> bytes:
    if n < 16:
        return struct.pack("B", 0x80 | n)
    if n < 1 << 16:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
    if n in fixed:
        head = fixed[n]
    elif n < 1 << 8:
        head = b"\xc7" + struct.pack("B", n)
    elif n < 1 << 16:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack("b", code) + data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured arrays cannot be saved")
    return (_pack_array_header(3)
            + _pack_array_header(arr.ndim)
            + b"".join(_pack_int(int(d)) for d in arr.shape)
            + _pack_str(arr.dtype.name)
            + _pack_bin(arr.tobytes("C")))


def _as_array(x) -> Optional[np.ndarray]:
    """x as a numpy array if it is an array leaf (numpy, or anything with
    ``detach``/``cpu``/``numpy``, i.e. a torch tensor), else None."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach") and hasattr(x, "numpy"):
        return x.detach().cpu().numpy()
    return None


def _pack(x) -> bytes:
    arr = _as_array(x)
    if arr is not None:
        if arr.nbytes > _MAX_CHUNK_BYTES:
            per = max(1, _MAX_CHUNK_BYTES // arr.dtype.itemsize)
            flat = arr.reshape(-1)
            return _pack({
                _CHUNKED: True,
                "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
                "chunks": {str(i): flat[s:s + per] for i, s in
                           enumerate(range(0, flat.size, per))}})
        return _pack_ext(_EXT_NDARRAY, _ndarray_payload(arr))
    if isinstance(x, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    if isinstance(x, Mapping):
        out = [_pack_map_header(len(x))]
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"checkpoint keys must be str, got {k!r}")
            out.append(_pack_str(k))
            out.append(_pack(v))
        return b"".join(out)
    if x is None:
        return b"\xc0"
    if isinstance(x, bool):
        return b"\xc3" if x else b"\xc2"
    if isinstance(x, int):
        return _pack_int(x)
    if isinstance(x, float):
        return b"\xcb" + struct.pack(">d", x)
    if isinstance(x, str):
        return _pack_str(x)
    if isinstance(x, (list, tuple)):
        # flax stores sequences as maps keyed "0", "1", ...
        return _pack({str(i): v for i, v in enumerate(x)})
    raise TypeError(f"cannot save a {type(x).__name__} in a checkpoint")


# -- reader -----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated checkpoint")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.num("B")
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode("utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: "B", 0xcd: ">H", 0xce: ">I",
                   0xcf: ">Q", 0xd0: "b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.num(numbers[b])
        sizes = {0xc4: "B", 0xc5: ">H", 0xc6: ">I"}
        if b in sizes:
            return bytes(self.take(self.num(sizes[b])))
        sizes = {0xd9: "B", 0xda: ">H", 0xdb: ">I"}
        if b in sizes:
            return bytes(self.take(self.num(sizes[b]))).decode("utf-8")
        if b in (0xdc, 0xdd):
            return [self.read()
                    for _ in range(self.num(">H" if b == 0xdc else ">I"))]
        if b in (0xde, 0xdf):
            return self.map(self.num(">H" if b == 0xde else ">I"))
        fixed = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixed:
            return self.ext(fixed[b])
        sizes = {0xc7: "B", 0xc8: ">H", 0xc9: ">I"}
        if b in sizes:
            return self.ext(self.num(sizes[b]))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.num("b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, raw = _Reader(payload).read()
        if isinstance(dtype, bytes):
            dtype = dtype.decode("ascii")
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _restore(template, state, path: Tuple[str, ...]):
    """`state` checked against `template`'s structure and shapes, as
    ``flax.serialization.from_state_dict`` checks the keys."""
    where = "/".join(path) or "<root>"
    if isinstance(template, Mapping):
        if not isinstance(state, dict) or set(state) != set(template):
            got = sorted(state) if isinstance(state, dict) else type(state)
            raise ValueError(f"checkpoint does not match the model at "
                             f"{where}: expected keys {sorted(template)}, "
                             f"got {got}")
        return {k: _restore(template[k], state[k], path + (k,))
                for k in template}
    if isinstance(template, np.ndarray) or hasattr(template, "detach"):
        want = tuple(template.shape)     # no copy of a device tensor
        if not isinstance(state, np.ndarray) or state.shape != want:
            raise ValueError(f"checkpoint does not match the model at "
                             f"{where}: expected shape {want}, got "
                             f"{getattr(state, 'shape', type(state))}")
    return state


# -- the two functions --------------------------------------------------------

def save_variables(path: str, variables: Mapping[str, Any]) -> None:
    """Write a variable tree (nested dicts with numpy or torch leaves) as
    one flax-msgpack file, replacing `path` atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = _pack(variables)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)  # atomic: no torn checkpoints on crash


def load_variables(path: str, template: Optional[Mapping[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Read a checkpoint → nested dicts with numpy leaves.  With
    `template` (e.g. ``TwoStreamModel.flax_variables()`` of a freshly made
    model) the file's structure and leaf shapes must match it."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    tree = _unchunk(reader.read())
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} trailing bytes")
    if template is not None:
        tree = _restore(template, tree, ())
    return tree


# -- asynchronous saves ---------------------------------------------------------

class _Torn(Exception):
    """A checkpoint directory without a whole, readable file."""


def _stage(tree: Any) -> Any:
    """`tree` with every array leaf copied to host memory the caller does
    not hold: CUDA tensors into pinned buffers by copies queued on their
    device's current stream, then one event a device waited for; CPU
    tensors and numpy arrays copied.  Array leaves come back as numpy
    arrays; other leaves as they are."""
    devices = set()

    def walk(x: Any) -> Any:
        if isinstance(x, Mapping):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
                devices.add(x.device)
                return buf.numpy()
            return x.numpy().copy()
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    staged = walk(tree)
    for dev in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()
    return staged


def _place(template: Any, state: Any) -> Any:
    """`state` (checked against `template`) with each leaf placed as the
    template's: a tensor on its device with its dtype, a numpy array with
    its dtype, anything else as read."""
    if isinstance(template, Mapping):
        return {k: _place(template[k], state[k]) for k in template}
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(state)).to(template.device,
                                                    template.dtype)
    if isinstance(template, np.ndarray):
        return np.array(state, dtype=template.dtype)
    return state


class AsyncCheckpointer:
    """Asynchronous checkpoints for long training runs.

    ``save(path, tree)`` returns once every array leaf of `tree` (CUDA
    tensors, CPU tensors, numpy arrays in nested dicts) has been copied to
    host memory, so the caller may change its parameters in the next
    step; serialising and writing happen on one background thread.
    ``restore(path, template)`` returns `template`'s structure with each
    leaf where the template's is: on its device, with its dtype (the
    counterpart of the reference's restore-to-sharding).

    Layout: a directory at `path` holding one file, ``variables.msgpack``,
    in the flax msgpack format of ``save_variables`` (the reference's
    ``load_variables`` reads it).  The directory is not orbax's format.  A
    save writes ``<path>.tmp`` and renames it to `path`, so a directory at
    `path` is whole unless its file was cut short by a crash after the
    rename.

    As in the reference: one save in flight per checkpointer (a save waits
    for the one before); the committed previous checkpoint is rotated to
    ``<path>.prev`` before a new write starts (``keep_previous``), and
    ``restore`` falls back to it, with a ``RuntimeWarning``, only when the
    primary is missing or torn; any other failure raises.  An error of the
    background write is raised by the next ``wait()``, ``save()`` or
    ``close()``.  ``wait()`` (or leaving a ``with`` block) must run before
    the process ends, or the last save may not be written.
    """

    FILE = "variables.msgpack"

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="checkpoint")
        self._pending: Optional[Future] = None

    def save(self, path: str, tree: Any, keep_previous: bool = True) -> None:
        path = os.path.abspath(path)
        self.wait()
        staged = _stage(tree)
        if keep_previous and os.path.isdir(path):
            prev = path + ".prev"
            if os.path.isdir(prev):
                shutil.rmtree(prev)
            os.replace(path, prev)
        self._pending = self._pool.submit(self._write, path, staged)

    def _write(self, path: str, tree: Any) -> None:
        """Serialise `tree` into ``<path>.tmp/variables.msgpack`` and
        rename the directory to `path` (on the background thread)."""
        tmp = path + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, self.FILE), "wb") as f:
            f.write(_pack(tree))
        if os.path.isdir(path):
            shutil.rmtree(path)          # keep_previous=False
        os.replace(tmp, path)

    def _read(self, path: str) -> Any:
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        try:
            return load_variables(os.path.join(path, self.FILE))
        except (FileNotFoundError, ValueError) as e:
            raise _Torn(f"torn checkpoint {path}: {e}") from e

    def restore(self, path: str, template: Any) -> Any:
        path = os.path.abspath(path)
        self.wait()
        try:
            state = self._read(path)
        except (FileNotFoundError, _Torn) as e:
            prev = path + ".prev"
            if not os.path.isdir(prev):
                raise
            warnings.warn(
                f"primary checkpoint {path} missing or torn ({e}); "
                f"restoring rotated previous checkpoint {prev}",
                RuntimeWarning)
            state = self._read(prev)
        return _place(template, _restore(template, state, ()))

    def wait(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
