"""The safetensors file layout, read and written with torch alone.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of
JSON (``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...,
"__metadata__": {str: str}}``, padded with spaces so the data starts
8-byte aligned), then the tensors' raw little-endian bytes, each at its
offsets from the start of the data. It is the format of Hugging Face's
``safetensors`` package (``model.safetensors``, sharded as
``model.safetensors.index.json`` + shards), which this module does not
need: the machine that runs the port may not have it, and numpy there
has no bfloat16, so tensors go from the file to the model as ``torch``
tensors of the file's dtype, never through a float32 copy.

:func:`load_file` maps the file (``mmap``, copy-on-write) and returns
tensors that view it (no read until a tensor is touched);
:func:`save_file` writes a dict of tensors; :class:`StreamWriter` writes
tensors one at a time from a header fixed up front (a checkpoint writes
each leaf as it is gathered, holding one leaf on the host at a time) and
keeps the CRC32 of what it wrote. Tensors are laid out by element size,
largest first, then by name (what ``safetensors`` does), so every tensor
starts aligned to its element size.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}
NAMES: Dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"
_ALIGN = 8


def _nbytes(dtype: torch.dtype, shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def _raw(t: torch.Tensor) -> memoryview:
    """The bytes of a tensor on the host (C order), any dtype."""
    t = t.detach().cpu().contiguous().reshape(-1)
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.view(torch.uint8).numpy())


def _header(entries: Iterable[Tuple[str, torch.dtype, Tuple[int, ...]]],
            metadata: Optional[Mapping[str, str]]) -> Tuple[bytes, list]:
    """(the length-prefixed padded header, [(name, begin, end)] in write
    order)."""
    entries = sorted(entries, key=lambda e: (
        -torch.empty((), dtype=e[1]).element_size(), e[0]))
    head: Dict[str, object] = {}
    if metadata:
        head["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    order, off = [], 0
    for name, dtype, shape in entries:
        if dtype not in NAMES:
            raise ValueError(f"{name}: dtype {dtype} has no safetensors name")
        n = _nbytes(dtype, shape)
        head[name] = {"dtype": NAMES[dtype], "shape": [int(s) for s in shape],
                      "data_offsets": [off, off + n]}
        order.append((name, off, off + n))
        off += n
    raw = json.dumps(head, separators=(",", ":")).encode()
    raw += b" " * (-(8 + len(raw)) % _ALIGN)
    return struct.pack("<Q", len(raw)) + raw, order


def write_order(specs: Iterable[Tuple[str, torch.dtype, Tuple[int, ...]]]
                ) -> List[str]:
    """The order in which a file of these (name, dtype, shape) tensors
    holds them (and :class:`StreamWriter` takes them)."""
    return [name for name, _, _ in _header(specs, None)[1]]


class StreamWriter:
    """Write one safetensors file tensor by tensor: ``specs`` (name,
    dtype, shape) fix the header; :meth:`write` then takes each tensor in
    the order of :attr:`names`. :attr:`crc32` and :attr:`size` describe
    the bytes written (the checkpoint manifest's entry)."""

    def __init__(self, path: str,
                 specs: Iterable[Tuple[str, torch.dtype, Tuple[int, ...]]],
                 metadata: Optional[Mapping[str, str]] = None):
        specs = list(specs)
        head, self._order = _header(specs, metadata)
        self.names = [name for name, _, _ in self._order]
        self._shapes = {name: (dtype, tuple(shape))
                        for name, dtype, shape in specs}
        self._f = open(path, "wb")
        self.crc32 = 0
        self.size = 0
        self._next = 0
        # the checksum runs on one worker thread, in write order, while
        # this thread writes (both release the GIL on large buffers)
        self._crc = ThreadPoolExecutor(1, thread_name_prefix="dst-crc")
        self._pending: List[Future] = []
        self._put(head)

    def _update(self, b) -> None:
        self.crc32 = zlib.crc32(b, self.crc32)

    def _put(self, b) -> None:
        self._f.write(b)
        self._pending.append(self._crc.submit(self._update, b))
        self.size += len(b)

    def write(self, name: str, t: torch.Tensor) -> None:
        want, _, _ = self._order[self._next]
        if name != want:
            raise ValueError(f"tensor '{name}' written where '{want}' is due")
        dtype, shape = self._shapes[name]
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} written "
                             f"where the header has {dtype} {shape}")
        self._put(_raw(t))
        self._next += 1

    def close(self, fsync: bool = True) -> None:
        try:
            if self._next != len(self._order):
                raise ValueError(f"{len(self._order) - self._next} tensors "
                                 f"of the header were never written")
            self._f.flush()
            if fsync:
                os.fsync(self._f.fileno())
            for f in self._pending:
                f.result()
        finally:
            self._f.close()
            self._crc.shutdown(wait=True)
        self._pending.clear()
        self.crc32 &= 0xFFFFFFFF


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None,
              fsync: bool = False) -> Tuple[int, int]:
    """Write ``tensors`` to ``path``; returns (size, crc32) of the file."""
    w = StreamWriter(path, [(n, t.dtype, tuple(t.shape))
                            for n, t in tensors.items()], metadata)
    for name in w.names:
        w.write(name, tensors[name])
    w.close(fsync=fsync)
    return w.size, w.crc32


def read_header(path: str) -> Tuple[int, dict]:
    """(data start, header dict) of a safetensors file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (short)")
        (n,) = struct.unpack("<Q", raw)
        head = json.loads(f.read(n))
    return 8 + n, head


def load_file(path: str, names: Optional[Iterable[str]] = None,
              device=None) -> Dict[str, torch.Tensor]:
    """The tensors of ``path`` (``names`` only, if given) in the file's
    dtypes: CPU tensors viewing a copy-on-write map of the file, or
    copies on ``device``. ``metadata(path)`` reads ``__metadata__``."""
    start, head = read_header(path)
    head.pop("__metadata__", None)
    keys = list(head) if names is None else list(names)
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) \
            if size > 0 else None
    for name in keys:
        info = head[name]
        dtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        b, e = info["data_offsets"]
        if e - b != _nbytes(dtype, shape) or start + e > size:
            raise ValueError(f"{path}: tensor '{name}' has offsets {b}-{e} "
                             f"for {dtype} {shape} in a {size}-byte file")
        if e == b:
            t = torch.empty(shape, dtype=dtype)
        else:
            item = torch.empty((), dtype=dtype).element_size()
            if (start + b) % item == 0:
                t = torch.frombuffer(mm, dtype=dtype, count=(e - b) // item,
                                     offset=start + b)
            else:   # a writer that did not align: copy the bytes
                t = torch.frombuffer(mm, dtype=torch.uint8, count=e - b,
                                     offset=start + b).clone().view(dtype)
            t = t.reshape(shape)
        out[name] = t if device is None else t.to(device)
    return out


def metadata(path: str) -> Dict[str, str]:
    return dict(read_header(path)[1].get("__metadata__") or {})


def save_sharded(tensors: Mapping[str, torch.Tensor], out_dir: str,
                 max_shard_bytes: int,
                 metadata_: Optional[Mapping[str, str]] = None) -> List[str]:
    """Write ``tensors`` as ``model-0000i-of-0000n.safetensors`` shards of
    at most ``max_shard_bytes`` (a tensor larger than that gets a shard
    of its own) and ``model.safetensors.index.json``; tensors keep their
    order in ``tensors``. Returns the shard file names."""
    groups: List[List[str]] = [[]]
    used = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        if groups[-1] and used + n > max_shard_bytes:
            groups.append([])
            used = 0
        groups[-1].append(name)
        used += n
    files = [f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
             for i in range(len(groups))]
    weight_map, total = {}, 0
    for fname, names in zip(files, groups):
        save_file({n: tensors[n] for n in names},
                  os.path.join(out_dir, fname), metadata_ or {"format": "pt"})
        for n in names:
            weight_map[n] = fname
            total += tensors[n].numel() * tensors[n].element_size()
    with open(os.path.join(out_dir, INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return files


def crc32_of(path: str, chunk: int = 1 << 24) -> int:
    """CRC32 of a file's bytes, read ``chunk`` at a time."""
    crc = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF
