"""A reader and a writer of the ``.safetensors`` file format.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin
and end in the data section) with an optional ``__metadata__`` map of
strings, then the raw little-endian bytes of every tensor.  The writer lays
a file out as the ``safetensors`` package does (tensors by falling dtype
width and then by name, a compact header padded with spaces to 8 bytes), so
the two write the same bytes.  The port carries its own copy because
machines with only PyTorch lack that package.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Tuple

import torch

# name → dtype, in the order of the safetensors package's dtype enum (its
# writer sorts the tensors by this order, falling)
DTYPES = {
    "BOOL": torch.bool,
    "I8": torch.int8,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "F32": torch.float32,
    "I64": torch.int64,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
_RANK = {name: i for i, name in enumerate(DTYPES)}


def write(path: str, tensors: Dict[str, torch.Tensor], metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (moved to the CPU) and the string map ``metadata``
    to ``path``."""
    host = {}
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        host[name] = t.detach().to("cpu").contiguous()
    order = sorted(host, key=lambda n: (-_RANK[_NAMES[host[n].dtype]], n))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {k: str(metadata[k]) for k in sorted(metadata)}
    offset = 0
    for name in order:
        t = host[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in order:
            t = host[name]
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


def read(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """(tensors on the CPU, metadata) of a ``.safetensors`` file.  The
    tensors share one buffer holding the file's data section."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        start = 8 + n
        f.seek(0, 2)
        data = bytearray(f.tell() - start)
        f.seek(start)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: the data section is shorter than the file")
    metadata = header.pop("__metadata__", None) or {}
    tensors = {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read here")
        begin, end = info["data_offsets"]
        shape = info["shape"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * itemsize or end > len(data):
            raise ValueError(f"{path}: {name}'s data_offsets do not fit its shape")
        if count == 0:
            tensors[name] = torch.empty(shape, dtype=dtype)
            continue
        if begin % itemsize:  # torch views need aligned storage: copy this one
            buf, begin = bytearray(data[begin:end]), 0
        else:
            buf = data
        tensors[name] = torch.frombuffer(buf, dtype=dtype, count=count, offset=begin).reshape(shape)
    return tensors, metadata
