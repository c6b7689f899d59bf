"""The safetensors file format, read and written by hand (the card's
machine has no ``safetensors`` package).

A file is an 8-byte little-endian header length, a JSON header mapping
each name to its dtype, shape and byte range (padded with spaces to a
multiple of 8 bytes), then the raw little-endian data of every tensor, one
after another.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_NAMES = {np.dtype(t): name for name, t in _DTYPES.items()}


def read_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """name -> numpy array for every tensor of a ``.safetensors`` file."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (header_len,) = struct.unpack("<Q", data[:8])
    if 8 + header_len > len(data):
        raise ValueError(f"{path}: header runs past the end of the file")
    header = json.loads(data[8 : 8 + header_len].decode("utf-8"))
    body = memoryview(data)[8 + header_len :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        dtype = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize or end > len(body):
            raise ValueError(f"{path}: {name} has a bad byte range")
        out[name] = np.frombuffer(body[begin:end], dtype=dtype) \
            .reshape(shape).astype(dtype.newbyteorder("="))
    return out


def write_safetensors(path: Union[str, Path],
                      tensors: Mapping[str, np.ndarray]) -> None:
    """Write ``{name: ndarray}`` as one ``.safetensors`` file, tensors in
    name order."""
    header: dict = {}
    chunks, offset = [], 0
    for name in sorted(tensors):
        array = np.asarray(tensors[name])
        dtype = array.dtype.newbyteorder("=")
        if dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {array.dtype} has no "
                             f"safetensors name")
        raw = np.ascontiguousarray(
            array, dtype=dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": _NAMES[dtype],
                        "shape": list(array.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in chunks:
            f.write(raw)
