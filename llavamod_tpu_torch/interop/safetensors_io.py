"""A reader of the safetensors format, straight into torch tensors.

The format (https://github.com/huggingface/safetensors, "Format"): an
8-byte little-endian unsigned header length N, N bytes of JSON mapping each
tensor name to {"dtype", "shape", "data_offsets": [begin, end]} (offsets
relative to the byte after the header; an optional "__metadata__" entry of
strings), then the raw little-endian tensor bytes.

The file is memory-mapped (copy-on-write, so the tensors are writable and
the file never is) and each tensor is a `torch.frombuffer` view of its own
bytes: nothing is read until a tensor is used, and a bf16 checkpoint stays
bf16 on the host.  It needs neither the `safetensors` package nor numpy's
bfloat16 (`ml_dtypes`), which the card's machine does not have.
"""

from __future__ import annotations

import json
import mmap
import struct
import sys
from typing import Dict

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_header(path: str) -> tuple:
    """(header dict without '__metadata__', byte offset of the data, file
    size).  Raises ValueError on a malformed file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: shorter than the 8-byte header length")
        (n,) = struct.unpack("<Q", raw)
        f.seek(0, 2)
        size = f.tell()
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the end "
                             f"of the {size}-byte file")
        f.seek(8)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n, size


def _check_entries(path: str, header: dict, data_len: int) -> None:
    spans = []
    for name, e in header.items():
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has the unknown dtype "
                             f"{e['dtype']!r}")
        begin, end = e["data_offsets"]
        numel = 1
        for s in e["shape"]:
            numel *= s
        want = numel * DTYPES[e["dtype"]].itemsize
        if not 0 <= begin <= end <= data_len or end - begin != want:
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"[{begin}, {end}) for {want} bytes in "
                             f"{data_len} bytes of data")
        spans.append((begin, end, name))
    spans.sort()
    for (_, end, a), (begin, _, b) in zip(spans, spans[1:]):
        if begin < end:
            raise ValueError(f"{path}: tensors {a!r} and {b!r} overlap")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of one .safetensors file, memory-mapped, in the
    file's dtypes.  Raises ValueError on an unknown dtype and on offsets
    that overlap, disagree with the shape or run past the end."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors data is little-endian")
    header, start, size = read_header(path)
    _check_entries(path, header, size - start)
    out: Dict[str, torch.Tensor] = {}
    if not header:
        return out
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, e in header.items():
        dtype = DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        offset = start + begin
        if end == begin:
            out[name] = torch.empty(e["shape"], dtype=dtype)
        elif offset % dtype.itemsize:
            # an unaligned span: copy its bytes once to an aligned tensor
            raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin,
                                   offset=offset)
            out[name] = raw.clone().view(dtype).reshape(e["shape"])
        else:
            out[name] = torch.frombuffer(
                buf, dtype=dtype, count=(end - begin) // dtype.itemsize,
                offset=offset).reshape(e["shape"])
    return out
