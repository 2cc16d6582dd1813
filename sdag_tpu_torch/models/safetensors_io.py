"""The safetensors container, read and written with torch and the standard
library alone (the port does not import the ``safetensors`` package).

Format: an 8-byte little-endian header length, a JSON header mapping each
tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (byte
offsets from the end of the header; an optional ``__metadata__`` key holds
string pairs), then the raw little-endian tensor bytes.

``open_checkpoint`` reads one ``model.safetensors`` or a sharded
``model.safetensors.index.json`` (its ``weight_map`` names each tensor's
shard) through ``mmap``, one tensor at a time: a tensor is materialised
only when it is looked up, and goes straight to the target device, so a
checkpoint never exists whole on the host.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from collections.abc import Mapping
from typing import Dict, Iterator, Optional

import torch

from sdag_tpu_torch.utils.device import resolve_device

SINGLE_FILE = "model.safetensors"
INDEX_FILE = "model.safetensors.index.json"

# file dtype -> (dtype of the buffer read, dtype of the tensor returned);
# numpy has no bfloat16, so bf16 is read as int16 and viewed
_DTYPES = {
    "BF16": (torch.int16, torch.bfloat16),
    "F16": (torch.float16, torch.float16),
    "F32": (torch.float32, torch.float32),
    "I8": (torch.int8, torch.int8),
}
_NAMES = {out: name for name, (_buf, out) in _DTYPES.items()}


class _Shard:
    """One safetensors file: its header, and its bytes mapped (copy on
    write, so ``torch.frombuffer`` gets a writable buffer; nothing is ever
    written back)."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as fh:
            (n,) = struct.unpack("<Q", fh.read(8))
            header = json.loads(fh.read(n))
            self.base = 8 + n
            size = os.fstat(fh.fileno()).st_size
            self.mm = (mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
                       if size > self.base else None)
        header.pop("__metadata__", None)
        self.entries: Dict[str, dict] = header

    def tensor(self, name: str, device: torch.device) -> torch.Tensor:
        e = self.entries[name]
        if e["dtype"] not in _DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{e['dtype']!r}; supported: "
                             f"{sorted(_DTYPES)}")
        buf_dtype, dtype = _DTYPES[e["dtype"]]
        shape = [int(s) for s in e["shape"]]
        n = math.prod(shape)
        if n == 0:
            return torch.empty(shape, dtype=dtype, device=device)
        begin, end = (int(x) for x in e["data_offsets"])
        if end - begin != n * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{self.path}: tensor {name!r} spans "
                             f"{end - begin} bytes for shape {shape}")
        host = torch.frombuffer(self.mm, dtype=buf_dtype, count=n,
                                offset=self.base + begin)
        host = host.view(dtype).reshape(shape)
        # the host tensor aliases the mapping: copy it off before the
        # mapping can close (to the card, or a CPU clone)
        if device.type == "cpu":
            return host.clone()
        return host.to(device)

    def close(self) -> None:
        if self.mm is not None:
            self.mm.close()
            self.mm = None


class Checkpoint(Mapping):
    """Name -> tensor, each read from its shard when looked up."""

    def __init__(self, shards: Dict[str, _Shard], where: Dict[str, str],
                 device: torch.device) -> None:
        self._shards = shards
        self._where = where
        self.device = device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._shards[self._where[name]].tensor(name, self.device)

    def __contains__(self, name) -> bool:
        return name in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def close(self) -> None:
        for s in self._shards.values():
            s.close()

    def __enter__(self) -> "Checkpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_checkpoint(ckpt_dir: str, device="cuda") -> Checkpoint:
    """The tensors of a checkpoint dir (``model.safetensors``, or
    ``model.safetensors.index.json`` with its shards), read lazily onto
    ``device``.  Close it (or use it as a context manager) to unmap."""
    dev = resolve_device(device)
    index = os.path.join(ckpt_dir, INDEX_FILE)
    if os.path.isfile(index):
        with open(index, encoding="utf-8") as fh:
            weight_map = json.load(fh)["weight_map"]
        shards = {f: _Shard(os.path.join(ckpt_dir, f))
                  for f in sorted(set(weight_map.values()))}
        for name, f in weight_map.items():
            if name not in shards[f].entries:
                raise KeyError(f"{index} maps {name!r} to {f}, which does "
                               "not hold it")
        return Checkpoint(shards, dict(weight_map), dev)
    single = os.path.join(ckpt_dir, SINGLE_FILE)
    if not os.path.isfile(single):
        raise FileNotFoundError(f"no {SINGLE_FILE} or {INDEX_FILE} in "
                                f"{ckpt_dir}")
    shard = _Shard(single)
    return Checkpoint({SINGLE_FILE: shard},
                      {name: SINGLE_FILE for name in shard.entries}, dev)


def save_safetensors(tensors: Mapping, path: str,
                     metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (name -> tensor, on any device) as one safetensors
    file; each tensor is copied to the host on its own.  Tensors are laid
    out by element size, largest first, so every offset stays aligned.
    Returns the bytes written."""
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    off = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; "
                             f"supported: {sorted(_NAMES.values())}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for name in names:
            t = tensors[name].detach().contiguous()
            if t.numel():
                fh.write(t.cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + off
