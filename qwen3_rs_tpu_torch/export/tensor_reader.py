"""Safetensors reader in numpy: every ``*.safetensors`` of a model
directory, tensors found by name across the files, F32 and BF16 converted to
f32 exactly (other dtypes refused), at most ``MAX_CACHED_FILES`` files mapped
at a time (least recently used closed first).

The file format is parsed directly (8-byte little-endian header length, JSON
header, raw data) over ``np.memmap``, so reads copy nothing until the dtype
conversion.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np


def bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    """bf16 bit patterns → f32: the 16 bits are the high half of the f32."""
    return (raw_u16.astype(np.uint32) << 16).view(np.float32)


class _SafetensorsFile:
    def __init__(self, path: Path):
        self.path = path
        with open(path, "rb") as f:
            header_len = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(header_len))
        self.data_offset = 8 + header_len
        header.pop("__metadata__", None)
        self.tensors = header  # name -> {dtype, shape, data_offsets}
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def names(self):
        return self.tensors.keys()

    def load(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        dtype = info["dtype"]
        shape = tuple(info["shape"])
        start, end = info["data_offsets"]
        raw = self._mm[self.data_offset + start : self.data_offset + end]
        if dtype == "F32":
            return np.frombuffer(raw, dtype="<f4").reshape(shape)
        if dtype == "BF16":
            return bf16_to_f32(np.frombuffer(raw, dtype="<u2")).reshape(shape)
        raise ValueError(
            f"Unsupported dtype {dtype} for tensor {name!r} (only F32/BF16 are supported)"
        )

    def close(self):
        del self._mm


class TensorReader:
    """Find-by-name tensor access across all safetensors shards."""

    MAX_CACHED_FILES = 10

    def __init__(self, model_path: str | Path):
        self.model_path = Path(model_path)
        self.files = sorted(self.model_path.glob("*.safetensors"))
        if not self.files:
            raise FileNotFoundError(f"No .safetensors files found in {self.model_path}")
        self._cache: OrderedDict[Path, _SafetensorsFile] = OrderedDict()
        self._location: dict[str, Path] = {}  # tensor name -> its file (the first that has it)
        for path in self.files:
            for name in self._open(path).names():
                self._location.setdefault(name, path)

    def _open(self, path: Path) -> _SafetensorsFile:
        if path in self._cache:
            self._cache.move_to_end(path)
            return self._cache[path]
        f = _SafetensorsFile(path)
        self._cache[path] = f
        while len(self._cache) > self.MAX_CACHED_FILES:
            _, evicted = self._cache.popitem(last=False)
            evicted.close()
        return f

    def list_tensor_names(self) -> list[str]:
        return sorted(self._location)

    def has_tensor(self, name: str) -> bool:
        return name in self._location

    def load_tensor(self, name: str) -> Optional[np.ndarray]:
        """Tensor by name as contiguous f32, or None when absent."""
        path = self._location.get(name)
        if path is None:
            return None
        return np.ascontiguousarray(self._open(path).load(name), dtype=np.float32)

    def clear_cache(self):
        for f in self._cache.values():
            f.close()
        self._cache.clear()
