"""A reader for ``*.safetensors`` files, with no package beyond torch.

The format: an 8-byte little-endian header length N, N bytes of JSON that map
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (and
an optional ``"__metadata__"`` entry), then the raw little-endian bytes, the
offsets counted from the end of the header. The upstream checkpoints store
BF16 / F16 / F32 tensors; I8 and U8 are read too, other dtypes raise.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict

import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "I8": torch.int8, "U8": torch.uint8}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU, in its dtype."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = DTYPES.get(info["dtype"])
            if dtype is None:
                raise TypeError(f"{path}: {name} has dtype {info['dtype']}; the reader "
                                f"takes {sorted(DTYPES)}")
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            count = 1
            for d in shape:
                count *= d
            if end - begin != count * torch.empty((), dtype=dtype).element_size():
                raise ValueError(f"{path}: {name} has {end - begin} bytes for shape {shape}")
            f.seek(base + begin)
            data = bytearray(f.read(end - begin))
            out[name] = (torch.frombuffer(data, dtype=dtype) if count else
                         torch.empty(0, dtype=dtype)).reshape(shape)
    return out


def load_hf_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All ``*.safetensors`` shards under ``path``, merged into one dict in
    sorted file order (JAX ``load_hf_safetensors``,
    ``aether_tpu/io/weights.py:246-259``)."""
    sd: Dict[str, torch.Tensor] = {}
    for shard in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
        sd.update(read_safetensors(shard))
    if not sd:
        raise FileNotFoundError(f"no safetensors found under {path}")
    return sd
