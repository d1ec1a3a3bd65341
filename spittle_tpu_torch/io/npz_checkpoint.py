"""The committed .npz checkpoints of the Parakeet, SenseVoice and Moonshine
families (the port's copy of spittle_tpu/io/npz_checkpoint.py: the writer
and the reader).

One compressed npz holds the stacked parameter tree under "param:<a>/<b>"
names (float leaves stored f16 or f32), the config dataclass as JSON under
"__config__" and the SentencePiece piece table as JSON under "__pieces__".
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def named_leaves(tree, prefix=""):
    """("a/b/c", leaf) of a nested dict, in insertion order: the names
    the file format gives its leaves."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _host_array(leaf) -> np.ndarray:
    """A numpy array of a leaf: a torch tensor (bf16 read through f32) or
    anything np.asarray takes."""
    if hasattr(leaf, "detach"):
        t = leaf.detach().cpu()
        if t.dtype.is_floating_point and t.element_size() < 4:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def save_family_npz(
    path: str,
    cfg: Any,
    params: Any,
    pieces: Optional[Sequence[str]] = None,
    store_dtype=np.float16,
) -> None:
    """One compressed npz of a family's nested dict: every leaf under
    "param:<path>" (float leaves at store_dtype, f16 by default; pass
    np.float32 where the f16 rounding moves decisions, as the reference's
    Parakeet checkpoint does), cfg (a dataclass) as JSON under
    "__config__", and `pieces` as JSON under "__pieces__" when given.
    Leaves are torch tensors or numpy arrays; the file reads back with
    this module's load_family_npz and the reference's."""
    flat: Dict[str, np.ndarray] = {}
    for name, leaf in named_leaves(params):
        arr = _host_array(leaf)
        flat["param:" + name] = (
            arr.astype(store_dtype) if arr.dtype.kind == "f" else arr
        )
    flat["__config__"] = np.frombuffer(
        json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8
    )
    if pieces is not None:
        flat["__pieces__"] = np.frombuffer(
            json.dumps(list(pieces)).encode(), np.uint8
        )
    np.savez_compressed(path, **flat)


def load_family_npz(
    path: str, config_cls, dtype=np.float32
) -> Tuple[Any, Dict[str, Any], List[str]]:
    """-> (cfg, nested params dict of numpy arrays, pieces list ([] if
    absent)). Float leaves are cast to `dtype`."""
    with np.load(path) as z:
        cfg = config_cls(**json.loads(bytes(z["__config__"]).decode()))
        params: Dict[str, Any] = {}
        for key in z.files:
            if not key.startswith("param:"):
                continue
            node = params
            parts = key[len("param:"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = z[key]
            node[parts[-1]] = (arr.astype(dtype) if arr.dtype.kind == "f"
                               else arr)
        pieces: List[str] = []
        if "__pieces__" in z.files:
            pieces = json.loads(bytes(z["__pieces__"]).decode())
    return cfg, params, pieces
