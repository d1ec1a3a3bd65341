"""The committed .npz checkpoints of the Parakeet, SenseVoice and Moonshine
families (the port's copy of spittle_tpu/io/npz_checkpoint.py's reader).

One compressed npz holds the stacked parameter tree under "param:<a>/<b>"
names (float leaves stored f16 or f32), the config dataclass as JSON under
"__config__" and the SentencePiece piece table as JSON under "__pieces__".
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

import numpy as np


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
