"""Minimal ONNX protobuf reader (the port's copy of
spittle_tpu/io/onnx_proto.py: Attribute, Node, Graph and load_onnx), with
no onnx or protobuf package.

It decodes just enough of the wire format to read an inference graph:
ModelProto -> GraphProto -> NodeProto / TensorProto / AttributeProto,
nested subgraphs (the then_branch / else_branch of an If) included. Silero
VAD's .onnx weights load through it (audio/vad/silero.py). Fields it does
not know are skipped, as protobuf's rules allow. The varint and field
readers are io/protobuf.py's.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .protobuf import _read_varint, iter_fields

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class Attribute:
    name: str = ""
    # AttributeProto fields: f=2, i=3, s=4, t=5, g=6, floats=7, ints=8.
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[np.ndarray] = None
    g: Optional["Graph"] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)

    @property
    def value(self):
        for v in (self.g, self.t, self.s, self.i, self.f):
            if v is not None:
                return v
        if self.ints:
            return self.ints
        if self.floats:
            return self.floats
        return None


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, Attribute] = field(default_factory=dict)

    def attr(self, name: str, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value


@dataclass
class Graph:
    name: str = ""
    nodes: List[Node] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)


def _packed_varints(buf: bytes, span: Tuple[int, int]) -> List[int]:
    out = []
    i, end = span
    while i < end:
        x, i = _read_varint(buf, i)
        out.append(x)
    return out


def _text(buf: bytes, span: Tuple[int, int]) -> str:
    return buf[span[0]:span[1]].decode()


def _parse_tensor(buf: bytes, span: Tuple[int, int]) -> Tuple[str, np.ndarray]:
    """TensorProto -> (name, array): raw_data, or the typed float_data /
    int32_data / int64_data fields (packed or one element per field)."""
    dims: List[int] = []
    dtype_tag = 1
    name = ""
    raw: Optional[bytes] = None
    int64_data: List[int] = []
    float_data: List[float] = []
    int32_data: List[int] = []
    for fnum, wt, v in iter_fields(buf, *span):
        if fnum == 1 and wt == 0:
            dims.append(v)
        elif fnum == 2 and wt == 0:
            dtype_tag = v
        elif fnum == 4 and wt == 2:  # packed float_data
            s, e = v
            float_data.extend(struct.unpack(f"<{(e - s) // 4}f", buf[s:e]))
        elif fnum == 4 and wt == 5:
            float_data.append(struct.unpack("<f", v)[0])
        elif fnum == 5 and wt == 0:  # int32_data element
            int32_data.append(v)
        elif fnum == 5 and wt == 2:  # packed int32_data
            int32_data.extend(_packed_varints(buf, v))
        elif fnum == 7 and wt == 2:  # packed int64_data
            int64_data.extend(_signed64(x) for x in _packed_varints(buf, v))
        elif fnum == 7 and wt == 0:
            int64_data.append(_signed64(v))
        elif fnum == 8 and wt == 2:
            name = _text(buf, v)
        elif fnum == 9 and wt == 2:
            raw = buf[v[0]:v[1]]
    dtype = _DTYPES.get(dtype_tag)
    if dtype is None:
        raise ValueError(f"unsupported tensor dtype tag {dtype_tag} for {name}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=dtype)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attribute(buf: bytes, span: Tuple[int, int]) -> Attribute:
    a = Attribute()
    for fnum, wt, v in iter_fields(buf, *span):
        if fnum == 1 and wt == 2:
            a.name = _text(buf, v)
        elif fnum == 2 and wt == 5:
            a.f = struct.unpack("<f", v)[0]
        elif fnum == 3 and wt == 0:
            a.i = _signed64(v)
        elif fnum == 4 and wt == 2:
            a.s = buf[v[0]:v[1]]
        elif fnum == 5 and wt == 2:
            _, a.t = _parse_tensor(buf, v)
        elif fnum == 6 and wt == 2:
            a.g = _parse_graph(buf, v)
        elif fnum == 7 and wt == 5:
            a.floats.append(struct.unpack("<f", v)[0])
        elif fnum == 8 and wt == 0:
            a.ints.append(_signed64(v))
    return a


def _parse_node(buf: bytes, span: Tuple[int, int]) -> Node:
    node = Node(op_type="", inputs=[], outputs=[])
    for fnum, wt, v in iter_fields(buf, *span):
        if fnum == 1 and wt == 2:
            node.inputs.append(_text(buf, v))
        elif fnum == 2 and wt == 2:
            node.outputs.append(_text(buf, v))
        elif fnum == 3 and wt == 2:
            node.name = _text(buf, v)
        elif fnum == 4 and wt == 2:
            node.op_type = _text(buf, v)
        elif fnum == 5 and wt == 2:
            a = _parse_attribute(buf, v)
            node.attrs[a.name] = a
    return node


def _value_info_name(buf: bytes, span: Tuple[int, int]) -> str:
    for fnum, wt, v in iter_fields(buf, *span):
        if fnum == 1 and wt == 2:
            return _text(buf, v)
    return ""


def _parse_graph(buf: bytes, span: Tuple[int, int]) -> Graph:
    g = Graph()
    for fnum, wt, v in iter_fields(buf, *span):
        if fnum == 1 and wt == 2:
            g.nodes.append(_parse_node(buf, v))
        elif fnum == 2 and wt == 2:
            g.name = _text(buf, v)
        elif fnum == 5 and wt == 2:
            name, arr = _parse_tensor(buf, v)
            g.initializers[name] = arr
        elif fnum == 11 and wt == 2:
            g.inputs.append(_value_info_name(buf, v))
        elif fnum == 12 and wt == 2:
            g.outputs.append(_value_info_name(buf, v))
    return g


def load_onnx(path: str) -> Graph:
    """Parse an ONNX file and return its top-level graph."""
    with open(path, "rb") as f:
        buf = f.read()
    for fnum, wt, v in iter_fields(buf, 0, len(buf)):
        if fnum == 7 and wt == 2:  # ModelProto.graph
            return _parse_graph(buf, v)
    raise ValueError(f"{path}: no graph found")
