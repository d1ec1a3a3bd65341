"""Protobuf wire-format field reader (the port's copy of the varint and
field readers of spittle_tpu/io/onnx_proto.py), enough to read a
SentencePiece ModelProto without the protobuf or sentencepiece packages."""

from __future__ import annotations

from typing import Iterator, Tuple


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def iter_fields(buf: bytes, start: int, end: int) -> Iterator[tuple]:
    """Yield (field_number, wire_type, value) where value is an int for
    varint fields, a (start, end) span for length-delimited fields, and raw
    bytes for fixed32/fixed64."""
    i = start
    while i < end:
        tag, i = _read_varint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
            yield fnum, wt, v
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            yield fnum, wt, (i, i + ln)
            i += ln
        elif wt == 5:
            yield fnum, wt, buf[i : i + 4]
            i += 4
        elif wt == 1:
            yield fnum, wt, buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
