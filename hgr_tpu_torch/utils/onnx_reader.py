"""Minimal ONNX reader: a pure-Python protobuf wire decoder (the port's
own copy of hgr_tpu/utils/onnx_reader.py, numpy only).

ONNX files are protobuf messages with a published schema (onnx/onnx.proto),
so this module decodes the subset the weight porter needs (graph nodes in
order and initializer tensors as numpy arrays) straight from the wire
format, without the ``onnx`` package:

  varint        (wire type 0)  ints / enums / bools
  fixed64       (wire type 1)  doubles / fixed64
  length-delim  (wire type 2)  strings / bytes / sub-messages / packed
  fixed32       (wire type 5)  floats / fixed32

Field numbers below are from the public onnx.proto (stable across every
released ONNX version; new fields only ever append). Unknown fields are
skipped, so any real exporter's file parses.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# TensorProto.DataType (onnx.proto enum, public).
_DTYPES: Dict[int, np.dtype] = {
    1: np.dtype("<f4"),  # FLOAT
    2: np.dtype("u1"),   # UINT8
    3: np.dtype("i1"),   # INT8
    4: np.dtype("<u2"),  # UINT16
    5: np.dtype("<i2"),  # INT16
    6: np.dtype("<i4"),  # INT32
    7: np.dtype("<i8"),  # INT64
    9: np.dtype("?"),    # BOOL
    10: np.dtype("<f2"),  # FLOAT16
    11: np.dtype("<f8"),  # DOUBLE
    12: np.dtype("<u4"),  # UINT32
    13: np.dtype("<u8"),  # UINT64
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a message buffer.

    payload: raw bytes for wire type 2; the little-endian encoding for
    types 1/5; the varint VALUE re-encoded as int for type 0 (returned
    via a 1-tuple trick below — we just return the int in place of
    bytes; callers know the wire type).
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _packed_varints(payload) -> List[int]:
    if isinstance(payload, int):  # unpacked single element
        return [payload]
    out = []
    pos = 0
    while pos < len(payload):
        v, pos = _read_varint(payload, pos)
        out.append(v)
    return out


@dataclasses.dataclass
class OnnxTensor:
    """Decoded TensorProto."""

    name: str
    dims: Tuple[int, ...]
    data_type: int
    _raw: Optional[bytes]
    _values: Optional[np.ndarray]

    def to_numpy(self) -> np.ndarray:
        dt = _DTYPES.get(self.data_type)
        if dt is None:
            raise ValueError(
                f"tensor '{self.name}': unsupported ONNX data_type "
                f"{self.data_type}")
        if self._raw is not None:
            arr = np.frombuffer(self._raw, dtype=dt)
        elif self._values is not None:
            if self.data_type == 10:  # FLOAT16 via int32_data holds the
                # IEEE-754 half BIT PATTERNS (onnx.proto comment on
                # int32_data) — bit-reinterpret, don't convert
                arr = (self._values.astype(np.uint16)
                       .view(np.dtype("<f2")))
            else:
                arr = self._values.astype(dt)
        else:
            arr = np.zeros(0, dt)
        return arr.reshape(self.dims)


def _parse_tensor(buf: bytes) -> OnnxTensor:
    name = ""
    dims: List[int] = []
    data_type = 0
    raw: Optional[bytes] = None
    floats: List[float] = []
    int32s: List[int] = []
    int64s: List[int] = []
    doubles: List[float] = []
    for field, wire, payload in _fields(buf):
        if field == 1:  # dims (repeated int64)
            dims.extend(_packed_varints(payload))
        elif field == 2:  # data_type
            data_type = payload
        elif field == 4:  # float_data
            if wire == 5:
                floats.append(struct.unpack("<f", payload)[0])
            else:
                floats.extend(np.frombuffer(payload, "<f4").tolist())
        elif field == 5:  # int32_data
            int32s.extend(_packed_varints(payload))
        elif field == 7:  # int64_data
            int64s.extend(_packed_varints(payload))
        elif field == 8:  # name
            name = payload.decode("utf-8")
        elif field == 9:  # raw_data
            raw = payload
        elif field == 10:  # double_data
            if wire == 1:
                doubles.append(struct.unpack("<d", payload)[0])
            else:
                doubles.extend(np.frombuffer(payload, "<f8").tolist())
        # segment/external_data/string_data etc. unused by the porter
    values: Optional[np.ndarray] = None
    if raw is None:
        if floats:
            values = np.asarray(floats, np.float32)
        elif int64s:
            # int64_data varints are two's-complement encoded
            values = np.asarray(
                [v - (1 << 64) if v >= (1 << 63) else v for v in int64s],
                np.int64)
        elif int32s:
            # Conformant encoders sign-extend int32 to 64-bit varints
            # (-1 arrives as 2^64-1); tolerate non-extended 32-bit
            # two's-complement values too.
            values = np.asarray(
                [v - (1 << 64) if v >= (1 << 63)
                 else (v - (1 << 32) if v >= (1 << 31) else v)
                 for v in int32s],
                np.int64)
        elif doubles:
            values = np.asarray(doubles, np.float64)
    return OnnxTensor(name=name, dims=tuple(dims), data_type=data_type,
                      _raw=raw, _values=values)


@dataclasses.dataclass
class OnnxNode:
    """Decoded NodeProto. Scalar attributes are omitted (the porter is
    weight-only) but TENSOR attributes are kept: exporters with
    constant folding off emit conv weights as ``Constant`` nodes whose
    payload lives in the ``value`` attribute, not in the graph
    initializer list."""

    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attr_tensors: Dict[str, OnnxTensor] = dataclasses.field(
        default_factory=dict)
    attr_floats: Dict[str, float] = dataclasses.field(default_factory=dict)


def _parse_attr_tensor(buf: bytes):
    """AttributeProto (onnx.proto): name=1, f=2 (float), t=5
    (TensorProto). Other payload kinds (i/s/ints/floats/...) are
    skipped — the porter needs weights (t) and BN's epsilon (f)."""
    name = ""
    tensor: Optional[OnnxTensor] = None
    fval: Optional[float] = None
    for field, wire, payload in _fields(buf):
        if field == 1:
            name = payload.decode("utf-8")
        elif field == 2 and wire == 5:
            fval = struct.unpack("<f", payload)[0]
        elif field == 5:
            tensor = _parse_tensor(payload)
    return name, tensor, fval


def _parse_node(buf: bytes) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    attr_tensors: Dict[str, OnnxTensor] = {}
    attr_floats: Dict[str, float] = {}
    for field, _wire, payload in _fields(buf):
        if field == 1:
            inputs.append(payload.decode("utf-8"))
        elif field == 2:
            outputs.append(payload.decode("utf-8"))
        elif field == 3:
            name = payload.decode("utf-8")
        elif field == 4:
            op_type = payload.decode("utf-8")
        elif field == 5:  # attribute (repeated AttributeProto)
            aname, atensor, afloat = _parse_attr_tensor(payload)
            if atensor is not None:
                attr_tensors[aname] = atensor
            if afloat is not None:
                attr_floats[aname] = afloat
    return OnnxNode(op_type=op_type, name=name, inputs=inputs,
                    outputs=outputs, attr_tensors=attr_tensors,
                    attr_floats=attr_floats)


@dataclasses.dataclass
class OnnxGraph:
    name: str
    nodes: List[OnnxNode]
    initializers: Dict[str, OnnxTensor]
    # graph inputs / outputs: name -> shape (an int per fixed dimension, the
    # dimension's parameter name for a symbolic one), in graph order
    inputs: Dict[str, Tuple] = dataclasses.field(default_factory=dict)
    outputs: Dict[str, Tuple] = dataclasses.field(default_factory=dict)


def _parse_value_info(buf: bytes) -> Tuple[str, Tuple]:
    """ValueInfoProto -> (name, shape): name = 1, type = 2; TypeProto
    tensor_type = 1; its shape = 2; TensorShapeProto dim = 1; a dimension's
    dim_value = 1 or dim_param = 2."""
    name, dims = "", []
    for field, _wire, payload in _fields(buf):
        if field == 1:
            name = payload.decode("utf-8")
        elif field == 2:
            for tf, _w, tensor_type in _fields(payload):
                if tf != 1:
                    continue
                for sf, _w2, shape in _fields(tensor_type):
                    if sf != 2:
                        continue
                    for df, _w3, dim in _fields(shape):
                        if df != 1:
                            continue
                        for vf, _w4, v in _fields(dim):
                            dims.append(v if vf == 1 else v.decode("utf-8"))
    return name, tuple(dims)


def _parse_graph(buf: bytes) -> OnnxGraph:
    name = ""
    nodes: List[OnnxNode] = []
    inits: Dict[str, OnnxTensor] = {}
    ios: Dict[int, Dict[str, Tuple]] = {11: {}, 12: {}}
    for field, _wire, payload in _fields(buf):
        if field == 1:  # node (repeated, graph order)
            nodes.append(_parse_node(payload))
        elif field == 2:  # name
            name = payload.decode("utf-8")
        elif field == 5:  # initializer
            t = _parse_tensor(payload)
            inits[t.name] = t
        elif field in ios:  # input = 11, output = 12
            vname, shape = _parse_value_info(payload)
            ios[field][vname] = shape
    return OnnxGraph(name=name, nodes=nodes, initializers=inits,
                     inputs=ios[11], outputs=ios[12])


def load_onnx_graph(path: str) -> OnnxGraph:
    """Parse an .onnx file's graph: nodes in graph order + initializers."""
    with open(path, "rb") as f:
        buf = f.read()
    graph: Optional[OnnxGraph] = None
    for field, _wire, payload in _fields(buf):
        if field == 7:  # ModelProto.graph
            graph = _parse_graph(payload)
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
    return graph
