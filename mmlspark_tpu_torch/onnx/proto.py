"""ONNX protobuf messages: parse + minimal object model (the port's copy
of ``mmlspark_tpu/onnx/proto.py``; bfloat16 tensors widen to float32).

Field numbers follow the public ONNX IR spec (onnx/onnx.proto). Only the
messages the converter needs are modeled; unknown fields are skipped, so
models produced by any exporter parse as long as they use the standard IR.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from .wire import iter_fields, read_varint

__all__ = ["TensorProto", "AttributeProto", "NodeProto", "GraphProto",
           "ModelProto", "ValueInfo", "DataType", "tensor_to_numpy",
           "parse_model", "model_content_digest", "NUMPY_TO_ONNX",
           "ONNX_TO_NUMPY"]


class DataType:
    FLOAT = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    INT32 = 6
    INT64 = 7
    STRING = 8
    BOOL = 9
    FLOAT16 = 10
    DOUBLE = 11
    UINT32 = 12
    UINT64 = 13
    COMPLEX64 = 14
    COMPLEX128 = 15
    BFLOAT16 = 16

ONNX_TO_NUMPY = {
    DataType.FLOAT: np.float32,
    DataType.UINT8: np.uint8,
    DataType.INT8: np.int8,
    DataType.UINT16: np.uint16,
    DataType.INT16: np.int16,
    DataType.INT32: np.int32,
    DataType.INT64: np.int64,
    DataType.BOOL: np.bool_,
    DataType.FLOAT16: np.float16,
    DataType.DOUBLE: np.float64,
    DataType.UINT32: np.uint32,
    DataType.UINT64: np.uint64,
}

NUMPY_TO_ONNX = {np.dtype(v): k for k, v in ONNX_TO_NUMPY.items()}


def _unpack_numeric(payload: Union[int, bytes], wtype: int, fmt: str):
    """One repeated-numeric element, or a packed run of them."""
    if wtype == 2:  # packed
        return list(np.frombuffer(payload, dtype=fmt))
    if wtype == 5:
        return [struct.unpack("<f", payload)[0] if fmt == "<f4"
                else struct.unpack("<i", payload)[0]]
    if wtype == 1:
        return [struct.unpack("<d", payload)[0] if fmt == "<f8"
                else struct.unpack("<q", payload)[0]]
    return [payload]


def _unpack_varints(payload: Union[int, bytes], wtype: int,
                    signed: bool = True) -> List[int]:
    if wtype == 0:
        v = payload
        if signed and v >= 1 << 63:
            v -= 1 << 64
        return [int(v)]
    vals, pos = [], 0
    while pos < len(payload):
        v, pos = read_varint(payload, pos)
        if signed and v >= 1 << 63:
            v -= 1 << 64
        vals.append(int(v))
    return vals


@dataclass
class TensorProto:
    dims: List[int] = field(default_factory=list)
    data_type: int = 0
    float_data: List[float] = field(default_factory=list)
    int32_data: List[int] = field(default_factory=list)
    string_data: List[bytes] = field(default_factory=list)
    int64_data: List[int] = field(default_factory=list)
    name: str = ""
    raw_data: bytes = b""
    double_data: List[float] = field(default_factory=list)
    uint64_data: List[int] = field(default_factory=list)
    # torch/onnx exporters spill big initializers to sidecar files
    # (save_as_external_data): data_location=EXTERNAL(1) + external_data
    # entries {location, offset, length}
    data_location: int = 0
    external_data: Dict[str, str] = field(default_factory=dict)

    EXTERNAL = 1

    @staticmethod
    def parse(data: bytes) -> "TensorProto":
        t = TensorProto()
        for f, w, v in iter_fields(data):
            if f == 1:
                t.dims.extend(_unpack_varints(v, w))
            elif f == 2:
                t.data_type = v
            elif f == 4:
                t.float_data.extend(_unpack_numeric(v, w, "<f4"))
            elif f == 5:
                t.int32_data.extend(_unpack_varints(v, w))
            elif f == 6:
                t.string_data.append(v)
            elif f == 7:
                t.int64_data.extend(_unpack_varints(v, w))
            elif f == 8:
                t.name = v.decode("utf-8")
            elif f == 9:
                t.raw_data = v
            elif f == 10:
                t.double_data.extend(_unpack_numeric(v, w, "<f8"))
            elif f == 11:
                t.uint64_data.extend(_unpack_varints(v, w, signed=False))
            elif f == 13:  # StringStringEntryProto {key=1, value=2}
                key = val = ""
                for f2, _w2, v2 in iter_fields(v):
                    if f2 == 1:
                        key = v2.decode("utf-8")
                    elif f2 == 2:
                        val = v2.decode("utf-8")
                t.external_data[key] = val
            elif f == 14:
                t.data_location = v
        return t


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns widened, exactly, to float32: numpy has no
    bfloat16 dtype, so the port carries such tensors as float32 (the
    JAX package keeps them as ``jnp.bfloat16``)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def tensor_to_numpy(t: TensorProto,
                    external_dir: Optional[str] = None) -> np.ndarray:
    shape = tuple(t.dims)
    np_dtype = ONNX_TO_NUMPY.get(t.data_type)
    if t.data_location == TensorProto.EXTERNAL:
        import os
        if external_dir is None:
            raise ValueError(
                f"initializer {t.name!r} stores its data externally "
                f"({t.external_data.get('location')!r}); pass "
                "external_data_dir (the directory holding the sidecar files)")
        loc = t.external_data.get("location", "")
        # the location is spec'd relative to the model file; forbid escapes
        base = os.path.abspath(external_dir)
        path = os.path.abspath(os.path.join(base, loc))
        if not path.startswith(base + os.sep):
            raise ValueError(f"external data location {loc!r} escapes "
                             f"{external_dir!r}")
        offset = int(t.external_data.get("offset", 0) or 0)
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if np_dtype is None and t.data_type != DataType.BFLOAT16:
            raise ValueError(
                f"unsupported external tensor dtype {t.data_type}")
        if t.data_type == DataType.BFLOAT16:
            raw = np.fromfile(path, dtype=np.uint16, count=count,
                              offset=offset)
            return _bf16_bits_to_f32(raw).reshape(shape)
        return np.fromfile(path, dtype=np_dtype, count=count,
                           offset=offset).reshape(shape)
    if t.data_type == DataType.STRING:
        arr = np.array([s.decode("utf-8", "replace") for s in t.string_data],
                       dtype=object)
        return arr.reshape(shape)
    if np_dtype is None:
        raise ValueError(f"unsupported tensor dtype {t.data_type} for {t.name!r}")
    if t.raw_data:
        if t.data_type == DataType.BFLOAT16:
            raw = np.frombuffer(t.raw_data, dtype=np.uint16)
            return _bf16_bits_to_f32(raw).reshape(shape)
        return np.frombuffer(t.raw_data, dtype=np_dtype).reshape(shape).copy()
    for data in (t.float_data, t.int64_data, t.int32_data, t.double_data,
                 t.uint64_data):
        if data:
            arr = np.asarray(data)
            if t.data_type == DataType.FLOAT16:
                arr = arr.astype(np.uint16).view(np.float16)
            elif t.data_type == DataType.BFLOAT16:
                arr = _bf16_bits_to_f32(arr.astype(np.uint16))
            else:
                arr = arr.astype(np_dtype)
            return arr.reshape(shape)
    return np.zeros(shape, dtype=np_dtype)


class AttrType:
    FLOAT = 1
    INT = 2
    STRING = 3
    TENSOR = 4
    GRAPH = 5
    FLOATS = 6
    INTS = 7
    STRINGS = 8
    TENSORS = 9
    GRAPHS = 10


@dataclass
class AttributeProto:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[TensorProto] = None
    g: Optional["GraphProto"] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)
    tensors: List[TensorProto] = field(default_factory=list)
    graphs: List["GraphProto"] = field(default_factory=list)

    @staticmethod
    def parse(data: bytes) -> "AttributeProto":
        a = AttributeProto()
        for f_, w, v in iter_fields(data):
            if f_ == 1:
                a.name = v.decode("utf-8")
            elif f_ == 2:
                a.f = struct.unpack("<f", v)[0]
            elif f_ == 3:
                a.i = _unpack_varints(v, w)[0]
            elif f_ == 4:
                a.s = v
            elif f_ == 5:
                a.t = TensorProto.parse(v)
            elif f_ == 6:
                a.g = GraphProto.parse(v)
            elif f_ == 7:
                a.floats.extend(_unpack_numeric(v, w, "<f4"))
            elif f_ == 8:
                a.ints.extend(_unpack_varints(v, w))
            elif f_ == 9:
                a.strings.append(v)
            elif f_ == 10:
                a.tensors.append(TensorProto.parse(v))
            elif f_ == 11:
                a.graphs.append(GraphProto.parse(v))
            elif f_ == 20:
                a.type = v
        return a

    def value(self):
        if self.type == AttrType.FLOAT:
            return float(self.f)
        if self.type == AttrType.INT:
            return int(self.i)
        if self.type == AttrType.STRING:
            return self.s.decode("utf-8")
        if self.type == AttrType.TENSOR:
            return tensor_to_numpy(self.t)
        if self.type == AttrType.GRAPH:
            return self.g
        if self.type == AttrType.FLOATS:
            return [float(x) for x in self.floats]
        if self.type == AttrType.INTS:
            return [int(x) for x in self.ints]
        if self.type == AttrType.STRINGS:
            return [s.decode("utf-8") for s in self.strings]
        if self.type == AttrType.TENSORS:
            return [tensor_to_numpy(t) for t in self.tensors]
        if self.type == AttrType.GRAPHS:
            return list(self.graphs)
        # exporters sometimes omit `type`; infer from populated slots
        for cand in ("ints", "floats", "strings"):
            if getattr(self, cand):
                return getattr(self, cand)
        if self.t is not None:
            return tensor_to_numpy(self.t)
        if self.s:
            return self.s.decode("utf-8")
        return self.i if self.i else self.f


@dataclass
class NodeProto:
    input: List[str] = field(default_factory=list)
    output: List[str] = field(default_factory=list)
    name: str = ""
    op_type: str = ""
    domain: str = ""
    attributes: Dict[str, AttributeProto] = field(default_factory=dict)

    @staticmethod
    def parse(data: bytes) -> "NodeProto":
        n = NodeProto()
        for f_, w, v in iter_fields(data):
            if f_ == 1:
                n.input.append(v.decode("utf-8"))
            elif f_ == 2:
                n.output.append(v.decode("utf-8"))
            elif f_ == 3:
                n.name = v.decode("utf-8")
            elif f_ == 4:
                n.op_type = v.decode("utf-8")
            elif f_ == 5:
                a = AttributeProto.parse(v)
                n.attributes[a.name] = a
            elif f_ == 7:
                n.domain = v.decode("utf-8")
        return n

    def attr(self, name: str, default=None):
        a = self.attributes.get(name)
        return default if a is None else a.value()

    @property
    def attribute(self) -> List[AttributeProto]:
        """Protobuf-canonical field name (consumers like torch's exporter
        shim walk ``node.attribute``)."""
        return list(self.attributes.values())


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 0
    shape: List[Optional[Union[int, str]]] = field(default_factory=list)

    @staticmethod
    def parse(data: bytes) -> "ValueInfo":
        vi = ValueInfo()
        for f_, _w, v in iter_fields(data):
            if f_ == 1:
                vi.name = v.decode("utf-8")
            elif f_ == 2:
                vi._parse_type(v)
        return vi

    def _parse_type(self, data: bytes):
        for f_, _w, v in iter_fields(data):
            if f_ == 1:  # tensor_type
                for f2, _w2, v2 in iter_fields(v):
                    if f2 == 1:
                        self.elem_type = v2
                    elif f2 == 2:  # shape
                        for f3, _w3, v3 in iter_fields(v2):
                            if f3 == 1:  # dim
                                dim: Optional[Union[int, str]] = None
                                for f4, _w4, v4 in iter_fields(v3):
                                    if f4 == 1:
                                        dim = int(v4)
                                    elif f4 == 2:
                                        dim = v4.decode("utf-8")
                                self.shape.append(dim)

    @property
    def numpy_dtype(self):
        return ONNX_TO_NUMPY.get(self.elem_type, np.float32)


@dataclass
class GraphProto:
    nodes: List[NodeProto] = field(default_factory=list)
    name: str = ""
    initializers: List[TensorProto] = field(default_factory=list)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)
    value_info: List[ValueInfo] = field(default_factory=list)

    @staticmethod
    def parse(data: bytes) -> "GraphProto":
        g = GraphProto()
        for f_, _w, v in iter_fields(data):
            if f_ == 1:
                g.nodes.append(NodeProto.parse(v))
            elif f_ == 2:
                g.name = v.decode("utf-8")
            elif f_ == 5:
                g.initializers.append(TensorProto.parse(v))
            elif f_ == 11:
                g.inputs.append(ValueInfo.parse(v))
            elif f_ == 12:
                g.outputs.append(ValueInfo.parse(v))
            elif f_ == 13:
                g.value_info.append(ValueInfo.parse(v))
        return g

    @property
    def node(self) -> List[NodeProto]:
        """Protobuf-canonical field name (``graph.node`` in onnx proper)."""
        return self.nodes


@dataclass
class ModelProto:
    ir_version: int = 0
    producer_name: str = ""
    graph: Optional[GraphProto] = None
    opset_imports: Dict[str, int] = field(default_factory=dict)
    #: onnxscript FunctionProtos — parsed models never populate this; it
    #: exists so protobuf-shaped consumers (the torch exporter shim) can
    #: check it is empty
    functions: List[object] = field(default_factory=list)

    def SerializeToString(self) -> bytes:
        raise NotImplementedError(
            "this parsed ModelProto is read-only; re-serialization (only "
            "needed when onnxscript custom functions are present) is not "
            "supported — build models with the onnx.builder module")

    @staticmethod
    def parse(data: bytes) -> "ModelProto":
        m = ModelProto()
        for f_, w, v in iter_fields(data):
            if f_ == 1:
                m.ir_version = v
            elif f_ == 2:
                m.producer_name = v.decode("utf-8")
            elif f_ == 7:
                m.graph = GraphProto.parse(v)
            elif f_ == 8:
                domain, version = "", 0
                for f2, _w2, v2 in iter_fields(v):
                    if f2 == 1:
                        domain = v2.decode("utf-8")
                    elif f2 == 2:
                        version = v2
                m.opset_imports[domain] = version
        return m

    @property
    def opset(self) -> int:
        return self.opset_imports.get("", 13)


def parse_model(data: bytes) -> ModelProto:
    m = ModelProto.parse(data)
    if m.graph is None:
        raise ValueError("not an ONNX model: no graph found")
    return m


def _digest_tensor(h, t: TensorProto) -> None:
    h.update(repr((t.name, tuple(t.dims), t.data_type,
                   t.data_location)).encode())
    h.update(t.raw_data)
    for lst in (t.float_data, t.int32_data, t.int64_data, t.double_data,
                t.uint64_data):
        if lst:
            h.update(repr(lst).encode())
    for s in t.string_data:
        h.update(s)


def _digest_graph(h, g: GraphProto) -> None:
    for vi in list(g.inputs) + list(g.outputs):
        h.update(repr((vi.name, vi.elem_type, tuple(vi.shape))).encode())
    for t in g.initializers:
        _digest_tensor(h, t)
    for n in g.nodes:
        # n.name deliberately excluded: the builder auto-names nodes from
        # object ids, so identical graphs serialize differently per process
        h.update(repr((n.op_type, n.domain, tuple(n.input),
                       tuple(n.output))).encode())
        for aname in sorted(n.attributes):
            a = n.attributes[aname]
            h.update(repr((aname, a.type, a.f, a.i, a.s, tuple(a.floats),
                           tuple(a.ints), tuple(a.strings))).encode())
            if a.t is not None:
                _digest_tensor(h, a.t)
            for t in a.tensors:
                _digest_tensor(h, t)
            for sub in ([a.g] if a.g is not None else []) + list(a.graphs):
                _digest_graph(h, sub)


def model_content_digest(data: bytes) -> str:
    """SHA-1 hex digest of a serialized model's *semantic* content —
    opsets, graph topology, tensor types/shapes, initializer bytes — but
    not node names, which the builder derives from object ids and which
    therefore differ across processes for identical graphs. Stable
    identity for caches keyed by "what does this model compute" (the
    autotuner's observation store). Unparseable bytes fall back to a hash
    of the bytes themselves."""
    import hashlib
    h = hashlib.sha1()
    try:
        m = parse_model(bytes(data))
    except Exception:
        h.update(bytes(data))
        return h.hexdigest()
    h.update(repr(sorted(m.opset_imports.items())).encode())
    _digest_graph(h, m.graph)
    return h.hexdigest()
