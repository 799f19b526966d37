"""ONNX model builder — serialize graphs without the onnx package.

Used by tests (golden models for the converter), the model-zoo exporter, and
anyone who wants to hand a self-built graph to :class:`ONNXModel`. API shape
mirrors the public ``onnx.helper`` so snippets translate directly:
``make_node / make_tensor / make_graph / make_model → bytes``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np

from .proto import DataType, NUMPY_TO_ONNX
from .wire import WireWriter

__all__ = ["make_node", "make_tensor", "make_external_tensor",
           "make_tensor_value_info", "make_graph", "make_model", "Node"]


class Node:
    def __init__(self, op_type: str, inputs: Sequence[str],
                 outputs: Sequence[str], name: str = "", domain: str = "",
                 **attrs):
        self.op_type = op_type
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.name = name or f"{op_type}_{id(self) & 0xffff:x}"
        self.domain = domain
        self.attrs = attrs


def make_node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
              name: str = "", domain: str = "", **attrs) -> Node:
    return Node(op_type, inputs, outputs, name, domain, **attrs)


def _encode_tensor(name: str, arr: np.ndarray) -> WireWriter:
    w = WireWriter()
    arr = np.asarray(arr)
    if arr.dtype.kind == "U" or arr.dtype == object:
        w.packed_varints(1, arr.shape)
        w.varint(2, DataType.STRING)
        for s in arr.ravel():
            w.bytes(6, str(s).encode("utf-8"))
        w.string(8, name)
        return w
    onnx_dtype = NUMPY_TO_ONNX.get(arr.dtype)
    if onnx_dtype is None:
        raise TypeError(f"no ONNX dtype for numpy {arr.dtype}")
    if arr.shape:
        w.packed_varints(1, arr.shape)
    w.varint(2, onnx_dtype)
    w.string(8, name)
    w.bytes(9, np.ascontiguousarray(arr).tobytes())
    return w


def make_tensor(name: str, arr: np.ndarray) -> WireWriter:
    return _encode_tensor(name, arr)


def make_external_tensor(name: str, arr: np.ndarray, location: str,
                         data_dir: str, offset: int = 0) -> WireWriter:
    """Emit a TensorProto with ``data_location=EXTERNAL`` and write the
    payload into ``data_dir/location`` at ``offset`` (the torch exporter's
    ``save_as_external_data`` layout). Returns the proto writer."""
    import os
    arr = np.ascontiguousarray(arr)
    onnx_dtype = NUMPY_TO_ONNX.get(arr.dtype)
    if onnx_dtype is None:
        raise TypeError(f"no ONNX dtype for numpy {arr.dtype}")
    payload = arr.tobytes()
    path = os.path.join(data_dir, location)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mode = "r+b" if os.path.exists(path) else "wb"
    with open(path, mode) as f:
        f.seek(offset)
        f.write(payload)

    w = WireWriter()
    if arr.shape:
        w.packed_varints(1, arr.shape)
    w.varint(2, onnx_dtype)
    w.string(8, name)
    for key, val in (("location", location), ("offset", str(offset)),
                     ("length", str(len(payload)))):
        entry = WireWriter()
        entry.string(1, key)
        entry.string(2, val)
        w.message(13, entry)
    w.varint(14, 1)  # data_location = EXTERNAL
    return w


def _encode_attribute(name: str, value) -> WireWriter:
    from .proto import AttrType
    w = WireWriter()
    w.string(1, name)
    if isinstance(value, bool):
        w.varint(3, int(value)).varint(20, AttrType.INT)
    elif isinstance(value, int):
        w.varint(3, value).varint(20, AttrType.INT)
    elif isinstance(value, float):
        w.float32(2, value).varint(20, AttrType.FLOAT)
    elif isinstance(value, str):
        w.string(4, value).varint(20, AttrType.STRING)
    elif isinstance(value, bytes):
        w.bytes(4, value).varint(20, AttrType.STRING)
    elif isinstance(value, np.ndarray):
        w.message(5, _encode_tensor("", value)).varint(20, AttrType.TENSOR)
    elif isinstance(value, WireWriter):
        # a subgraph built by make_graph (If/Loop/Scan bodies)
        w.message(6, value).varint(20, AttrType.GRAPH)
    elif isinstance(value, (list, tuple)):
        if not value:
            w.packed_varints(8, []).varint(20, AttrType.INTS)
        elif all(isinstance(x, (int, np.integer)) for x in value):
            w.packed_varints(8, value).varint(20, AttrType.INTS)
        elif all(isinstance(x, (int, float, np.floating)) for x in value):
            w.packed_floats(7, value).varint(20, AttrType.FLOATS)
        elif all(isinstance(x, str) for x in value):
            for s in value:
                w.string(9, s)
            w.varint(20, AttrType.STRINGS)
        else:
            raise TypeError(f"mixed attribute list for {name!r}")
    else:
        raise TypeError(f"unsupported attribute {name!r}: {type(value).__name__}")
    return w


def _encode_node(node: Node) -> WireWriter:
    w = WireWriter()
    for i in node.inputs:
        w.string(1, i)
    for o in node.outputs:
        w.string(2, o)
    w.string(3, node.name)
    w.string(4, node.op_type)
    if node.domain:
        w.string(7, node.domain)
    for k, v in node.attrs.items():
        w.message(5, _encode_attribute(k, v))
    return w


def make_tensor_value_info(name: str, elem_type: Union[int, np.dtype, type],
                           shape: Sequence[Optional[Union[int, str]]]) -> WireWriter:
    if not isinstance(elem_type, int):
        elem_type = NUMPY_TO_ONNX[np.dtype(elem_type)]
    w = WireWriter()
    w.string(1, name)
    tensor_type = WireWriter()
    tensor_type.varint(1, elem_type)
    shape_w = WireWriter()
    for d in shape:
        dim = WireWriter()
        if isinstance(d, str):
            dim.string(2, d)
        elif d is not None:
            dim.varint(1, int(d))
        shape_w.message(1, dim)
    tensor_type.message(2, shape_w)
    type_w = WireWriter()
    type_w.message(1, tensor_type)
    w.message(2, type_w)
    return w


def make_graph(nodes: Sequence[Node], name: str,
               inputs: Sequence[WireWriter], outputs: Sequence[WireWriter],
               initializers: Optional[Dict[str, np.ndarray]] = None) -> WireWriter:
    w = WireWriter()
    for n in nodes:
        w.message(1, _encode_node(n))
    w.string(2, name)
    for tname, arr in (initializers or {}).items():
        # pre-encoded writers (e.g. make_external_tensor) pass through
        w.message(5, arr if isinstance(arr, WireWriter)
                  else _encode_tensor(tname, arr))
    for vi in inputs:
        w.message(11, vi)
    for vi in outputs:
        w.message(12, vi)
    return w


def make_model(graph: WireWriter, opset: int = 17,
               producer: str = "mmlspark_tpu",
               extra_opsets: Optional[dict] = None) -> bytes:
    """``extra_opsets``: additional domain→version imports (e.g.
    ``{"ai.onnx.ml": 3}`` for TreeEnsemble graphs)."""
    w = WireWriter()
    w.varint(1, 8)  # ir_version
    w.string(2, producer)
    w.message(7, graph)
    opset_w = WireWriter()
    opset_w.string(1, "")
    opset_w.varint(2, opset)
    w.message(8, opset_w)
    for domain, version in (extra_opsets or {}).items():
        ow = WireWriter()
        ow.string(1, domain)
        ow.varint(2, version)
        w.message(8, ow)
    return w.to_bytes()
