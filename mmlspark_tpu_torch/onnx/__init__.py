"""ONNX for the port (counterpart of ``mmlspark_tpu/onnx/``): the wire
codec, the proto object model and the builder are copies; the converter
runs a graph as PyTorch ops."""

from .builder import (make_graph, make_model, make_node, make_tensor,
                      make_tensor_value_info)
from .convert import (ConvertedModel, OP_HANDLERS, UnsupportedOp,
                      convert_model, register_op)
from .proto import (DataType, ModelProto, model_content_digest, parse_model,
                    tensor_to_numpy)

__all__ = ["convert_model", "ConvertedModel", "OP_HANDLERS", "register_op",
           "UnsupportedOp", "parse_model", "model_content_digest",
           "ModelProto", "DataType", "tensor_to_numpy",
           "make_node", "make_tensor", "make_tensor_value_info", "make_graph",
           "make_model"]
