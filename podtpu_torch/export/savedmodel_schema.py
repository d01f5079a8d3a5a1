"""The part of TensorFlow's SavedModel protos that
``export/savedmodel.py`` writes and reads.

Copied as constants from TensorFlow 2.21's ``.proto`` files, as its
installation holds them (the descriptors compiled into the ``*_pb2.py``
modules beside each): each message's field numbers and the ``DataType``
codes. ``tests/test_torch_savedmodel.py`` parses a written file with
TensorFlow's own ``saved_model_pb2`` to hold these numbers to it. Nothing
here imports TensorFlow or ``protobuf``.
"""

from __future__ import annotations

import numpy as np

# tensorflow/core/protobuf/saved_model.proto
SAVED_MODEL = {"saved_model_schema_version": 1, "meta_graphs": 2}
SCHEMA_VERSION = 1

# tensorflow/core/protobuf/meta_graph.proto
META_GRAPH_DEF = {"meta_info_def": 1, "graph_def": 2, "saver_def": 3,
                  "collection_def": 4, "signature_def": 5,
                  "asset_file_def": 6, "object_graph_def": 7}
META_INFO_DEF = {"meta_graph_version": 1, "stripped_op_list": 2,
                 "any_info": 3, "tags": 4, "tensorflow_version": 5,
                 "tensorflow_git_version": 6, "stripped_default_attrs": 7}
SIGNATURE_DEF = {"inputs": 1, "outputs": 2, "method_name": 3}
TENSOR_INFO = {"name": 1, "dtype": 2, "tensor_shape": 3}

# tensorflow/core/framework/graph.proto, versions.proto, node_def.proto
GRAPH_DEF = {"node": 1, "library": 2, "versions": 4}
VERSION_DEF = {"producer": 1, "min_consumer": 2}
NODE_DEF = {"name": 1, "op": 2, "input": 3, "device": 4, "attr": 5}
# tensorflow/core/framework/function.proto
FUNCTION_DEF_LIBRARY = {"function": 1}
FUNCTION_DEF = {"node_def": 3}

# tensorflow/core/framework/attr_value.proto (AttrValue.ListValue: the
# same numbers for s, i, f, b, type, shape, tensor)
ATTR_VALUE = {"list": 1, "s": 2, "i": 3, "f": 4, "b": 5, "type": 6,
              "shape": 7, "tensor": 8}
LIST_VALUE = {"s": 2, "i": 3, "f": 4, "b": 5, "type": 6, "shape": 7,
              "tensor": 8}

# tensorflow/core/framework/tensor.proto, tensor_shape.proto
TENSOR = {"dtype": 1, "tensor_shape": 2, "tensor_content": 4,
          "float_val": 5, "int_val": 7, "int64_val": 10, "bool_val": 11}
TENSOR_SHAPE = {"dim": 2, "unknown_rank": 3}
DIM = {"size": 1, "name": 2}

# tensorflow/core/framework/types.proto
DATA_TYPE = {"DT_FLOAT": 1, "DT_INT32": 3, "DT_INT64": 9, "DT_BOOL": 10}
DATA_TYPE_NAME = {v: k for k, v in DATA_TYPE.items()}
NUMPY = {"DT_FLOAT": np.float32, "DT_INT32": np.int32,
         "DT_INT64": np.int64, "DT_BOOL": np.bool_}

# tensorflow/cc/saved_model/tag_constants.h, signature_constants.h
TAG_SERVE = "serve"
SIGNATURE_KEY = "serving_default"
PREDICT_METHOD = "tensorflow/serving/predict"

# the GraphDef version of TensorFlow 2.21 (tf.version.GRAPH_DEF_VERSION,
# tensorflow/core/public/version.h) and its oldest consumer
GRAPH_DEF_VERSION = 2474
GRAPH_DEF_MIN_CONSUMER = 0

# protobuf refuses to parse a message of 2 GiB or more
MAX_MESSAGE_BYTES = (1 << 31) - 1
