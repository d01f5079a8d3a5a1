"""The part of the TFLite schema that ``export/tflite.py`` writes and reads.

Copied as constants from TensorFlow's ``tensorflow/lite/schema/schema.fbs``
(schema version 3; the numbers as TensorFlow 2.21 ships them): each table's
field slots (a field's slot is its index in the table's declaration), the
``TensorType`` and ``BuiltinOperator`` codes, and every ``BuiltinOptions``
table an operator here takes, with its union code and its fields' slots,
kinds and defaults. ``tests/test_torch_tflite.py`` reads a written file
field by field through TensorFlow's generated schema module to hold these
numbers to it. Nothing here imports TensorFlow or ``flatbuffers``.
"""

from __future__ import annotations

VERSION = 3
IDENTIFIER = b"TFL3"

# table slots
MODEL = {"version": 0, "operator_codes": 1, "subgraphs": 2,
         "description": 3, "buffers": 4, "metadata": 6}
METADATA = {"name": 0, "buffer": 1}
OPERATOR_CODE = {"deprecated_builtin_code": 0, "custom_code": 1,
                 "version": 2, "builtin_code": 3}
SUBGRAPH = {"tensors": 0, "inputs": 1, "outputs": 2, "operators": 3,
            "name": 4}
TENSOR = {"shape": 0, "type": 1, "buffer": 2, "name": 3, "has_rank": 8}
BUFFER = {"data": 0}
OPERATOR = {"opcode_index": 0, "inputs": 1, "outputs": 2,
            "builtin_options_type": 3, "builtin_options": 4}

# builtin codes above 127 store this in the int8 deprecated field
PLACEHOLDER_FOR_GREATER_OP_CODES = 127

TENSOR_TYPE = {"FLOAT32": 0, "INT32": 2, "BOOL": 6}
TENSOR_TYPE_NAME = {v: k for k, v in TENSOR_TYPE.items()}
# numpy dtype of each TensorType
NUMPY = {"FLOAT32": "float32", "INT32": "int32", "BOOL": "bool"}

PADDING = {"SAME": 0, "VALID": 1}
ACTIVATION_NONE = 0

BUILTIN = {
    "ADD": 0, "CONCATENATION": 2, "CONV_2D": 3, "FULLY_CONNECTED": 9,
    "LOGISTIC": 14, "MAX_POOL_2D": 17, "MUL": 18, "RELU": 19, "RESHAPE": 22,
    "TANH": 28, "PAD": 34, "TRANSPOSE": 39, "SUB": 41, "DIV": 42,
    "STRIDED_SLICE": 45, "EXP": 47, "TOPK_V2": 48, "CAST": 53,
    "MAXIMUM": 55, "ARG_MAX": 56, "MINIMUM": 57, "LESS": 58, "PADV2": 60,
    "GREATER": 61, "EQUAL": 71, "LOG": 73, "REDUCE_MAX": 82, "PACK": 83,
    "LOGICAL_OR": 84, "LOGICAL_AND": 86, "LOGICAL_NOT": 87, "UNPACK": 88,
    "REDUCE_ANY": 91, "RESIZE_NEAREST_NEIGHBOR": 97, "LEAKY_RELU": 98,
    "ABS": 101, "GATHER_ND": 107, "NON_MAX_SUPPRESSION_V5": 121,
    "SELECT_V2": 123, "BROADCAST_TO": 130,
}
BUILTIN_NAME = {v: k for k, v in BUILTIN.items()}
# the operator version written (1 unless TFLite registers the op only
# from a later one)
OP_VERSION = {"BROADCAST_TO": 2}

# options table -> (BuiltinOptions union code, {field: (slot, kind, default)})
OPTIONS = {
    "Conv2DOptions": (1, {
        "padding": (0, "int8", 0), "stride_w": (1, "int32", 0),
        "stride_h": (2, "int32", 0), "fused_activation_function":
        (3, "int8", 0), "dilation_w_factor": (4, "int32", 1),
        "dilation_h_factor": (5, "int32", 1)}),
    "Pool2DOptions": (5, {
        "padding": (0, "int8", 0), "stride_w": (1, "int32", 0),
        "stride_h": (2, "int32", 0), "filter_width": (3, "int32", 0),
        "filter_height": (4, "int32", 0),
        "fused_activation_function": (5, "int8", 0)}),
    "FullyConnectedOptions": (8, {
        "fused_activation_function": (0, "int8", 0),
        "weights_format": (1, "int8", 0), "keep_num_dims": (2, "bool",
                                                            False)}),
    "ConcatenationOptions": (10, {
        "axis": (0, "int32", 0), "fused_activation_function":
        (1, "int8", 0)}),
    "AddOptions": (11, {"fused_activation_function": (0, "int8", 0)}),
    "ReshapeOptions": (17, {}),
    "MulOptions": (21, {"fused_activation_function": (0, "int8", 0)}),
    "PadOptions": (22, {}),
    "TransposeOptions": (26, {}),
    "ReducerOptions": (27, {"keep_dims": (0, "bool", False)}),
    "SubOptions": (28, {"fused_activation_function": (0, "int8", 0)}),
    "DivOptions": (29, {"fused_activation_function": (0, "int8", 0)}),
    "StridedSliceOptions": (32, {
        "begin_mask": (0, "int32", 0), "end_mask": (1, "int32", 0),
        "ellipsis_mask": (2, "int32", 0), "new_axis_mask": (3, "int32", 0),
        "shrink_axis_mask": (4, "int32", 0), "offset": (5, "bool", False)}),
    "ExpOptions": (33, {}),
    "TopKV2Options": (34, {}),
    "CastOptions": (37, {"in_data_type": (0, "int8", 0),
                         "out_data_type": (1, "int8", 0)}),
    "MaximumMinimumOptions": (39, {}),
    "ArgMaxOptions": (40, {"output_type": (0, "int8", 0)}),
    "LessOptions": (41, {}),
    "PadV2Options": (43, {}),
    "GreaterOptions": (44, {}),
    "EqualOptions": (53, {}),
    "PackOptions": (59, {"values_count": (0, "int32", 0),
                         "axis": (1, "int32", 0)}),
    "LogicalOrOptions": (60, {}),
    "LogicalAndOptions": (62, {}),
    "LogicalNotOptions": (63, {}),
    "UnpackOptions": (64, {"num": (0, "int32", 0), "axis": (1, "int32", 0)}),
    "ResizeNearestNeighborOptions": (74, {
        "align_corners": (0, "bool", False),
        "half_pixel_centers": (1, "bool", False)}),
    "LeakyReluOptions": (75, {"alpha": (0, "float32", 0.0)}),
    "AbsOptions": (78, {}),
    "GatherNdOptions": (83, {}),
    "NonMaxSuppressionV5Options": (96, {}),
    "SelectV2Options": (98, {}),
    "BroadcastToOptions": (104, {}),
}

# the options table each operator takes (None: no options table)
OP_OPTIONS = {
    "ADD": "AddOptions", "CONCATENATION": "ConcatenationOptions",
    "CONV_2D": "Conv2DOptions", "FULLY_CONNECTED": "FullyConnectedOptions",
    "LOGISTIC": None, "MAX_POOL_2D": "Pool2DOptions", "MUL": "MulOptions",
    "RELU": None, "RESHAPE": "ReshapeOptions", "TANH": None,
    "PAD": "PadOptions", "TRANSPOSE": "TransposeOptions",
    "SUB": "SubOptions", "DIV": "DivOptions",
    "STRIDED_SLICE": "StridedSliceOptions", "EXP": "ExpOptions",
    "TOPK_V2": "TopKV2Options", "CAST": "CastOptions",
    "MAXIMUM": "MaximumMinimumOptions", "ARG_MAX": "ArgMaxOptions",
    "MINIMUM": "MaximumMinimumOptions", "LESS": "LessOptions",
    "PADV2": "PadV2Options", "GREATER": "GreaterOptions",
    "EQUAL": "EqualOptions", "LOG": None, "REDUCE_MAX": "ReducerOptions",
    "PACK": "PackOptions", "LOGICAL_OR": "LogicalOrOptions",
    "LOGICAL_AND": "LogicalAndOptions", "LOGICAL_NOT": "LogicalNotOptions",
    "UNPACK": "UnpackOptions", "REDUCE_ANY": "ReducerOptions",
    "RESIZE_NEAREST_NEIGHBOR": "ResizeNearestNeighborOptions",
    "LEAKY_RELU": "LeakyReluOptions", "ABS": "AbsOptions",
    "GATHER_ND": "GatherNdOptions",
    "NON_MAX_SUPPRESSION_V5": "NonMaxSuppressionV5Options",
    "SELECT_V2": "SelectV2Options", "BROADCAST_TO": "BroadcastToOptions",
}
