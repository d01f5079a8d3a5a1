"""Native (C++) host code, bound via ctypes: the mAP matcher, built with
``g++`` at first use. A failed build raises; there is no fallback."""

from podtpu_torch.native.build import get_lib, native_class_tp_fp  # noqa: F401
