"""YAML experiment-config loading (the port's copy of ``podtpu/config.py``).

One flat YAML per experiment (``configs/*.yaml``). Scientific-notation
literals such as ``1e-3`` parse as floats, not strings (a PyYAML 1.1 quirk
the custom resolver fixes).
"""

from __future__ import annotations

import re
from typing import Any

import yaml

_FLOAT_RESOLVER = re.compile(
    r"""^(?:
     [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)

# Defaults for keys the experiment YAMLs leave implicit.
DEFAULTS: dict[str, Any] = {
    "max_annots": 64,
    "compute_dtype": "bfloat16",
    "conf_threshold": 0.25,
    "nms_iou_threshold": 0.45,
    "max_detections": 100,
    "top_k_candidates": 512,
    "save_freq": 5,
    "workers": 8,
    "seed": 0,
    "early_stopping_patience": 30,
    "trainer_options": {},
}


class _ConfigLoader(yaml.SafeLoader):
    """SafeLoader with a YAML-1.2-style float resolver (so ``1e-3`` is a float)."""


_ConfigLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float", _FLOAT_RESOLVER, list("-+0123456789.")
)


def load_yaml_file(file: str) -> dict:
    with open(file, "r") as f:
        return yaml.load(f, Loader=_ConfigLoader)


# Every config key the framework reads, for typo detection: a misspelled
# knob (``emma:`` for ``ema:``) otherwise silently no-ops. Nested entries
# list the option keys of mapping-valued knobs; ``None`` = free-form.
KNOWN_KEYS: dict[str, Any] = {
    # identity / model
    "model": None, "dataset_name": None, "num_classes": None,
    "input_size": None, "in_channels": None, "anchors": None,
    "scaled_anchors": None, "num_boxes": None, "compute_dtype": None,
    "backbone": None,
    "backbone_pretrained": None, "qat": None,
    # data
    "train_list": None, "val_list": None, "names": None,
    "batch_size": None, "max_annots": None, "workers": None,
    "worker_mode": None, "cache_images": None, "uint8_batches": None,
    "mosaic": None, "copy_paste": None, "pixel_ops": None,
    "device_augment": None, "device_geom": None, "device_hsv": None,
    # training
    "epochs": None, "seed": None, "optimizer": None, "scheduler": None,
    "early_stopping_patience": None, "save_dir": None, "save_freq": None,
    "keep_checkpoints": None, "async_checkpoint": None,
    "save_on_signal": None, "log_images": None, "progress": None,
    "steps_per_dispatch": None,
    "remat_backbone": None, "remat_policy": None,
    "rehearsal_decay_step": None,
    "optimizer_options": {"lr", "momentum", "weight_decay", "nesterov",
                          "clip_grad_norm", "accum_steps", "skip_nonfinite",
                          "flat", "decay_policy"},
    "scheduler_options": {"burn_in", "steps", "scales", "milestones",
                          "gamma", "eta_min", "eta_max", "max_cycles",
                          "T_0", "T_mult", "T_up"},
    "trainer_options": {"check_val_every_n_epoch"},
    "swa": {"start_epoch", "bn_recal_batches"},
    "ema": {"decay", "tau", "eval"},
    "parallel_options": {"fsdp", "spatial", "tensor"},
    # eval / deployment
    "conf_threshold": None, "nms_iou_threshold": None,
    "top_k_candidates": None, "max_detections": None,
    "nms_options": {"multi_label", "merge", "agnostic", "classes",
                    "backend"},
    "tta": {"hflip", "scales"},
    "xla_compiler_options": ...,  # free-form flag=value mapping
}


def validate_config(cfg: dict) -> list[str]:
    """Warnings for unknown keys (with a did-you-mean when one is close).

    Unknown keys are warnings, not errors (``PODTPU_STRICT_CONFIG=1``
    upgrades them to a failure)."""
    import difflib

    warnings = []

    def check(keys, known, where):
        for k in keys:
            if k in known:
                continue
            hint = difflib.get_close_matches(str(k), [str(x) for x in known],
                                             n=1, cutoff=0.75)
            warnings.append(
                f"unknown config key '{k}'{where}"
                + (f" — did you mean '{hint[0]}'?" if hint else ""))

    check(cfg, KNOWN_KEYS, "")
    for key, sub in KNOWN_KEYS.items():
        if not isinstance(sub, set):
            continue
        val = cfg.get(key)
        if isinstance(val, dict):
            check(val, sub, f" in '{key}'")
    return warnings


def get_configs(file: str, validate: bool = True) -> dict:
    """Load an experiment YAML and fill in framework defaults."""
    import os

    cfg = load_yaml_file(file)
    for key, value in DEFAULTS.items():
        cfg.setdefault(key, value)
    if validate:
        warnings = validate_config(cfg)
        for w in warnings:
            print(f"WARNING: {w} ({file})")
        if warnings and os.environ.get("PODTPU_STRICT_CONFIG"):
            raise ValueError(f"{len(warnings)} unknown config key(s) in "
                             f"{file} (PODTPU_STRICT_CONFIG set)")
    return cfg
