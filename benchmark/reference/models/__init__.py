"""The plain reference models, one file per published architecture, named
by the configuration's MODEL.TYPE (or AE type): `<TYPE>.py` exports
`build(cfg_section, ...)` and, for an estimator, `LR_MULT`, the
retraining optimizer's learning-rate multiplier by top-level module."""

from __future__ import annotations

import importlib


def _module(type_name: str):
    return importlib.import_module(f"{__name__}.{type_name}")


def build_estimator(model_cfg, preset_cfg):
    return _module(model_cfg["TYPE"]).build(model_cfg, preset_cfg)


def build_ae(ae_cfg, input_dim=38):
    return _module(ae_cfg.get("TYPE", "WholeBodyAE")).build(ae_cfg,
                                                             input_dim)


def lr_mult(model_type: str, top_module: str) -> float:
    return _module(model_type).LR_MULT.get(top_module, 1.0)
