"""Config system: YAML → attribute-access tree (the port's own copy of
vatl4pose_tpu/config.py).

The section names are the reference's (DATASET.{TRAIN,EVAL}, DATA_PRESET,
MODEL, LOSS, AE, AUXNET, RETRAIN, VAL, TRAIN), so its configs load
unchanged.  `Cfg` is a dict with attribute get/set, nesting and runtime
mutation (the AL CLI rewrites ANN paths per video).  PyYAML is imported
only where a YAML file is read: a machine without it can still build a
`Cfg` by hand.
"""

from __future__ import annotations

import copy

__all__ = ["Cfg", "update_config"]


class Cfg(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, Cfg):
            v = Cfg(v)
        elif isinstance(v, (list, tuple)):
            v = type(v)(Cfg(x) if isinstance(x, dict) and not isinstance(x, Cfg)
                        else x for x in v)
        super().__setitem__(k, v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def setdefault(self, k, default=None):
        if k not in self:
            self[k] = default          # routes through the wrapping setitem
        return self[k]

    def __deepcopy__(self, memo):
        return Cfg({k: copy.deepcopy(v, memo) for k, v in self.items()})


def update_config(config_file: str) -> Cfg:
    """Load a YAML experiment config (config.py:5-8)."""
    import yaml
    with open(config_file) as f:
        return Cfg(yaml.safe_load(f))
