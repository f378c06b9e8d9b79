"""String-keyed registries (the port's own copy of vatl4pose_tpu/
registry.py; parity: alphapose/utils/registry.py:4-71).

Models, losses and datasets are resolved from config TYPE strings, which
keeps the reference's public config surface (`MODEL.TYPE: 'SimplePose'`).
"""

from __future__ import annotations

from typing import Callable, Dict

__all__ = ["Registry", "SPPE", "LOSS", "DATASET", "build_from_cfg"]


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return dict(self._module_dict)

    def get(self, key: str):
        if key not in self._module_dict:
            raise KeyError(f"{key} is not registered in {self._name} "
                           f"(have: {sorted(self._module_dict)})")
        return self._module_dict[key]

    def register_module(self, cls=None, *, name: str = None):
        def _register(c):
            key = name or c.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} already registered in {self._name}")
            self._module_dict[key] = c
            return c
        if cls is None:
            return _register
        return _register(cls)


SPPE = Registry("sppe")
LOSS = Registry("loss")
DATASET = Registry("dataset")


def build_from_cfg(cfg: dict, registry: Registry, **default_args):
    """registry[cfg['TYPE']](**cfg-minus-TYPE, **default_args)."""
    args = {k: v for k, v in dict(cfg).items() if k != "TYPE"}
    args.update(default_args)
    return registry.get(cfg["TYPE"])(**args)
