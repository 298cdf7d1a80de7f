"""An attribute view of a nested config dict (a pcdet config as data)."""
from __future__ import annotations

import copy


class Cfg(dict):
    """Dict with attribute access; nested dicts are converted recursively."""

    def __init__(self, d=None, **kw):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v
        for k, v in kw.items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, Cfg):
            v = Cfg(v)
        elif isinstance(v, (list, tuple)):
            v = type(v)(Cfg(x) if isinstance(x, dict) and not isinstance(x, Cfg) else x for x in v)
        super().__setitem__(k, v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def __deepcopy__(self, memo):
        return Cfg({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def clone(self):
        return copy.deepcopy(self)
