"""Minimal attribute-access dict (EasyDict replacement, no external dep).

The reference config system builds on ``easydict.EasyDict``
(``pcdet/config.py:1-5``); this is a self-contained equivalent.
"""


class EasyDict(dict):
    """dict subclass with attribute access and recursive wrapping."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        d = dict(d)
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(value):
        # Mapping covers plain dicts and any read-only mapping type.
        from collections.abc import Mapping

        if isinstance(value, Mapping) and not isinstance(value, EasyDict):
            return EasyDict(value)
        if isinstance(value, (list, tuple)):
            wrapped = [EasyDict._wrap(x) for x in value]
            return type(value)(wrapped)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, EasyDict._wrap(value))

    def __setattr__(self, name, value):
        self[name] = value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def update(self, other=None, **kwargs):
        d = dict(other or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    def copy(self):
        return EasyDict(self)
