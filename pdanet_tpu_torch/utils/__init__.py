from .easydict import EasyDict

__all__ = ["EasyDict"]
