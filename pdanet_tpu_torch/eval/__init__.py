from .eval_utils import eval_one_epoch, statistics_info  # noqa: F401
