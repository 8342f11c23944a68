from .data_augmentor import DataAugmentor  # noqa: F401
from .database_sampler import DataBaseSampler  # noqa: F401
