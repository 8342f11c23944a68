from .data_processor import DataProcessor  # noqa: F401
from .point_feature_encoder import PointFeatureEncoder  # noqa: F401
