"""Module facades (the reference's L2 API surface). ``facades.py`` and
``demo.py`` of the JAX package are not ported yet (ROADMAP.md §A item 7)."""

from online_detection_tpu_torch.modules.abstract import (  # noqa: F401
    AccuracyEvaluatorAbstract,
    ClassifierAbstract,
    FeatureExtractorAbstract,
    RegionClassifierAbstract,
    RegionRefinerAbstract,
)
from online_detection_tpu_torch.modules.feature_extractor import (  # noqa: F401
    AccuracyEvaluator,
    FeatureExtractor,
)
