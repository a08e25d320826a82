"""Public module facades (the reference's L2 API surface)."""

from online_detection_tpu_torch.modules.abstract import (  # noqa: F401
    AccuracyEvaluatorAbstract,
    ClassifierAbstract,
    FeatureExtractorAbstract,
    RegionClassifierAbstract,
    RegionRefinerAbstract,
)
from online_detection_tpu_torch.modules.facades import (  # noqa: F401
    FALKONWrapper,
    OnlineRegionClassifier,
    RegionRefiner,
)
from online_detection_tpu_torch.modules.feature_extractor import (  # noqa: F401
    AccuracyEvaluator,
    FeatureExtractor,
)
from online_detection_tpu_torch.modules.demo import (  # noqa: F401
    IncrementalTeacher,
    OnlineSegmentationDemo,
)

# The reference ships a second "InCore" variant of the classifier stack whose
# only difference is keeping every tensor on the GPU
# (``OnlineRegionClassifier_incore.py``, ``FALKONWrapper_..._incore.py``).
# The port keeps its tensors on the card by default, so the InCore names are
# aliases.
OnlineRegionClassifierIncore = OnlineRegionClassifier
FALKONWrapperIncore = FALKONWrapper
