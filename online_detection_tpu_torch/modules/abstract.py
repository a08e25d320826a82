"""Abstract base classes of the reference's module contracts
(``src/modules/*Abstract.py``), a copy of the JAX package's
``modules/abstract.py``: FeatureExtractor, Classifier, RegionClassifier,
RegionRefiner, AccuracyEvaluator."""

from __future__ import annotations

import abc


class FeatureExtractorAbstract(abc.ABC):
    """``feature-extractor/FeatureExtractorAbstract.py``"""

    @abc.abstractmethod
    def extractRPNFeatures(self, is_train, output_dir=None, save_features=False):
        ...

    @abc.abstractmethod
    def extractFeatures(self, is_train, output_dir=None, save_features=False,
                        extract_features_segmentation=False):
        ...


class ClassifierAbstract(abc.ABC):
    """``region-classifier/ClassifierAbstract.py``"""

    @abc.abstractmethod
    def train(self, X, y, sigma=None, lam=None):
        ...

    @abc.abstractmethod
    def predict(self, model, X, y=None):
        ...


class RegionClassifierAbstract(abc.ABC):
    """``region-classifier/RegionClassifierAbstract.py``"""

    @abc.abstractmethod
    def trainRegionClassifier(self, opts=None, output_dir=None):
        ...

    @abc.abstractmethod
    def testRegionClassifier(self, model, test_boxes):
        ...


class RegionRefinerAbstract(abc.ABC):
    """``region-refiner/RegionRefinerAbstract.py``"""

    @abc.abstractmethod
    def trainRegionRefiner(self, COXY, output_dir=None):
        ...


class AccuracyEvaluatorAbstract(abc.ABC):
    """``accuracy-evaluator/AccuracyEvaluatorAbstract.py``"""

    @abc.abstractmethod
    def evaluate(self, *args, **kwargs):
        ...
