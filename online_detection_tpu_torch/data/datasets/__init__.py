"""The harvest-GT dispatch (counterpart of ``data/datasets/__init__.py``)."""


def harvest_annotation(dataset, index):
    """GT annotation as the harvest pass feeds it to the model: the dataset's
    own ``harvest_annotation`` where it has one (XML datasets shift boxes and
    keep difficult objects there), else ``get_annotation``."""
    fn = getattr(dataset, "harvest_annotation", None)
    return fn(index) if fn is not None else dataset.get_annotation(index)
