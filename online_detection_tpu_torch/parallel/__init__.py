"""Device meshes: the class axis of the solvers and the image axis of the
harvest and of inference split over several devices (counterpart of
``parallel/``)."""
