"""PyTorch + CUDA port of the on-line detector's inference program.

Mirrors the layout of the JAX package (``ops/``, ``solvers/``, ``models/``,
``utils/``, ``data/``): each module here is the counterpart of the module at
the same path there. The port imports ``torch`` and numpy only.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU device they raise.
"""
