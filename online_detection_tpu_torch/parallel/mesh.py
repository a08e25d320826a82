"""Device meshes (counterpart of ``parallel/mesh.py``).

Two data axes split over the devices of a 1-D mesh:

- the **class axis**: every head's minibootstrap (``solvers/minibootstrap.py``)
  and the grouped RLS refiners (``solvers/rls.py``) train each class on its
  own, so each device trains its slice of the classes;
- the **image axis**: the harvest trunk (``pipelines/device_pipeline.py``)
  and ``run_inference`` (``pipelines/online_pipeline.py``) run each device's
  slice of a canvas batch.

One process drives every device, as the JAX package's single-controller
mesh does. Neither axis needs a collective but the final gather, so there is
no ``torch.distributed`` here. ``Mesh.map`` is the one place a sharded
program runs: it splits its inputs, runs each device's slice with that
device current (a kernel's C entry point launches on the current device),
and gathers the results on the mesh's first device. A module's replicas are
made once per distinct device and kept while the module lives.

The slices run one after another: each blocks on the host inside it (the
NMS sweeps of the trunk and of ``detect_batched`` read the device), so
device k+1 starts only once device k's slice has returned. A mesh of
several cards therefore spreads the memory of a program, not its time.

``make_mesh(n)`` takes ``cuda:0 ... cuda:n-1``; ``make_mesh(n,
device="cpu")`` gives n virtual CPU entries, the counterpart of the JAX
tests' ``xla_force_host_platform_device_count``. ``Mesh(devices=[...])``
takes any list, repeats included: on one card, ``[cuda:0, cuda:0]`` runs the
2-way split of every sharded program.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import weakref
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def _normalized(device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_of(obj) -> Optional[torch.device]:
    """The device of the first tensor inside a tensor, a module, or a
    dataclass / tuple / list of them; None when there is none."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, nn.Module):
        for t in obj.parameters():
            return t.device
        for t in obj.buffers():
            return t.device
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = (getattr(obj, f.name) for f in dataclasses.fields(obj))
    elif isinstance(obj, (tuple, list)):
        items = iter(obj)
    else:
        return None
    for item in items:
        dev = device_of(item)
        if dev is not None:
            return dev
    return None


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` (repeats allowed) along ``axis_name``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "mb"
    _replicas: dict = field(default_factory=dict, init=False, repr=False, compare=False,
                            hash=False)

    def __post_init__(self):
        devices = tuple(_normalized(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where the sharded programs gather their results."""
        return self.devices[0]

    def _place(self, obj, dev: torch.device):
        """``obj`` on ``dev``: a tensor moved (not copied when it is there
        already), a module copied and moved (``nn.Module.to`` moves in
        place), a dataclass of tensors through its ``.to``."""
        if isinstance(obj, nn.Module):
            return copy.deepcopy(obj).to(dev)
        return obj.to(dev)

    def split(self, x: Optional[torch.Tensor], axis: int = 0):
        """``x`` cut into ``size`` equal slices along ``axis``, slice k on
        device k; a list of None for None."""
        if x is None:
            return [None] * self.size
        n = x.shape[axis]
        if n % self.size:
            raise ValueError(f"axis {axis} of length {n} does not split over {self.size} "
                             f"devices")
        return [self._place(part, dev)
                for part, dev in zip(x.chunk(self.size, axis), self.devices)]

    def gather(self, parts: Sequence[Optional[torch.Tensor]], axis: int = 0):
        """The slices concatenated along ``axis`` on the first device."""
        if parts[0] is None:
            return None
        return torch.cat([self._place(p, self.first) for p in parts], axis)

    def replicas(self, obj):
        """``obj`` on each mesh entry's device: ``obj`` itself where it lives
        already. A tensor is moved (not kept); a module or a dataclass of
        tensors with ``.to`` is copied once per distinct device, and the
        copies are kept until ``obj`` is freed."""
        if obj is None:
            return [None] * self.size
        if isinstance(obj, torch.Tensor):
            return [self._place(obj, dev) for dev in self.devices]
        home = device_of(obj)
        home = None if home is None else _normalized(home)
        out = []
        for dev in self.devices:
            if dev == home:
                out.append(obj)
                continue
            key = id(obj)
            if key not in self._replicas:
                # dropped when obj is freed, so the id is not reused while kept
                weakref.finalize(obj, self._replicas.pop, key, None)
                self._replicas[key] = {}
            copies = self._replicas[key]
            if dev not in copies:
                copies[dev] = self._place(obj, dev)
            out.append(copies[dev])
        return out

    def map(self, fn, split: Sequence = (), replicated: Sequence = ()):
        """``fn(*slices_k, *replicas_k)`` for each mesh entry k, its device
        current: ``split`` holds tensors (or None) cut along axis 0,
        ``replicated`` objects every entry gets whole (``replicas``). The
        outputs (a tensor, None, or a tuple, NamedTuple or dataclass of them)
        are gathered along axis 0 on the first device."""
        parts = [self.split(t) for t in split]
        reps = [self.replicas(o) for o in replicated]
        outs = []
        for k, dev in enumerate(self.devices):
            with _current(dev):
                outs.append(fn(*(p[k] for p in parts), *(r[k] for r in reps)))
        return self._gather_tree(outs)

    def _gather_tree(self, outs):
        first = outs[0]
        if first is None or isinstance(first, torch.Tensor):
            return self.gather(outs)
        if dataclasses.is_dataclass(first):
            return type(first)(**{f.name: self._gather_tree([getattr(o, f.name) for o in outs])
                                  for f in dataclasses.fields(first)})
        if isinstance(first, tuple):
            items = [self._gather_tree(list(col)) for col in zip(*outs)]
            return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
        raise TypeError(f"Mesh.map cannot gather a {type(first).__name__}")


def _current(dev: torch.device):
    """A context with ``dev`` the current CUDA device (nothing on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "mb", device=None) -> Mesh:
    """A mesh over ``n_devices`` CUDA cards (every card when None), never
    repeating one; raises when fewer exist. ``device="cpu"``: ``n_devices``
    virtual CPU entries (1 when None)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return Mesh(tuple(torch.device("cpu") for _ in range(n_devices or 1)), axis_name)
    available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = available if n_devices is None else n_devices
    if n > available or n < 1:
        raise ValueError(
            f"make_mesh: {n} devices requested but only {available} CUDA devices are "
            f"available; for a virtual mesh on the CPU pass device='cpu', or list the "
            f"devices yourself: Mesh(devices=[...])")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis_name)


def pad_axis(x: torch.Tensor, multiple: int, axis: int = 0) -> torch.Tensor:
    """Zeros appended along ``axis`` up to a multiple of ``multiple``."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], axis)


def train_classifiers_minibootstrap_sharded(pos, pos_valid, neg, neg_valid, params,
                                            mesh: Mesh, stats=None, class_chunk=None,
                                            generator=None, uniforms=None):
    """Class-sharded minibootstrap: ``train_classifiers_minibootstrap`` with
    ``mesh``. The class axis is padded to the mesh size; padded classes have
    no data and are dropped from the result."""
    from online_detection_tpu_torch.solvers.minibootstrap import (
        train_classifiers_minibootstrap)

    return train_classifiers_minibootstrap(pos, pos_valid, neg, neg_valid, params,
                                           stats=stats, class_chunk=class_chunk,
                                           generator=generator, mesh=mesh, uniforms=uniforms)


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"shard_batch: cannot split a {type(tree).__name__}")


def shard_batch(tree, mesh: Mesh):
    """A tree (dict, list, tuple, NamedTuple) of [B, ...] tensors -> one tree
    per mesh entry holding its B / size rows, on its device."""
    split = []
    _tree_map(lambda t: split.append(mesh.split(t)), tree)
    out = []
    for k in range(mesh.size):
        leaves = iter(split)
        out.append(_tree_map(lambda t: next(leaves)[k], tree))
    return out
