"""Random draws and stable orders shared by the harvest, the reservoirs and
the solvers.

Torch cannot reproduce ``jax.random``'s streams, so every stochastic port
function draws from a caller's ``torch.Generator`` or takes its draws
precomputed (the tests feed it the JAX package's). A generator draws on its
own device and the draws move to the tensors' device, so a CPU generator
gives the same draws to a run on the card and a run on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch


def uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) float32 draws of ``shape`` on ``device``."""
    gdev = generator.device if generator is not None else device
    return torch.rand(shape, generator=generator, device=gdev).to(device)


def randint_below(hi: torch.Tensor, n: int, generator: Optional[torch.Generator],
                  draws=None, uniforms=None) -> torch.Tensor:
    """[..., n] int64 draws uniform in [0, hi) for hi [..., 1] >= 1, or
    ``draws`` as given when not None; ``uniforms`` [..., n] in [0, 1) stand
    in for the generator's."""
    if draws is not None:
        return torch.as_tensor(draws, device=hi.device).long()
    u = uniform(hi.shape[:-1] + (n,), generator, hi.device) if uniforms is None else \
        torch.as_tensor(uniforms, device=hi.device)
    return torch.minimum((u * hi).long(), hi - 1)


def valid_first(mask: torch.Tensor) -> torch.Tensor:
    """Stable order along the last axis with the True entries first."""
    return torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
