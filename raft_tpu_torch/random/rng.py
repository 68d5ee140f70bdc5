"""Counter-based RNG state and distributions (port of
``raft_tpu.random.rng``).

Reference: raft/random/rng_state.hpp:28-52 (``RngState{seed,
base_subsequence, type}``), rng_device.cuh (Philox / PCG generators),
rng.cuh (the distribution suite).  Each draw takes its own
``torch.Generator``, seeded from ``(seed, subsequence)``: on the card that
is PyTorch's Philox4x32 stream, as the reference's ``GenPhilox``; on the
CPU PyTorch's own generator.  Every call through an :class:`RngState`
bumps the subsequence, so successive calls are independent, as in the
reference.  The streams are not the JAX package's threefry bits: a draw
is reproducible from its seed on one device, and matches the JAX
package's in shape, dtype and distribution, not value.

Draws land on ``device``, the card unless the caller asks for the CPU;
an explicit ``torch.Generator`` draws on its own device.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from raft_tpu_torch.core.error import expects

_SUBSEQ_STRIDE = 0x9E3779B97F4A7C15          # spreads (seed, subsequence)
_MASK63 = (1 << 63) - 1


class GeneratorType:
    """Reference: rng_state.hpp ``GeneratorType``.  PyTorch's card
    generator is Philox, which plays both roles; the tag is kept for API
    parity."""

    GenDefault = "philox"
    GenPhilox = "philox"
    GenPC = "philox"


class RngState:
    """Deterministic RNG state (reference: rng_state.hpp:28-52).
    ``advance`` bumps the subsequence (``RngState::advance``), so the next
    draw is independent."""

    def __init__(self, seed: int = 0,
                 gen_type: str = GeneratorType.GenDefault) -> None:
        self.seed = seed
        self.base_subsequence = 0
        self.type = gen_type

    def advance(self, n: int = 1) -> None:
        self.base_subsequence += n

    def next_generator(self, device=None) -> torch.Generator:
        """A generator for ``(seed, subsequence)`` on ``device``; advances
        the state."""
        g = _seeded(_mix(self.seed, self.base_subsequence), device)
        self.advance()
        return g


def _mix(seed: int, subsequence: int) -> int:
    return (int(seed) * 0x100000001B3 + (subsequence + 1) * _SUBSEQ_STRIDE) \
        & _MASK63


def _seeded(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device or "cuda"))
    g.manual_seed(seed)
    return g


RngLike = Union[RngState, int, torch.Generator]


def as_generator(rng: RngLike, device=None) -> torch.Generator:
    """An RngState (advanced), an int seed, or a generator used as it
    is."""
    if isinstance(rng, RngState):
        return rng.next_generator(device)
    if isinstance(rng, torch.Generator):
        return rng
    return _seeded(_mix(int(rng), -1), device)


def _shape(shape) -> Sequence[int]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _draw(kind, rng, shape, dtype, device):
    g = as_generator(rng, device)
    fn = torch.rand if kind == "uniform" else torch.randn
    return fn(_shape(shape), generator=g, device=g.device, dtype=dtype)


def uniform(rng, shape, *, low: float = 0.0, high: float = 1.0,
            dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform on [low, high) (reference: rng.cuh ``uniform``)."""
    return low + (high - low) * _draw("uniform", rng, shape, dtype, device)


def uniformInt(rng, shape, *, low: int = 0, high: int = 2 ** 31 - 1,
               dtype=torch.int32, device=None) -> torch.Tensor:
    """Integers uniform on [low, high) (reference: rng.cuh
    ``uniformInt``, end-exclusive)."""
    g = as_generator(rng, device)
    return torch.randint(low, high, _shape(shape), generator=g,
                         device=g.device, dtype=torch.int64).to(dtype)


def normal(rng, shape, *, mu: float = 0.0, sigma: float = 1.0,
           dtype=torch.float32, device=None) -> torch.Tensor:
    """Reference: rng.cuh ``normal``."""
    return mu + sigma * _draw("normal", rng, shape, dtype, device)


def normalInt(rng, shape, *, mu: float = 0.0, sigma: float = 1.0,
              dtype=torch.int32, device=None) -> torch.Tensor:
    """Reference: rng.cuh ``normalInt``: a rounded normal."""
    x = mu + sigma * _draw("normal", rng, shape, torch.float32, device)
    return torch.round(x).to(dtype)


def lognormal(rng, shape, *, mu: float = 0.0, sigma: float = 1.0,
              dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.exp(normal(rng, shape, mu=mu, sigma=sigma, dtype=dtype,
                            device=device))


def _open_uniform(rng, shape, dtype, device):
    """Uniform on (0, 1): the smallest normal number for an exact 0."""
    u = _draw("uniform", rng, shape, dtype, device)
    return torch.clamp_min(u, torch.finfo(dtype).tiny)


def gumbel(rng, shape, *, mu: float = 0.0, beta: float = 1.0,
           dtype=torch.float32, device=None) -> torch.Tensor:
    u = _open_uniform(rng, shape, dtype, device)
    return mu - beta * torch.log(-torch.log(u))


def laplace(rng, shape, *, mu: float = 0.0, scale: float = 1.0,
            dtype=torch.float32, device=None) -> torch.Tensor:
    u = _draw("uniform", rng, shape, dtype, device) - 0.5
    return mu - scale * torch.sign(u) * torch.log1p(
        -2.0 * torch.clamp_max(u.abs(), 0.5 - torch.finfo(dtype).eps))


def logistic(rng, shape, *, mu: float = 0.0, scale: float = 1.0,
             dtype=torch.float32, device=None) -> torch.Tensor:
    u = _open_uniform(rng, shape, dtype, device)
    return mu + scale * (torch.log(u) - torch.log1p(-u))


def exponential(rng, shape, *, lam: float = 1.0, dtype=torch.float32,
                device=None) -> torch.Tensor:
    u = _open_uniform(rng, shape, dtype, device)
    return -torch.log(u) / lam


def rayleigh(rng, shape, *, sigma: float = 1.0, dtype=torch.float32,
             device=None) -> torch.Tensor:
    u = _open_uniform(rng, shape, dtype, device)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def bernoulli(rng, shape, *, prob: float = 0.5,
              device=None) -> torch.Tensor:
    """Booleans, True with probability ``prob``."""
    return _draw("uniform", rng, shape, torch.float32, device) < prob


def scaled_bernoulli(rng, shape, *, prob: float = 0.5, scale: float = 1.0,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Reference: rng.cuh ``scaled_bernoulli``: +scale with probability
    ``prob``, else -scale."""
    b = bernoulli(rng, shape, prob=prob, device=device)
    return torch.where(b, scale, -scale).to(dtype)


def discrete(rng, shape, weights, dtype=torch.int32,
             device=None) -> torch.Tensor:
    """Indices drawn with probability proportional to ``weights``
    (reference: rng.cuh ``discrete``)."""
    g = as_generator(rng, device)
    w = torch.as_tensor(weights).to(device=g.device, dtype=torch.float32)
    expects(w.ndim == 1 and w.numel() > 0, "discrete: 1-D weights required")
    n = 1
    for s in _shape(shape):
        n *= s
    out = torch.multinomial(torch.clamp_min(w, 0.0), n, replacement=True,
                            generator=g)
    return out.reshape(_shape(shape)).to(dtype)
