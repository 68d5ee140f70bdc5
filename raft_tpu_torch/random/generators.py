"""Dataset generators (port of ``raft_tpu.random.generators``).

Reference: raft/random/{make_blobs,make_regression,
rmat_rectangular_generator,sample_without_replacement,permute,
multi_variable_gaussian}.cuh.  Random draws come from
:mod:`raft_tpu_torch.random.rng` generators (Philox on the card); the
streams are not the JAX package's, so outputs match it in shape, dtype
and distribution, and each is reproducible from its seed on one device.
Outputs land on ``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_tensor
from raft_tpu_torch.core.outputs import auto_convert_output
from raft_tpu_torch.random.rng import RngLike, RngState, as_generator


def _streams(seed: RngLike, n: int, device):
    """``n`` independent generators from one seed (the JAX package's
    ``jax.random.split`` into n keys)."""
    if not isinstance(seed, RngState):
        g = as_generator(seed, device)
        seed = RngState(int(torch.randint(0, 2 ** 62, (1,), generator=g,
                                          device=g.device)))
        device = g.device
    return [seed.next_generator(device) for _ in range(n)]


@auto_convert_output
def make_blobs(n_samples: int, n_features: int, *, n_clusters: int = 5,
               cluster_std: float = 1.0,
               center_box: Tuple[float, float] = (-10.0, 10.0),
               centers=None, shuffle: bool = True, seed: RngLike = 0,
               dtype=torch.float32, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian blobs (reference: random/make_blobs.cuh): ``(data
    (n_samples, n_features), labels (n_samples,) int32)``, centres uniform
    in ``center_box`` unless given, each row its centre plus
    ``cluster_std`` normal noise, rows shuffled."""
    gc, gl, gn, gs = _streams(seed, 4, device)
    dev = gc.device
    if centers is None:
        centers = center_box[0] + (center_box[1] - center_box[0]) * \
            torch.rand((n_clusters, n_features), generator=gc, device=dev,
                       dtype=dtype)
    else:
        centers = torch.as_tensor(centers).to(device=dev, dtype=dtype)
        n_clusters = centers.shape[0]
    labels = torch.randint(0, n_clusters, (n_samples,), generator=gl,
                           device=dev)
    noise = cluster_std * torch.randn((n_samples, n_features), generator=gn,
                                      device=dev, dtype=dtype)
    data = centers[labels] + noise
    if shuffle:
        perm = torch.randperm(n_samples, generator=gs, device=dev)
        data, labels = data[perm], labels[perm]
    return data, labels.int()


@auto_convert_output
def make_regression(n_samples: int, n_features: int, *,
                    n_informative: Optional[int] = None, n_targets: int = 1,
                    bias: float = 0.0, noise: float = 0.0,
                    effective_rank: Optional[int] = None,
                    tail_strength: float = 0.5, shuffle: bool = True,
                    seed: RngLike = 0, dtype=torch.float32, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A linear-model dataset (reference: random/make_regression.cuh):
    ``(X, y, coef)`` with ``y = X @ coef + bias`` plus ``noise`` normal
    noise; the first ``n_informative`` coefficients uniform in [0, 100),
    the rest 0; ``effective_rank`` scales the columns by a decaying
    spectrum, as the JAX package does."""
    if n_informative is None:
        n_informative = n_features
    n_informative = min(n_informative, n_features)
    gx, gc, gn, gs, gr = _streams(seed, 5, device)
    dev = gx.device
    X = torch.randn((n_samples, n_features), generator=gx, device=dev,
                    dtype=dtype)
    if effective_rank is not None:
        sv = torch.exp(-torch.arange(n_features, device=dev, dtype=dtype)
                       / effective_rank) * (1 - tail_strength) + \
            tail_strength * torch.rand((n_features,), generator=gr,
                                       device=dev, dtype=dtype)
        X = X * sv[None, :]
    coef = torch.zeros((n_features, n_targets), device=dev, dtype=dtype)
    coef[:n_informative] = 100.0 * torch.rand(
        (n_informative, n_targets), generator=gc, device=dev, dtype=dtype)
    y = X @ coef + bias
    if noise > 0:
        y = y + noise * torch.randn(y.shape, generator=gn, device=dev,
                                    dtype=dtype)
    if shuffle:
        perm = torch.randperm(n_samples, generator=gs, device=dev)
        X, y = X[perm], y[perm]
    if n_targets == 1:
        y = y[:, 0]
    return X, y, coef


def rmat_rectangular_generator(rng: RngLike, theta, r_scale: int,
                               c_scale: int, n_edges: int, *, device=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """R-MAT power-law graph edges (reference:
    random/rmat_rectangular_generator.cuh): ``theta`` (max(r_scale,
    c_scale), 4) per-level quadrant probabilities (a, b, c, d); returns
    ``(src, dst)`` int32 of ``n_edges`` each, one quadrant draw a level
    for every edge at once."""
    gens = _streams(rng, max(r_scale, c_scale), device)
    dev = gens[0].device
    theta = torch.as_tensor(theta, dtype=torch.float32).to(dev)
    max_scale = max(r_scale, c_scale)
    expects(theta.shape[0] >= max_scale and theta.shape[1] == 4,
            "theta must be (max_scale, 4)")
    src = torch.zeros(n_edges, dtype=torch.int32, device=dev)
    dst = torch.zeros(n_edges, dtype=torch.int32, device=dev)
    for lvl in range(max_scale):
        q = torch.multinomial(torch.clamp_min(theta[lvl], 0.0), n_edges,
                              replacement=True, generator=gens[lvl])
        r_bit = (q >= 2).int()            # quadrants c, d: the lower half
        c_bit = (q % 2).int()             # quadrants b, d: the right half
        if lvl < r_scale:
            src = src * 2 + r_bit
        if lvl < c_scale:
            dst = dst * 2 + c_bit
    return src, dst


def sample_without_replacement(rng: RngLike, n_population: int,
                               n_samples: int, *, weights=None,
                               device=None) -> torch.Tensor:
    """Distinct indices (reference: random/sample_without_replacement.cuh):
    uniform, or with ``weights`` by the Gumbel-top-k trick, as the JAX
    package draws them."""
    expects(n_samples <= n_population, "cannot sample more than population")
    g = as_generator(rng, device)
    if weights is None:
        return torch.randperm(n_population, generator=g,
                              device=g.device)[:n_samples]
    u = torch.clamp_min(torch.rand(n_population, generator=g,
                                   device=g.device),
                        torch.finfo(torch.float32).tiny)
    w = torch.as_tensor(weights).to(device=g.device, dtype=torch.float32)
    scores = torch.log(torch.clamp_min(w, 1e-30)) - torch.log(-torch.log(u))
    return torch.topk(scores, n_samples).indices


def permute(rng: RngLike, data, *, device=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random row permutation: ``(permuted, perm int32)`` (reference:
    random/permute.cuh); numpy ``data`` goes to ``device``, the card
    unless the caller asks for the CPU."""
    data = as_tensor(data, device)
    g = as_generator(rng, device if device is not None else data.device)
    perm = torch.randperm(data.shape[0], generator=g, device=g.device)
    return data.to(g.device)[perm], perm.int()


def multi_variable_gaussian(rng: RngLike, mean, cov, n_samples: int, *,
                            device=None) -> torch.Tensor:
    """Samples of N(mean, cov) (reference:
    random/multi_variable_gaussian.cuh), by a Cholesky factor of ``cov``
    (+1e-6 on the diagonal), as the JAX package."""
    g = as_generator(rng, device)
    mean = torch.as_tensor(mean).to(g.device)
    cov = torch.as_tensor(cov).to(g.device)
    d = mean.shape[0]
    L = torch.linalg.cholesky(cov + 1e-6 * torch.eye(d, dtype=cov.dtype,
                                                     device=g.device))
    z = torch.randn((n_samples, d), generator=g, device=g.device,
                    dtype=cov.dtype)
    return mean[None, :] + z @ L.T
