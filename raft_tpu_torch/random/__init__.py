"""Random generation (port of ``raft_tpu.random``): a counter-based RNG
state, the distribution suite and the dataset generators.

Reference: cpp/include/raft/random/ — ``RngState`` with Philox / PCG
device generators (rng_state.hpp:28-52), rng.cuh's distributions and the
data generators.  PyTorch's card generator is Philox, seeded per draw from
``(seed, subsequence)``; the streams differ from the JAX package's
threefry bits, so the two agree in shapes, dtypes and distributions, not
values.
"""

from raft_tpu_torch.random.rng import (  # noqa: F401
    GeneratorType,
    RngState,
    bernoulli,
    discrete,
    exponential,
    gumbel,
    laplace,
    logistic,
    lognormal,
    normal,
    normalInt,
    rayleigh,
    scaled_bernoulli,
    uniform,
    uniformInt,
)
from raft_tpu_torch.random.generators import (  # noqa: F401
    make_blobs,
    make_regression,
    multi_variable_gaussian,
    permute,
    rmat_rectangular_generator,
    sample_without_replacement,
)
