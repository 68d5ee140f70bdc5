"""Global configuration of the public entry points (port of
``raft_tpu.config``): the output type and the input-validation policy.

Output type (parity with ``pylibraft.config``): the port's public
functions return ``torch.Tensor``s by default; ``set_output_as`` switches
them to numpy arrays or to the result of any callable applied to each
tensor (:func:`raft_tpu_torch.core.outputs.auto_convert_output`).  The
JAX package's default, ``"jax"``, cannot be honoured without importing
jax, so ``set_output_as("jax")`` raises ``ValueError`` here.

Validation policy:

- ``"raise"`` (the default): a non-finite input row raises
  :class:`raft_tpu_torch.integrity.errors.ValidationError` at the public
  entry point (one ``isfinite`` reduction and one host sync).
- ``"mask"``: non-finite rows are replaced by zeros on the device and
  flagged in the outputs (search ids -1, the metric's worst distance)
  instead of poisoning the batch; no host sync.
- ``"off"``: no validation work at all, for trusted inputs on the hot
  path.

:func:`raft_tpu_torch.integrity.boundary.guard_nonfinite` reads the policy.
"""

from __future__ import annotations

from typing import Callable, Union

SUPPORTED_OUTPUT_TYPES = ["torch", "numpy"]

output_as_: Union[str, Callable] = "torch"


def set_output_as(output: Union[str, Callable]) -> None:
    """Set the output format of the port's public functions: ``"torch"``
    (tensors, the default), ``"numpy"``, or a callable applied to each
    returned tensor."""
    if output not in SUPPORTED_OUTPUT_TYPES and not callable(output):
        raise ValueError(f"Unsupported output option {output!r}")
    global output_as_
    output_as_ = output


def get_output_as() -> Union[str, Callable]:
    return output_as_


SUPPORTED_VALIDATION_POLICIES = ("raise", "mask", "off")

validation_policy_: str = "raise"


def _checked(policy: str) -> str:
    if policy not in SUPPORTED_VALIDATION_POLICIES:
        raise ValueError(
            f"Unsupported validation policy {policy!r}; expected one of "
            f"{SUPPORTED_VALIDATION_POLICIES}")
    return policy


def set_validation_policy(policy: str) -> None:
    """Set the boundary-validation policy for public entry points."""
    global validation_policy_
    validation_policy_ = _checked(policy)


def get_validation_policy() -> str:
    return validation_policy_


class validation_policy:
    """Context manager scoping the validation policy::

        with config.validation_policy("off"):
            ivf_pq.search(...)   # trusted inputs, no validation work
    """

    def __init__(self, policy: str):
        self._policy = _checked(policy)
        self._saved: str = validation_policy_

    def __enter__(self) -> "validation_policy":
        global validation_policy_
        self._saved = validation_policy_
        validation_policy_ = self._policy
        return self

    def __exit__(self, *exc) -> None:
        global validation_policy_
        validation_policy_ = self._saved
