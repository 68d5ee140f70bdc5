"""Input-validation policy of the public entry points (port of the
validation-policy part of ``raft_tpu.config``; ``output_as`` is not
ported).

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
