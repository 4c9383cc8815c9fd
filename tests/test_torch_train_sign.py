"""``MiniWorldVec.rollout(policy=..., return_obs=True,
return_actions=True)`` on Sign's dict observations ({"obs", "goal"})
against the JAX package's ``rollout_fn``, B=8 at 32x24 (the checks of
tests/_torch_train.check_rollout_policy). Its own file: the glyph bank
and Sign's JAX programs take most of a minute to build."""

from _torch_train import check_rollout_policy
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)


def test_rollout_policy_sign():
    check_rollout_policy("MiniWorld-Sign-v0", 8, 32, 24, 4)
