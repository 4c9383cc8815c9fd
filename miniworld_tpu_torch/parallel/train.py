"""Train steps: env rollout + A2C or PPO learner, data-parallel over
``torch.distributed``.

Counterpart of ``miniworld_tpu/parallel/train.py``. One call of a step
rolls the rank's envs ``horizon`` steps with the current policy
(``MiniWorldVec.rollout(policy=..., return_obs=True,
return_actions=True)``: the acted-on observations, the sampled
actions, per-env rewards and done flags), bootstraps the returns from
the critic at the observation after the rollout, cut at auto-reset
boundaries, and updates the learner; gradients, the loss and the
metrics are averaged or summed over the ranks (parallel/dist.py), as
JAX's ``shard_map`` program does over the mesh. Each env is a rank's
shard: its ``num_envs`` is the global batch over the world size.
"""

from __future__ import annotations

import torch

from miniworld_tpu_torch.ops import rng as rng_ops
from miniworld_tpu_torch.parallel import dist, learner as L


def discounted_returns(rewards, dones, bootstrap, gamma: float):
    """(T, B) rewards/dones + (B,) bootstrap -> (T, B) n-step returns
    (JAX train.py:33-48): ``R_t = r_t + gamma * (1 - done_t) * R_{t+1}``
    with ``R_T = V(obs_T)``; done cuts the tail because auto-reset makes
    ``obs_{t+1}`` the first observation of a new episode."""
    out = torch.empty_like(rewards)
    ret = bootstrap
    for t in range(rewards.shape[0] - 1, -1, -1):
        ret = rewards[t] + gamma * torch.where(dones[t], torch.zeros_like(ret), ret)
        out[t] = ret
    return out


def gae(rewards, dones, values, bootstrap, gamma: float, lam: float):
    """Generalized advantage estimation (JAX train.py:50-75): (T, B)
    rewards/dones/values + (B,) bootstrap value -> (T, B) advantages,

        delta_t = r_t + gamma * (1 - done_t) * V_{t+1} - V_t
        A_t     = delta_t + gamma * lam * (1 - done_t) * A_{t+1}
    """
    out = torch.empty_like(values)
    adv_next, v_next = torch.zeros_like(bootstrap), bootstrap
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + gamma * nonterm * v_next - values[t]
        adv_next = delta + gamma * lam * nonterm * adv_next
        v_next = values[t]
        out[t] = adv_next
    return out


def _policy_spec(env) -> tuple[int, bool]:
    """(action_dim, continuous) for the env's action space: categorical
    over a discrete table / spec.num_actions when present, otherwise a
    diagonal-Gaussian head over the raw Box space (2-D clicks or the
    reference's 6-D action vector, miniworld.py:616-652)."""
    if env._action_table is not None:
        return env._action_table.shape[0], False
    if getattr(env.spec, "num_actions", 0):
        return env.spec.num_actions, False
    if getattr(env.spec, "click_action", False):
        return 2, True
    return 6, True


def _image(obs):
    """The image leaf of an observation (Sign's dict puts it under "obs")."""
    return obs["obs"] if isinstance(obs, dict) else obs


def _policy_factory(params, continuous: bool):
    def policy(obs, depth, key):
        with torch.no_grad():
            out, _ = L.forward(params, _image(obs), depth)
            if continuous:
                return L.gaussian_sample(params, out, key)
            return rng_ops.categorical(key, out)
    return policy


def _flat_actions(actions, n: int, continuous: bool):
    """(T, B[, A]) rollout actions -> the loss's flat batch layout."""
    if continuous:
        return actions.reshape(n, actions.shape[-1])
    return actions.reshape(n).to(torch.int32)


def _transitions(env, params, continuous, state, obs, depth, key, horizon):
    """The policy's rollout from (state, obs, depth) and its flat batch:
    (state, obs, depth, outs, rgb (T*B, H, W, 3), depth (T*B, H, W, 1),
    actions (T*B[, A]), T, B); depth zeros when the env has none
    (JAX train.py:135-137)."""
    obs_in = (obs, depth) if env.with_depth else obs
    state, obs_out, outs = env.rollout(
        state, obs_in, key, horizon, policy=_policy_factory(params, continuous),
        return_obs=True, return_actions=True)
    obs, depth = obs_out if env.with_depth else (obs_out, None)
    rgb_t = _image(outs["obs"])  # (T, B, H, W, 3)
    T, B = rgb_t.shape[0], rgb_t.shape[1]
    dep_t = outs.get("depth")
    if dep_t is None:
        dep_t = torch.zeros(rgb_t.shape[:4] + (1,), dtype=torch.float32, device=rgb_t.device)
    flat_rgb = rgb_t.reshape(T * B, *rgb_t.shape[2:])
    flat_dep = dep_t.reshape(T * B, *dep_t.shape[2:])
    actions = _flat_actions(outs["actions"], T * B, continuous)
    return state, obs, depth, outs, flat_rgb, flat_dep, actions, T, B


def _bootstrap(params, obs, depth):
    """V(obs_T) of the observation after the rollout, without gradient."""
    with torch.no_grad():
        return L.forward(params, _image(obs), depth)[1]


def _env_metrics(outs, returns) -> dict:
    """The rollout's metrics over the ranks: reward and dones summed,
    return_mean averaged."""
    reward, dones = dist.all_sum([outs["reward"].sum(), outs["dones"].sum()])
    (ret_mean,) = dist.all_mean([returns.mean()])
    return {"reward": reward, "dones": dones, "return_mean": ret_mean}


def make_train_step(env, horizon: int = 4, lr: float = 3e-4, gamma: float = 0.99):
    """Build ``step(tstate, state, obs, depth, key) -> (tstate, state,
    obs, depth, metrics)`` and ``init(key) -> (tstate, state, obs,
    depth)``: the JAX package's ``make_train_step`` (train.py:111-179).
    ``env`` holds this rank's envs; ``key`` is key data (2,), the same on
    every rank, with the rank folded in. ``tstate`` is ``{"params":
    ActorCritic, "opt": Adam state}``; the step updates the module in
    place and returns it."""
    num_actions, continuous = _policy_spec(env)

    def step(tstate, state, obs, depth, key):
        key = rng_ops.fold_in(key.to(env.device), dist.rank())
        params = tstate["params"]
        state, obs, depth, outs, flat_rgb, flat_dep, actions, T, B = _transitions(
            env, params, continuous, state, obs, depth, key, horizon)
        v_boot = _bootstrap(params, obs, depth)
        returns = discounted_returns(outs["rewards"], outs["done_mask"], v_boot, gamma)
        params, opt, loss = L.grad_step(params, tstate["opt"], flat_rgb, flat_dep, actions,
                                        returns.reshape(T * B), lr=lr)
        metrics = {"loss": loss, **_env_metrics(outs, returns)}
        return {"params": params, "opt": opt}, state, obs, depth, metrics

    return step, _make_init(env, num_actions, continuous)


def _make_init(env, num_actions: int, continuous: bool = False):
    """``init(key) -> (tstate, state, obs, depth)`` for a fresh run: the
    global reset from the first split of ``key`` (this rank's envs), the
    parameters from the second (the same on every rank)."""

    def init(key):
        k_env, k_par = rng_ops.split(key.to(env.device), 2)
        state, obs = dist.reset_shard(env, k_env)
        obs, depth = obs if env.with_depth else (obs, None)
        params = L.init_params(k_par, (env.obs_height, env.obs_width, 3), num_actions,
                               continuous=continuous, device=env.device)
        return {"params": params, "opt": L.adam_init(params)}, state, obs, depth

    return init


def _rolled_slice(x: torch.Tensor, off: int, start: int, size: int) -> torch.Tensor:
    """``torch.roll(x, off, 0)[start:start + size]`` without rolling x:
    rolled row j is row (j - off) mod n, so the slice is at most two
    slices of x (a view when it does not wrap)."""
    n = x.shape[0]
    a = (start - off) % n
    if a + size <= n:
        return x[a:a + size]
    return torch.cat([x[a:], x[:a + size - n]])


def make_ppo_step(env, horizon: int = 16, lr: float = 3e-4, gamma: float = 0.99,
                  lam: float = 0.95, clip_eps: float = 0.2, epochs: int = 2,
                  minibatches: int = 4, vf_coef: float = 0.5, ent_coef: float = 0.01):
    """Build a PPO train step with ``make_train_step``'s calling shape
    (JAX train.py:200-344).

    Per call: one rollout of ``horizon`` steps with the current policy,
    the behaviour policy's log-probs and values in one batched forward,
    GAE, the advantage normalized with the global (all-rank) moments,
    then ``epochs`` passes of ``minibatches`` clipped-surrogate Adam
    updates over the T*B transitions. As in JAX, a minibatch is a
    contiguous slice of the time-major transitions after a roll by
    ``randint(k_e, (), 0, T*B)``, ``k_e`` the epoch's key from
    ``split(k_sgd, epochs)``; the roll is index arithmetic
    (``_rolled_slice``), so the stacked observations are not copied per
    epoch."""
    num_actions, continuous = _policy_spec(env)
    n_loc = horizon * env.num_envs
    if n_loc % minibatches:
        raise ValueError(f"{n_loc} transitions do not split into {minibatches} minibatches")
    mb = n_loc // minibatches

    def step(tstate, state, obs, depth, key):
        key = rng_ops.fold_in(key.to(env.device), dist.rank())
        k_roll, k_sgd = rng_ops.split(key, 2)
        params, opt = tstate["params"], tstate["opt"]
        state, obs, depth, outs, flat_rgb, flat_dep, actions, T, B = _transitions(
            env, params, continuous, state, obs, depth, k_roll, horizon)

        # behaviour-policy stats under the pre-update params: log-prob of
        # the taken actions and V(obs_t), in one batched forward
        with torch.no_grad():
            old_out, values = L.forward(params, flat_rgb, flat_dep)
            old_logp, _ = L.logp_entropy(params, old_out, actions)
        v_boot = _bootstrap(params, obs, depth)
        adv = gae(outs["rewards"], outs["done_mask"], values.reshape(T, B), v_boot, gamma, lam)
        returns = adv + values.reshape(T, B)
        adv = adv.reshape(T * B)
        # advantage normalization with global (all-rank) moments, so every
        # rank optimizes the same objective
        g_mean, g_sq = dist.all_mean([adv.mean(), torch.mean(adv * adv)])
        g_var = torch.clamp(g_sq - g_mean * g_mean, min=0.0)
        adv = (adv - g_mean) * torch.rsqrt(g_var + 1e-8)
        data = (flat_rgb, flat_dep, actions, old_logp, adv, returns.reshape(T * B))

        losses, kls, clips = [], [], []
        for k_e in rng_ops.split(k_sgd, epochs):
            off = int(rng_ops.randint(k_e, (), n_loc))
            for i in range(minibatches):
                sl = [_rolled_slice(x, off, i * mb, mb) for x in data]
                params, opt, loss, aux = L.ppo_grad_step(
                    params, opt, *sl, lr=lr, clip_eps=clip_eps, vf_coef=vf_coef,
                    ent_coef=ent_coef)
                losses.append(loss)
                kls.append(aux["approx_kl"])
                clips.append(aux["clip_frac"])
        metrics = {
            "loss": torch.stack(losses).mean(),
            "approx_kl": torch.stack(kls).mean(),
            "clip_frac": torch.stack(clips).mean(),
            **_env_metrics(outs, returns),
        }
        return {"params": params, "opt": opt}, state, obs, depth, metrics

    return step, _make_init(env, num_actions, continuous)
