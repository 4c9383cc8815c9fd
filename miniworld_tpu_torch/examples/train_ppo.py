"""PPO training on the PyTorch port: the clipped-surrogate companion of
train_a2c.py. Each iteration rolls the envs on the card, computes GAE
and runs every epoch's minibatch updates (parallel/train.make_ppo_step),
gradients averaged over the ranks per minibatch. The twin of the JAX
package's examples/train_ppo.py: the same flags and JSONL rows, with
``--device`` (default cuda).

    python -m miniworld_tpu_torch.examples.train_ppo \\
        --env MiniWorld-OneRoomS6Fast-v0 --num-envs 1024 --obs 80x60
"""

from __future__ import annotations

from miniworld_tpu_torch.examples.train_a2c import parser, run


def main():
    p = parser(__doc__)
    p.add_argument("--lam", type=float, default=0.95)
    p.add_argument("--clip-eps", type=float, default=0.2)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--minibatches", type=int, default=4)
    p.add_argument("--ent-coef", type=float, default=0.01)
    args = p.parse_args()

    from miniworld_tpu_torch.parallel import make_ppo_step

    run(args, lambda env: make_ppo_step(
        env, horizon=args.horizon, lr=args.lr, gamma=args.gamma, lam=args.lam,
        clip_eps=args.clip_eps, epochs=args.epochs, minibatches=args.minibatches,
        ent_coef=args.ent_coef), extra=("approx_kl", "clip_frac"))


if __name__ == "__main__":
    main()
