"""The plain reference of a training run: the environment, the draws,
the nets, the learner and the engines' replays in plain PyTorch, from
the seed alone. It imports neither JAX, nor the JAX package, nor
anything of the program under test."""
