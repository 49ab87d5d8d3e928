"""The fused engine's carry ``(rng, tstate, obs_t, learner, replay,
step)``: the full engine's layout (after tick ``step`` the next
observations are ``obs_t`` and the tick's push is the env-batch before
the replay's cursor); its push is made by ATen (``StreamReplay.
push_many``) after the env tick kernel (B4), not by the tick kernel."""

from portbench.engines.full import answers, learner, snapshot  # noqa: F401
