"""The reference's engines, one module an engine name (the traffic
file's ``engine``): each gives ``Engine`` with ``from_seed(flags, p,
key)``, ``from_snapshot(flags, p, snap, device)`` and ``tick(step,
step_key, sample_key, learner) -> (answers, loss or None, ties)``, which
``trainer.start`` and ``trainer.resume`` drive."""
