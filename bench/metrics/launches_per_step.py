"""Device operations (kernels, copies, fills) a training step launches, from
the profiler's device events: the facade's and the sim engine's dispatch
(``api/trainer.py``, ``core/gossip_sim.py``) over the model's eager ops."""


def read(t):
    return len(t.kernels) / t.steps if t.kernels else None
