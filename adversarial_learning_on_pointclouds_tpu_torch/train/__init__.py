"""Train steps (``segment``: config 3; ``adversarial``: config 4) and
their optimizers and states (``state``)."""
