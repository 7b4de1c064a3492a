"""Train steps (``segment``: config 3; ``adversarial``: config 4), their
optimizers and states (``state``), and the full training runs behind the
CLIs (``runner``)."""
