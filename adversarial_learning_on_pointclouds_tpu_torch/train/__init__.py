"""Train steps (``segment``) and their optimizer (``state``)."""
