"""PyTorch/CUDA port of ``adversarial_learning_on_pointclouds_tpu``.

The JAX package beside this one is the reference; this package mirrors
its layout (``models/``, ``ops/``, ``ops/kernels/``, ``utils/``,
``data/``) so each module has an obvious counterpart. It imports
``torch`` and numpy and never JAX, and nothing of the JAX package.

What is ported so far: the serving path (the eval forward of the PointNet
part segmenter, the adversarial trainer's generator) and the config-3
training step (``train/segment.py``), with their six TPU kernels
rewritten by hand in CUDA C++ for Hopper (``csrc/``, built at first use
by ``ops/build.py``): three eval kernels and three training kernels. A
CPU tensor runs each kernel's plain PyTorch version; a CUDA tensor runs
the kernel.

Entry points::

    python -m adversarial_learning_on_pointclouds_tpu_torch.infer \\
        --checkpoint g.pth --model adv --input shape.pts

    from adversarial_learning_on_pointclouds_tpu_torch.train import segment
    state = segment.create_state(cfg, steps_per_epoch, device="cuda")
    segment.train_step(state, points, labels, cfg=cfg, tx=tx)
"""

__version__ = "0.1.0"
