"""PyTorch/CUDA port of ``adversarial_learning_on_pointclouds_tpu``.

The JAX package beside this one is the reference; this package mirrors
its layout (``models/``, ``ops/``, ``ops/kernels/``, ``utils/``,
``data/``) so each module has an obvious counterpart. It imports
``torch`` and numpy and never JAX, and nothing of the JAX package.

What is ported so far: the serving path (the eval forward of the PointNet
part segmenter, the adversarial trainer's generator), the config-3
training step (``train/segment.py``) and the config-4 adversarial G+D
training step (``train/adversarial.py``, with the pointwise
discriminator ``models/discriminator.py``), also as the JAX package's
bench runs it (bf16 mixed precision, ``augment_fused``, the paired
trunks, K steps per call: ``train_steps_scan``), with their TPU kernels
rewritten by hand in CUDA C++ for Hopper (``csrc/``, built at first use
by ``ops/build.py``): three eval kernels, three training kernels (the
trunk's with its two-stream ``groups=2`` form), the fused discriminator
and the fused augmentation. A CPU tensor runs each kernel's plain
PyTorch version; a CUDA tensor runs the kernel.

Entry points (on the card unless given ``device="cpu"``)::

    python -m adversarial_learning_on_pointclouds_tpu_torch.infer \\
        --checkpoint g.pth --model adv --input shape.pts

    from adversarial_learning_on_pointclouds_tpu_torch.train import segment
    state = segment.create_state(cfg, steps_per_epoch)
    segment.train_step(state, points, labels, cfg=cfg, tx=tx)

    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial)
    state = adversarial.create_state(cfg, steps_per_epoch)
    adversarial.train_step(state, x_l, y_l, x_u, cfg=cfg, g_tx=g_tx,
                           d_tx=d_tx)
"""

__version__ = "0.1.0"
