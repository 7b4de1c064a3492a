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
PyTorch version; a CUDA tensor runs the kernel. Around them, the
segmentation configs end to end: the ShapeNet-part data layer
(``data/``: the h5 and pts layouts, synthetic fixtures, the native
``.pts`` loader, index streams and device-resident pools), the eval
(``eval.py``, ``utils/metrics.py``), checkpoints (``utils/
checkpoint.py``), logging (``utils/logging.py``), profiling and the
runner (``train/runner.py``) behind the train and eval CLIs; and the
classification configs end to end: the PointNet classifier
(``models/classifier.py``) trained on ModelNet40 (``data/
modelnet40.py``, its synthetic fixture in memory) by ``train/
classify.py`` (configs 1 and 2) and, with FGSM/PGD perturbations of the
input (``attacks.py``, the eval forward differentiated under
``ops.dispatch.use_kernels(False)``), by ``train/adv_perturb.py``
(config 5), its accuracy and robustness evals (``eval.py``) and serving
(``infer.py --model cls``).

Entry points (on the card unless given ``device="cpu"`` or ``--cpu``)::

    python -m adversarial_learning_on_pointclouds_tpu_torch.train_classification \\
        --nepoch 2 --feature_transform --augment --outf cls
    python -m adversarial_learning_on_pointclouds_tpu_torch.train_adv_perturb \\
        --nepoch 2 --epsilon 0.05 --outf advp
    python -m adversarial_learning_on_pointclouds_tpu_torch.eval_classification \\
        --model cls
    python -m adversarial_learning_on_pointclouds_tpu_torch.eval_robustness \\
        --model advp --epsilons 0 0.05
    python -m adversarial_learning_on_pointclouds_tpu_torch.train_segmentation \\
        --nepoch 2 --outf seg
    python -m adversarial_learning_on_pointclouds_tpu_torch.train_adversarial \\
        --nepoch 2 --bf16 --pallas_augment --paired_trunks --scan 8
    python -m adversarial_learning_on_pointclouds_tpu_torch.eval_segmentation \\
        --model seg

    python -m adversarial_learning_on_pointclouds_tpu_torch.infer \\
        --checkpoint g.pth --model adv --input shape.pts
    python -m adversarial_learning_on_pointclouds_tpu_torch.infer \\
        --checkpoint cls.pth --model cls --input clouds.h5

    from adversarial_learning_on_pointclouds_tpu_torch.train import classify
    state = classify.create_state(cfg, steps_per_epoch)
    classify.train_step(state, points, labels, cfg=cfg, tx=tx)

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
