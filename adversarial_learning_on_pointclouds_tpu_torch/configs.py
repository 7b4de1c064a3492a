"""Configuration of the training runs and of serving, and their CLI flags.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/configs.py``:
``BaseConfig``, ``ClassifyConfig`` (configs 1 and 2), ``SegmentConfig``
(config 3), ``AdversarialConfig`` (config 4) and ``AdvPerturbConfig``
(config 5) with the fields the port reads, under the JAX package's names
and defaults, and the flag parsers of the four trainers
(``parse_classify_args``, ``parse_segment_args``,
``parse_adversarial_args``, ``parse_adv_perturb_args``) with the JAX
package's flag names and defaults.

The device is the switch between the hand-written kernels and their
plain versions: the card (the default) runs the kernels, ``--cpu`` the
plain PyTorch versions, so there is no ``--no_pallas`` (it raises). The
device is not a config field (the configs' fields are the JAX package's):
the ``parse_*_args`` functions return it beside the config, and the
runners take it as an argument. ``num_devices`` is the data-parallel
world size (``parallel/dist.resolve_world``: 0 every visible card, one
rank on the CPU; above the visible cards it raises on CUDA; on the CPU W
gloo ranks), which the trainer CLIs spawn; ``remat`` is not ported. ``fused_epoch`` is
parsed here and refused by the runner where the JAX package's runner
refuses it (``train/runner.py``, ``_fused_epoch_setup``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    """Options shared by the training configurations."""

    batch_size: int = 32          # --batchSize
    num_points: int = 1024        # --num_points
    epochs: int = 250             # --nepoch
    out_dir: str = "cls"          # --outf
    resume: Optional[str] = None  # --model: a checkpoint directory written
                                  #   by the port's runners or a reference
                                  #   .pth (params + BN, fresh optimizer)
    resume_full: bool = False     # --resume_full: the whole train state
                                  #   (optimizers, schedules, augmentation
                                  #   generator, step) from --model
    dataset: str = ""             # --dataset (data root; '' -> synthetic)
    seed: int = 0                 # --manualSeed
    lr: float = 1e-3              # Adam lr
    beta1: float = 0.9
    beta2: float = 0.999
    lr_step: int = 20             # StepLR step_size, in epochs
    lr_gamma: float = 0.5         # StepLR gamma
    optimizer: str = "adam"       # {adam, sgd}: sgd has momentum 0.9
    lr_schedule: str = "step"     # {step, poly}
    poly_power: float = 0.9
    feature_transform: bool = False  # --feature_transform
    augment: bool = False         # on-device rotate + jitter
    normalize: bool = True        # unit-sphere normalize per cloud
    resample: bool = True         # fixed-N subsample when clouds are larger
    point_dropout: bool = False
    scan: int = 0                 # --scan K: K steps per call on K-stacked
                                  #   batches; when set,
                                  #   adversarial.train_steps_scan takes
                                  #   exactly K batches
    pallas_augment: bool = False  # rotate/jitter/dropout as one
                                  #   augment_fused pass on a Philox seed
    bf16: bool = False            # mixed precision: bf16 matmul operands,
                                  #   fp32 sums (core.mixed_precision)
    remat: bool = False           # not ported (a TPU memory knob)
    num_devices: int = 0          # data-parallel ranks: 0 every visible
                                  #   card (one rank on the CPU)
    profile_dir: Optional[str] = None  # --profile_dir (torch.profiler trace)
    quiet: bool = False           # --quiet (reference-style stdout)
    ckpt_policy: str = "every"    # --ckpt_policy {every, latest, best, none}
                                  #   (utils/checkpoint.AsyncSaver)
    eval_every: int = 1           # --eval_every K: eval every K-th epoch
                                  #   and always the last
    log_lag: int = 2              # --log_lag: metric readbacks deferred by
                                  #   this many launches; 0 = synchronous
    fused_epoch: bool = False     # --fused_epoch: each whole epoch (spe
                                  #   train steps + the test eval scan)
                                  #   in one call, one readback group
                                  #   after it; needs device-resident
                                  #   pools and eval_every 1
    workers: int = 0              # --workers: batches prefetched ahead
                                  #   (0 -> 2)
    device_data: bool = True      # train and test pools on the device,
                                  #   batches gathered there from [B]
                                  #   index vectors; --host_data streams
                                  #   assembled batches instead

    def __post_init__(self):
        if self.num_devices < 0:
            raise ValueError(f"num_devices {self.num_devices} is negative")
        if self.remat:
            raise NotImplementedError(
                "remat is not ported (a TPU memory knob, measured slower "
                "there; ROADMAP, Queue 1, 'Do not port')")
        if self.ckpt_policy not in ("every", "latest", "best", "none"):
            raise ValueError(f"unknown ckpt_policy {self.ckpt_policy!r}")


@dataclasses.dataclass(frozen=True)
class ClassifyConfig(BaseConfig):
    """Configs 1-2: ModelNet40 classification."""

    num_classes: int = 40
    dropout: float = 0.3          # between fc2 and its BN (the reference's)
    out_dir: str = "cls"


@dataclasses.dataclass(frozen=True)
class SegmentConfig(BaseConfig):
    """Config 3: ShapeNet-part segmentation (also the adversarial G)."""

    num_points: int = 2048
    num_parts: int = 50
    class_choice: Optional[str] = None  # --class_choice (single category)
    feature_transform: bool = True
    out_dir: str = "seg"


@dataclasses.dataclass(frozen=True)
class AdversarialConfig(SegmentConfig):
    """Config 4: adversarial semi-supervised segmentation (Hung et al.,
    arXiv:1802.07934), with the JAX package's ablation controls and
    cross-stream batching knobs. Refused, as the JAX package refuses
    them: ``supervised_only`` with ``self_training``, and
    ``paired_trunks`` or ``paired_conv1`` without ``paired_heads`` or
    with ``fused_forward``."""

    lambda_adv: float = 0.01      # --lambda_adv
    lambda_adv_unl: Optional[float] = None  # unlabeled stream's own weight
    lambda_semi: float = 0.1      # --lambda_semi
    semi_threshold: float = 0.2   # --threshold (T_semi)
    labeled_ratio: float = 0.5    # --labeled_ratio (labeled/unlabeled split)
    lr_d: float = 1e-4            # discriminator Adam lr
    beta1_d: float = 0.9
    beta2_d: float = 0.99
    semi_start: int = 0           # --semi_start: first step with L_semi
    paired_heads: bool = True     # T-Net fc heads batched across streams
                                  #   (paired_trunks: the conv trunks too)
    supervised_only: bool = False  # ablation control: CE on the labeled
                                  #   stream alone, no unlabeled forward,
                                  #   no D compute or update
    self_training: bool = False   # ablation control: the semi mask from
                                  #   G's own confidence (max softmax >
                                  #   semi_threshold), no adv term, no D
    d_geometry: bool = False      # D's input is [probs; xyz], k + 3
                                  #   channels (checkpoints differ in D)
    paired_trunks: bool = False
    paired_conv1: bool = False    # the conv1 layers as one [2B, N, C]
                                  #   matmul, per-stream BN statistics
    fused_forward: bool = False   # one G forward and one frozen D pass
                                  #   over [x_l; x_u]: BN statistics of
                                  #   the combined 2B batch
    out_dir: str = "adv"

    def __post_init__(self):
        super().__post_init__()
        if self.supervised_only and self.self_training:
            raise ValueError("supervised_only and self_training are mutually "
                             "exclusive ablation controls")
        for name in ("paired_trunks", "paired_conv1"):
            if getattr(self, name) and (not self.paired_heads
                                        or self.fused_forward):
                raise ValueError(f"{name} requires the paired-heads path "
                                 "(paired_heads=True, fused_forward=False)")


@dataclasses.dataclass(frozen=True)
class AdvPerturbConfig(BaseConfig):
    """Config 5: FGSM perturbation training (its attack is per cloud, so
    under data parallelism each rank attacks its own rows)."""

    num_classes: int = 40
    dropout: float = 0.3
    epsilon: float = 0.05         # --epsilon (FGSM step / L-inf bound)
    attack: str = "fgsm"          # --attack {fgsm, pgd}: pgd runs
                                  #   attack_steps projected iterations
                                  #   (attack_steps 1 takes FGSM's path)
    attack_steps: int = 1         # --attack_steps (PGD iterations)
    out_dir: str = "advp"

    def __post_init__(self):
        super().__post_init__()
        if self.attack not in ("fgsm", "pgd"):
            raise ValueError(f"unknown attack {self.attack!r}")


def _add_common_flags(p: argparse.ArgumentParser) -> None:
    """The JAX package's common trainer flags, names and defaults."""
    p.add_argument("--batchSize", type=int, default=32, help="input batch size")
    p.add_argument("--num_points", type=int, default=None, help="points per cloud")
    p.add_argument("--nepoch", type=int, default=250, help="number of epochs")
    p.add_argument("--outf", type=str, default=None, help="output folder")
    p.add_argument("--model", type=str, default=None,
                   help="checkpoint to warm-start from: a directory written "
                        "by these trainers, or a reference torch .pth "
                        "state_dict (params+BN; optimizer restarts — the "
                        "reference's --model semantics)")
    p.add_argument("--dataset", type=str, default="", help="dataset root path")
    p.add_argument("--manualSeed", type=int, default=0, help="random seed")
    p.add_argument("--feature_transform", action="store_true",
                   help="use feature transform (STNkd + ortho regularizer)")
    p.add_argument("--augment", action="store_true",
                   help="on-device rotate/jitter augmentation")
    p.add_argument("--no_normalize", action="store_true",
                   help="skip unit-sphere normalization")
    p.add_argument("--no_resample", action="store_true",
                   help="freeze one host-side fixed-N subsample per run "
                        "instead of a fresh on-device draw per batch")
    p.add_argument("--point_dropout", action="store_true",
                   help="random point dropout (max dropout ratio 0.875)")
    p.add_argument("--scan", type=int, default=0,
                   help="K train steps per call on K-stacked batches (one "
                        "host->device transfer per K steps)")
    p.add_argument("--optimizer", type=str, default="adam",
                   choices=("adam", "sgd"),
                   help="sgd(momentum 0.9) is Hung et al.'s G optimizer")
    p.add_argument("--lr_schedule", type=str, default="step",
                   choices=("step", "poly"),
                   help="poly = Hung et al.'s (1-step/total)^0.9 decay")
    p.add_argument("--poly_power", type=float, default=0.9)
    add_cpu_flag(p)
    p.add_argument("--pallas_augment", action="store_true",
                   help="fused augmentation pass (augment_fused, Philox) "
                        "instead of the generator's chain; distributionally "
                        "identical, different random stream")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision (bf16 matmul inputs, fp32 accum)")
    p.add_argument("--remat", action="store_true",
                   help="not ported (a TPU memory knob)")
    p.add_argument("--resume_full", action="store_true",
                   help="restore the FULL train state from --model "
                        "(optimizer, schedule, generator, step) instead of "
                        "reference-style params-only; the run continues "
                        "at the checkpoint's next epoch")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace here")
    p.add_argument("--quiet", action="store_true", help="reference-style stdout only")
    p.add_argument("--ckpt_policy", type=str, default="every",
                   choices=("every", "latest", "best", "none"),
                   help="'every' saves each epoch (reference semantics); "
                        "'latest' skips stale snapshots when epochs "
                        "outpace the async checkpoint writer (final "
                        "epoch always durable); 'best' saves only "
                        "epochs that improve the eval metric (the "
                        "newest checkpoint on disk is the best epoch); "
                        "'none' disables checkpointing (ablation sweeps)")
    p.add_argument("--eval_every", type=int, default=1,
                   help="run the eval pass every K-th epoch (+ always "
                        "the final one); epoch rows/checkpoint metric "
                        "selection follow the eval (1 = reference "
                        "semantics: eval every epoch)")
    p.add_argument("--log_lag", type=int, default=2,
                   help="defer per-step metric readbacks this many "
                        "launches (overlaps device execution); 0 = "
                        "strictly synchronous per-batch prints (the "
                        "reference behavior)")
    p.add_argument("--workers", type=int, default=0, help="host loader threads")
    p.add_argument("--host_data", action="store_true",
                   help="stream assembled batches from the host (the "
                        "reference DataLoader model) instead of the "
                        "default device-resident pools + on-device "
                        "batch gather ([B] index transfers only)")
    p.add_argument("--fused_epoch", action="store_true",
                   help="one call per epoch (the train steps + the "
                        "eval scan) and one readback group after it; "
                        "requires device-resident pools")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel ranks, spawned by this CLI: 0 = "
                        "every visible card (one rank with --cpu); with "
                        "--cpu, W gloo ranks")


def add_cpu_flag(p: argparse.ArgumentParser) -> None:
    """``--cpu``, and ``--no_pallas`` (which ``device_from_args`` refuses),
    for every CLI of the port."""
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU: the kernels' plain PyTorch "
                        "versions (default: the card, the kernels)")
    p.add_argument("--no_pallas", action="store_true",
                   help="not in the port: use --cpu for the plain versions")


def device_from_args(a: argparse.Namespace) -> str:
    if getattr(a, "no_pallas", False):
        raise ValueError("--no_pallas: the port has no such switch; pass "
                         "--cpu to run the kernels' plain PyTorch versions")
    return "cpu" if a.cpu else "cuda"


def _common_kwargs(a: argparse.Namespace, default_points: int,
                   default_outf: str):
    return dict(
        batch_size=a.batchSize,
        num_points=a.num_points if a.num_points is not None else default_points,
        epochs=a.nepoch,
        out_dir=a.outf if a.outf is not None else default_outf,
        resume=a.model,
        dataset=a.dataset,
        seed=a.manualSeed,
        augment=a.augment,
        normalize=not a.no_normalize,
        resample=not a.no_resample,
        point_dropout=a.point_dropout,
        scan=a.scan,
        optimizer=a.optimizer,
        lr_schedule=a.lr_schedule,
        poly_power=a.poly_power,
        pallas_augment=a.pallas_augment,
        bf16=a.bf16,
        remat=a.remat,
        resume_full=a.resume_full,
        profile_dir=a.profile_dir,
        quiet=a.quiet,
        ckpt_policy=a.ckpt_policy,
        eval_every=a.eval_every,
        log_lag=a.log_lag,
        workers=a.workers,
        device_data=not a.host_data,
        fused_epoch=a.fused_epoch,
        num_devices=a.num_devices,
    )


def parse_classify_args(argv=None) -> Tuple[ClassifyConfig, str]:
    """``train_classification``'s flags -> ``(config, device)``."""
    p = argparse.ArgumentParser(description="PointNet classification "
                                "(PyTorch/CUDA)")
    _add_common_flags(p)
    a = p.parse_args(argv)
    return (ClassifyConfig(feature_transform=a.feature_transform,
                           **_common_kwargs(a, 1024, "cls")),
            device_from_args(a))


def parse_adv_perturb_args(argv=None) -> Tuple[AdvPerturbConfig, str]:
    """``train_adv_perturb``'s flags -> ``(config, device)``."""
    p = argparse.ArgumentParser(description="FGSM perturbation training "
                                "(PyTorch/CUDA)")
    _add_common_flags(p)
    p.add_argument("--epsilon", type=float, default=0.05, help="FGSM epsilon")
    p.add_argument("--attack", type=str, default="fgsm",
                   choices=("fgsm", "pgd"),
                   help="pgd = iterated projected FGSM (--attack_steps)")
    p.add_argument("--attack_steps", type=int, default=1,
                   help="PGD iterations (1 == FGSM)")
    a = p.parse_args(argv)
    return (AdvPerturbConfig(epsilon=a.epsilon, attack=a.attack,
                             attack_steps=a.attack_steps,
                             feature_transform=a.feature_transform,
                             **_common_kwargs(a, 1024, "advp")),
            device_from_args(a))


def parse_segment_args(argv=None) -> Tuple[SegmentConfig, str]:
    """``train_segmentation``'s flags -> ``(config, device)``."""
    p = argparse.ArgumentParser(description="PointNet part segmentation "
                                "(PyTorch/CUDA)")
    _add_common_flags(p)
    p.add_argument("--class_choice", type=str, default=None,
                   help="restrict to one ShapeNet category")
    a = p.parse_args(argv)
    return SegmentConfig(class_choice=a.class_choice,
                         feature_transform=a.feature_transform,
                         **_common_kwargs(a, 2048, "seg")), device_from_args(a)


def parse_adversarial_args(argv=None) -> Tuple[AdversarialConfig, str]:
    """``train_adversarial``'s flags -> ``(config, device)``."""
    p = argparse.ArgumentParser(
        description="Adversarial semi-supervised segmentation (PyTorch/CUDA)")
    _add_common_flags(p)
    p.add_argument("--class_choice", type=str, default=None)
    p.add_argument("--lambda_adv", type=float, default=0.01)
    p.add_argument("--lambda_adv_unl", type=float, default=None,
                   help="separate adversarial weight for the unlabeled "
                        "stream (Hung et al. per-stream eq. 3, e.g. "
                        "0.001); default: single lambda_adv averaged "
                        "over both streams")
    p.add_argument("--lambda_semi", type=float, default=0.1)
    p.add_argument("--threshold", type=float, default=0.2,
                   help="T_semi confidence threshold")
    p.add_argument("--labeled_ratio", type=float, default=0.5)
    p.add_argument("--lr_D", type=float, default=1e-4)
    p.add_argument("--semi_start", type=int, default=0)
    p.add_argument("--supervised_only", action="store_true",
                   help="ablation control: CE-only training on the same "
                        "labeled subset (no adv/semi/D) — the baseline "
                        "the adversarial gain is measured against")
    p.add_argument("--self_training", action="store_true",
                   help="ablation control: D-free semi-supervised "
                        "baseline — pseudo-label mask from the "
                        "generator's own confidence (max softmax > "
                        "--threshold) instead of the discriminator; "
                        "no adv term, no D")
    p.add_argument("--paired_heads", dest="paired_heads",
                   action="store_true", default=True,
                   help="batch the T-Net fc heads across the labeled and "
                        "unlabeled streams; BN statistics stay per-stream. "
                        "DEFAULT ON")
    p.add_argument("--no_paired_heads", dest="paired_heads",
                   action="store_false",
                   help="run the two streams' T-Net heads sequentially")
    p.add_argument("--paired_trunks", action="store_true",
                   help="batch the conv trunks across the two streams too "
                        "(per-stream BN statistics); requires paired heads")
    p.add_argument("--paired_conv1", action="store_true",
                   help="batch the per-point conv1 layers across the two "
                        "streams (grouped per-stream BN1 statistics — "
                        "exact sequential semantics); requires paired "
                        "heads")
    p.add_argument("--fused_forward", action="store_true",
                   help="one combined G forward over [labeled; unlabeled] "
                        "(BN stats over the combined batch)")
    p.add_argument("--d_geometry", action="store_true",
                   help="EXTENSION: append xyz coordinates to the "
                        "discriminator input so it can judge "
                        "label-geometry consistency (the reference's "
                        "pointwise D sees probabilities only)")
    a = p.parse_args(argv)
    for flag in ("paired_trunks", "paired_conv1"):
        if getattr(a, flag) and (not a.paired_heads or a.fused_forward):
            p.error(f"--{flag} requires the paired-heads path "
                    "(drop --no_paired_heads / --fused_forward)")
    return AdversarialConfig(
        class_choice=a.class_choice,
        feature_transform=a.feature_transform,
        lambda_adv=a.lambda_adv,
        lambda_adv_unl=a.lambda_adv_unl,
        lambda_semi=a.lambda_semi,
        semi_threshold=a.threshold,
        supervised_only=a.supervised_only,
        self_training=a.self_training,
        paired_heads=a.paired_heads,
        paired_trunks=a.paired_trunks,
        paired_conv1=a.paired_conv1,
        fused_forward=a.fused_forward,
        d_geometry=a.d_geometry,
        labeled_ratio=a.labeled_ratio,
        lr_d=a.lr_D,
        semi_start=a.semi_start,
        **_common_kwargs(a, 2048, "adv"),
    ), device_from_args(a)
