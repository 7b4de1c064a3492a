"""Config 4: adversarial semi-supervised segmentation, the G+D step.

Counterpart of ``adversarial_learning_on_pointclouds_tpu/train/
adversarial.py`` (``create_state``, ``make_txs``, ``_g_loss_fn``,
``_d_loss_fn``, ``train_step``), after Hung et al. (arXiv:1802.07934).
Each step is two updates, in this order:

1. **G step**, D frozen: ``L_G = L_ce(pred_l, y_l) + 0.001 * ortho reg +
   lambda_adv * BCE(D(softmax(pred)), real) + lambda_semi * L_semi(pred_u,
   D(softmax(pred_u)))``; D's forward runs with the input-gradient-only
   backward, so D's parameters get no gradient.
2. **D step**, G detached: ``L_D = BCE(D(one_hot(y_l)), real) +
   BCE(D(softmax(pred)), fake)``. The fake logits are the G step's,
   reused (exact against D's pre-update parameters, so D is updated
   last): the fakes run only the weight-gradient backward, the reals a
   forward and the weight-gradient backward. Where the discriminator runs
   layer by layer (below) there are no known logits: one D pass over the
   stacked ``[fake_l; fake_u; real]``, as the JAX package's.

Both nets take Adam (G's optimizer and schedule from the config, D
always Adam). On a CUDA device the generator's training kernels and the
discriminator kernels run; on the CPU their plain versions.
``cfg.bf16`` runs both updates under ``core.mixed_precision``,
``cfg.pallas_augment`` augments both streams with one
``augment_fused_pair`` launch keyed by the device step count,
``cfg.paired_trunks`` batches the generator's trunks across the two
streams, and ``train_steps_scan`` takes K steps on K batches in one
call, as ``bench.py`` runs the JAX package's step.

The JAX package's ablation controls and batching knobs:
``cfg.supervised_only`` trains G on the labeled stream's cross-entropy
alone (one single-stream forward, no D); ``cfg.self_training`` takes the
semi mask from G's own confidence (``losses.self_train_loss``) and runs
no D; under either control D is neither run nor updated (its parameters,
Adam moments and schedule stay as they are, ``loss_d`` is 0).
``cfg.d_geometry`` feeds D ``[probs; xyz]`` (``k + 3`` channels; the
reals carry the labeled stream's coordinates). ``cfg.fused_forward``
runs one G forward over ``[x_l; x_u]`` (BN statistics of the combined
batch) and one frozen D pass; ``cfg.paired_conv1`` batches the conv1
layers across the streams (``models/segmenter.forward_pair``).
Under ``ops.dispatch.use_pallas_train`` (``bench.py --pallas_train``) the
generator takes the per-layer training kernels; at a point count the JAX
package's fused kernels cannot tile (``ops.dispatch.layer_by_layer``) the
generator's trunks and seg head and the discriminator run layer by
layer, through ``pointwise_matmul`` and ``maxpool_points``.

    cfg = AdversarialConfig(); g_tx, d_tx = make_txs(cfg, steps_per_epoch)
    state = create_state(cfg, steps_per_epoch)        # on the card
    metrics = train_step(state, x_l, y_l, x_u, cfg=cfg, g_tx=g_tx,
                         d_tx=d_tx)
    metrics = train_steps_scan(state, x_l_k, y_l_k, x_u_k, cfg=cfg,
                               g_tx=g_tx, d_tx=d_tx)   # [K, ...] batches

``train_step_gather`` and ``train_steps_scan_gather`` take the batches'
rows from device-resident pools by index, as the runner's default data
path does; ``epoch_program`` runs a whole epoch, its G+D steps and G's
eval scan, in one call (``--fused_epoch``).

Under data parallelism (``parallel/dist.py``) ``train_step`` takes the
rank's rows of both streams: every loss term is the rank's share of the
global one, G's gradients and metrics are summed over the ranks in one
bucket before G's optimizer step and D's with ``loss_d`` before D's, so
every rank takes the same two updates and returns the global metrics;
the gather forms take the global index plans and keep the rank's
columns.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from adversarial_learning_on_pointclouds_tpu_torch import losses
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.data import augment
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    FCDiscriminator, PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch as ops
from adversarial_learning_on_pointclouds_tpu_torch.parallel import dist
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    segment, state as state_lib,
)


def make_txs(cfg: AdversarialConfig, steps_per_epoch: int
             ) -> Tuple[state_lib.Optimizer, state_lib.Optimizer]:
    """G's optimizer from ``cfg.optimizer`` / ``cfg.lr_schedule``, and D's,
    which is Adam at ``lr_d``, ``beta1_d``, ``beta2_d`` in either case."""
    total = cfg.epochs * steps_per_epoch
    g_tx = state_lib.make_optimizer(
        cfg.lr, cfg.beta1, cfg.beta2, cfg.lr_step, cfg.lr_gamma,
        steps_per_epoch, optimizer=cfg.optimizer,
        lr_schedule=cfg.lr_schedule, total_steps=total,
        poly_power=cfg.poly_power)
    d_tx = state_lib.make_optimizer(
        cfg.lr_d, cfg.beta1_d, cfg.beta2_d, cfg.lr_step, cfg.lr_gamma,
        steps_per_epoch, optimizer="adam", lr_schedule=cfg.lr_schedule,
        total_steps=total, poly_power=cfg.poly_power)
    return g_tx, d_tx


def create_state(cfg: AdversarialConfig, steps_per_epoch: int,
                 device="cuda", g_model: Optional[PointNetDenseCls] = None,
                 d_model: Optional[FCDiscriminator] = None
                 ) -> state_lib.GANTrainState:
    """A train-mode generator and a discriminator seeded from ``cfg.seed``
    (or the given models), on ``device`` (the card unless the caller asks
    for the CPU), their optimizers, an augmentation generator on the
    device seeded from ``cfg.seed`` and the device step count."""
    device = state_lib.train_device(device)
    init = torch.Generator().manual_seed(cfg.seed)
    if g_model is None:
        g_model = PointNetDenseCls(cfg.num_parts, cfg.feature_transform,
                                   generator=init)
    if d_model is None:
        d_model = FCDiscriminator(cfg.num_parts + (3 if cfg.d_geometry else 0),
                                  generator=init)
    g_model.to(device).train()
    d_model.to(device).train()
    g_tx, d_tx = make_txs(cfg, steps_per_epoch)
    g_opt, g_sched = g_tx.init(g_model.parameters())
    d_opt, d_sched = d_tx.init(d_model.parameters())
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    state_lib.replicate(g_model, d_model)
    return state_lib.GANTrainState(
        g_model, d_model, g_tx, d_tx, g_opt, g_sched, d_opt, d_sched, gen,
        device_step=torch.zeros((), dtype=torch.int64, device=device))


def d_in(probs: torch.Tensor, xyz: torch.Tensor, on: bool) -> torch.Tensor:
    """D's input map: the class probabilities, with ``cfg.d_geometry``
    (``on``) the points' (augmented) coordinates concatenated on the
    channel axis, ``[B, N, k + 3]``, in the probabilities' dtype. The
    coordinates are data, so the gradient still reaches G only through
    ``probs``."""
    if not on:
        return probs
    return torch.cat([probs, xyz.to(probs.dtype)], dim=-1)


def g_loss_fn(g_model: PointNetDenseCls, d_model: FCDiscriminator,
              x_l: torch.Tensor, y_l: torch.Tensor, x_u: torch.Tensor,
              cfg: AdversarialConfig, semi_on
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The generator's objective and what the D step needs: ``(total,
    aux)`` with ``aux`` holding the loss terms and ``logp_l`` and, where D
    ran, the probability maps and D's logits on them. The forwards, in
    the JAX package's order of precedence:

    * ``cfg.supervised_only``: one single-stream train-mode forward of
      ``x_l``, cross-entropy (and the ortho reg), nothing else;
    * ``cfg.fused_forward``: one forward over ``[x_l; x_u]`` (BN over the
      combined 2B batch, the ortho reg of the 2B transforms doubled) and
      one frozen D pass over both streams, its logits split at B;
    * ``cfg.paired_heads``: ``forward_pair`` (``cfg.paired_trunks``,
      ``cfg.paired_conv1``);
    * else two sequential forwards, labeled then unlabeled.

    Running statistics chain labeled -> unlabeled. ``cfg.self_training``
    runs no D: L_semi is ``losses.self_train_loss`` and there is no adv
    term. ``semi_on`` (0 or 1, a float or a device scalar) switches
    L_semi."""
    if cfg.supervised_only:
        logp_l, _, tf_l = g_model(x_l)
        l_ce = losses.nll_loss(logp_l, y_l)
        if cfg.feature_transform:
            l_ce = l_ce + losses.FT_REG_WEIGHT * losses.orthogonality_reg(tf_l)
        zero = torch.zeros((), dtype=logp_l.dtype, device=logp_l.device)
        return l_ce, dict(l_ce=l_ce, l_adv=zero, l_semi=zero, logp_l=logp_l)

    need_d = not cfg.self_training
    b = x_l.shape[0]
    if cfg.fused_forward:
        xb = torch.cat([x_l, x_u])
        logp, _, tf_b = g_model(xb)
        logp_l, logp_u = logp[:b], logp[b:]
        probs = logp.exp()
        probs_l, probs_u = probs[:b], probs[b:]
        if need_d:
            d_out = d_model.frozen(d_in(probs, xb, cfg.d_geometry))
            d_l, d_u = d_out[:b], d_out[b:]
    else:
        if cfg.paired_heads:
            logp_l, logp_u, tf_l, tf_u = g_model.forward_pair(
                x_l, x_u, cfg.paired_trunks, cfg.paired_conv1)
        else:
            logp_l, _, tf_l = g_model(x_l)
            logp_u, _, tf_u = g_model(x_u)
        probs_l, probs_u = logp_l.exp(), logp_u.exp()
        if need_d:
            d_l = d_model.frozen(d_in(probs_l, x_l, cfg.d_geometry))
            d_u = d_model.frozen(d_in(probs_u, x_u, cfg.d_geometry))
    l_ce = losses.nll_loss(logp_l, y_l)
    if cfg.feature_transform:
        reg = (2.0 * losses.orthogonality_reg(tf_b) if cfg.fused_forward
               else losses.orthogonality_reg(tf_l)
               + losses.orthogonality_reg(tf_u))
        l_ce = l_ce + losses.FT_REG_WEIGHT * reg
    if cfg.self_training:
        l_semi = losses.self_train_loss(logp_u, cfg.semi_threshold)
        total = l_ce + semi_on * cfg.lambda_semi * l_semi
        zero = torch.zeros((), dtype=logp_l.dtype, device=logp_l.device)
        return total, dict(l_ce=l_ce, l_adv=zero, l_semi=l_semi,
                           logp_l=logp_l, probs_u=probs_u)
    adv_l, adv_u = losses.adv_g_loss(d_l), losses.adv_g_loss(d_u)
    l_adv = 0.5 * (adv_l + adv_u)
    if cfg.lambda_adv_unl is None:
        adv_term = cfg.lambda_adv * l_adv
    else:
        adv_term = cfg.lambda_adv * adv_l + cfg.lambda_adv_unl * adv_u
    l_semi = losses.semi_loss(logp_u, d_u, cfg.semi_threshold)
    total = l_ce + adv_term + semi_on * cfg.lambda_semi * l_semi
    aux = dict(probs_l=probs_l, probs_u=probs_u, d_l=d_l, d_u=d_u, l_ce=l_ce,
               l_adv=l_adv, l_semi=l_semi, logp_l=logp_l)
    return total, aux


def d_loss_fn(d_model: FCDiscriminator, probs_l: torch.Tensor,
              probs_u: torch.Tensor, y_l: torch.Tensor, num_parts: int,
              fake_logits: Optional[torch.Tensor] = None,
              xyz: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The discriminator's objective on detached predictions (fake) and
    one-hot labels (real): ``(loss, (d_real, d_fake))``. With
    ``fake_logits``, which D made from the fakes ``[2B, N, k]`` with its
    current parameters in the G step, the fakes run only the
    weight-gradient backward and the reals a forward and the
    weight-gradient backward; without, one D pass over the stacked
    ``[fake_l; fake_u; real]``, split at ``2B``. With ``xyz``, the
    streams' coordinates ``(x_l, x_u)`` (``cfg.d_geometry``), every map
    carries its points' coordinates (``d_in``): the reals the labeled
    stream's."""
    real = torch.nn.functional.one_hot(y_l.long(), num_parts).to(
        probs_l.dtype)
    if xyz is not None:
        x_l, x_u = xyz
        probs_l, probs_u = d_in(probs_l, x_l, True), d_in(probs_u, x_u, True)
        real = d_in(real, x_l, True)
    if fake_logits is None:
        b = probs_l.shape[0]
        d_all = d_model(torch.cat([probs_l, probs_u, real]).detach())
        d_fake, d_real = d_all[:2 * b], d_all[2 * b:]
    else:
        fake = torch.cat([probs_l, probs_u]).detach()
        d_fake = d_model.with_known_logits(fake, fake_logits.detach())
        d_real = d_model.detached(real)
    return losses.d_loss(d_real, d_fake), (d_real, d_fake)


def train_step(state: state_lib.GANTrainState, x_l: torch.Tensor,
               y_l: torch.Tensor, x_u: torch.Tensor, *,
               cfg: AdversarialConfig, g_tx: state_lib.Optimizer,
               d_tx: state_lib.Optimizer) -> Dict[str, torch.Tensor]:
    """One G update, then one D update, on ``x_l [B, N', 3]`` with part
    labels ``y_l [B, N']`` and unlabeled ``x_u [B, N', 3]`` on the models'
    device: the augmentation chain per stream (labels ride the resample),
    the G step and the D step as the module docstring says. Returns
    ``loss_g``, ``loss_ce``, ``loss_adv``, ``loss_semi``, ``loss_d`` and
    ``acc`` (on the labeled stream) as device scalars; each net's
    gradients stay in ``.grad`` until the next step. ``g_tx`` / ``d_tx``
    are the ``make_txs`` the state was built with; any other raises.
    Both updates run under ``cfg.bf16``'s mixed-precision scope; the semi
    switch is ``device_step >= cfg.semi_start`` on the device, and
    ``augment_fused`` (``cfg.pallas_augment``) is keyed by the device
    step, stream 0 labeled and 1 unlabeled, both streams in one
    ``augment_fused_pair`` launch. Under ``cfg.supervised_only`` or
    ``cfg.self_training`` there is no D step: D's parameters, gradients,
    Adam moments and schedule stay as they are and ``loss_d`` is 0."""
    if (g_tx, d_tx) != (state.g_tx, state.d_tx):
        raise ValueError(f"train_step got {(g_tx, d_tx)}, but the state was "
                         f"built with {(state.g_tx, state.d_tx)}")
    (x_l, y_l), x_u = augment.chain_pair_from_cfg(
        state.generator, cfg, (x_l, y_l), (x_u, None), state.device_step)
    layerwise = ops.layer_by_layer(x_l.shape[1])
    semi_on = (state.device_step >= cfg.semi_start).float()

    with core.mixed_precision(enabled=cfg.bf16):
        state.g_optimizer.zero_grad(set_to_none=True)
        g_loss, aux = g_loss_fn(state.g_model, state.d_model, x_l, y_l, x_u,
                                cfg, semi_on)
        g_loss.backward()
        acc = dist.mean_share(
            (aux["logp_l"].detach().argmax(-1) == y_l).float())
        metrics = dist.all_reduce_grads(state.g_model.parameters(), {
            "loss_g": g_loss.detach(), "loss_ce": aux["l_ce"].detach(),
            "loss_adv": aux["l_adv"].detach(),
            "loss_semi": aux["l_semi"].detach(), "acc": acc})
        state.g_optimizer.step()
        state.g_scheduler.step()

        if cfg.supervised_only or cfg.self_training:
            loss_d = torch.zeros_like(g_loss)
        else:
            state.d_optimizer.zero_grad(set_to_none=True)
            d_loss, _ = d_loss_fn(
                state.d_model, aux["probs_l"], aux["probs_u"], y_l,
                cfg.num_parts,
                None if layerwise else torch.cat([aux["d_l"], aux["d_u"]]),
                (x_l, x_u) if cfg.d_geometry else None)
            d_loss.backward()
            loss_d = dist.all_reduce_grads(
                state.d_model.parameters(),
                {"loss_d": d_loss.detach()})["loss_d"]
            state.d_optimizer.step()
            state.d_scheduler.step()

    state.step += 1
    state.device_step += 1
    return {"loss_g": metrics["loss_g"], "loss_ce": metrics["loss_ce"],
            "loss_adv": metrics["loss_adv"],
            "loss_semi": metrics["loss_semi"], "loss_d": loss_d,
            "acc": metrics["acc"]}


def train_steps_scan(state: state_lib.GANTrainState, x_l: torch.Tensor,
                     y_l: torch.Tensor, x_u: torch.Tensor, *,
                     cfg: AdversarialConfig, g_tx: state_lib.Optimizer,
                     d_tx: state_lib.Optimizer) -> Dict[str, torch.Tensor]:
    """K G+D steps on K distinct batches, ``x_l [K, B, N', 3]``, ``y_l [K,
    B, N']``, ``x_u [K, B, N', 3]``, in order: the counterpart of the JAX
    package's ``lax.scan`` of its step (``--scan K``), as a loop of
    ``train_step`` calls. Returns each metric stacked over K. With
    ``cfg.scan`` set (K > 0), batches of another K raise."""
    if cfg.scan and x_l.shape[0] != cfg.scan:
        raise ValueError(f"train_steps_scan got {x_l.shape[0]} batches, but "
                         f"cfg.scan is {cfg.scan}")
    return state_lib.stack_metrics([
        train_step(state, x_l[k], y_l[k], x_u[k], cfg=cfg, g_tx=g_tx,
                   d_tx=d_tx) for k in range(x_l.shape[0])])


def train_step_gather(state: state_lib.GANTrainState, pool_x: torch.Tensor,
                      pool_y: torch.Tensor, pool_u: torch.Tensor,
                      idx_l: torch.Tensor, idx_u: torch.Tensor, *,
                      cfg: AdversarialConfig, g_tx: state_lib.Optimizer,
                      d_tx: state_lib.Optimizer) -> Dict[str, torch.Tensor]:
    """``train_step`` on device-resident data pools: the host sends only
    the ``[B]`` int32 index vectors of the labeled (``idx_l`` into
    ``pool_x`` / ``pool_y``) and unlabeled (``idx_u`` into ``pool_u``)
    streams, and the rows are selected on the device (``index_select``),
    so the step sees the same rows as ``train_step`` on gathered host
    batches. Under data parallelism the index vectors are the global
    batch's and each rank gathers its rows."""
    idx_l, idx_u = dist.shard_rows(idx_l), dist.shard_rows(idx_u)
    return train_step(state, pool_x.index_select(0, idx_l),
                      pool_y.index_select(0, idx_l),
                      pool_u.index_select(0, idx_u), cfg=cfg, g_tx=g_tx,
                      d_tx=d_tx)


def train_steps_scan_gather(state: state_lib.GANTrainState,
                            pool_x: torch.Tensor, pool_y: torch.Tensor,
                            pool_u: torch.Tensor, idx_l: torch.Tensor,
                            idx_u: torch.Tensor, *, cfg: AdversarialConfig,
                            g_tx: state_lib.Optimizer,
                            d_tx: state_lib.Optimizer
                            ) -> Dict[str, torch.Tensor]:
    """K steps of ``train_step_gather`` on ``[K, B]`` index rows, in
    order, each metric stacked over K."""
    return state_lib.stack_metrics([
        train_step_gather(state, pool_x, pool_y, pool_u, il, iu, cfg=cfg,
                          g_tx=g_tx, d_tx=d_tx)
        for il, iu in zip(idx_l, idx_u)])


def epoch_program(state: state_lib.GANTrainState, pool_x: torch.Tensor,
                  pool_y: torch.Tensor, pool_u: torch.Tensor,
                  idx_l: torch.Tensor, idx_u: torch.Tensor,
                  te_x: torch.Tensor, te_s: torch.Tensor, te_c: torch.Tensor,
                  te_idx: torch.Tensor, *, cfg: AdversarialConfig,
                  g_tx: state_lib.Optimizer, d_tx: state_lib.Optimizer
                  ) -> Tuple[Dict[str, torch.Tensor],
                             Dict[str, torch.Tensor]]:
    """A whole epoch in one call (``--fused_epoch``): ``spe`` G+D steps of
    ``train_step_gather`` on the ``[spe, B]`` index tensors ``idx_l`` /
    ``idx_u``, then ``segment.eval_scan`` of G over the device-resident
    test pools ``te_x`` / ``te_s`` / ``te_c`` by the ``[S, B]`` plan
    ``te_idx``, in ``cfg.bf16``'s mixed-precision scope (the JAX
    package's ``epoch_program``). The state is updated in place; returns
    ``(metrics [spe], eval_outs)`` on the device, for one readback group
    after the call. Nothing inside reads the device back or copies from
    the host."""
    ms = train_steps_scan_gather(state, pool_x, pool_y, pool_u, idx_l,
                                 idx_u, cfg=cfg, g_tx=g_tx, d_tx=d_tx)
    with core.mixed_precision(enabled=cfg.bf16):
        ev = segment.eval_scan(state.g_model, te_x, te_s, te_c, te_idx)
    return ms, ev
