"""The G+D step as ``bench.py`` runs it, port against the JAX package:
bf16 mixed precision and K steps per call.

* Each training and discriminator pass's plain twin with ``bf16=True``
  against the JAX pass (its ``pallas_call`` wrapper, in interpret mode)
  under ``core.mixed_precision()``, on the same inputs: the stashes are
  bf16 on both sides, and where the two programs sum the same bf16
  products in another order an fp32 value on a rounding boundary rounds
  to the neighbouring bf16 value, so a stash element may sit one bf16
  step (2^-7 of it at most) away; every other output within
  ``PASS_RTOL`` (1e-3) of its scale: one operand that rounds to the other
  side moves a sum by one bf16 step of one term, and at these widths a
  term can carry a tenth of the sum, 2^-8 / 10 = 4e-4.
* The generator and discriminator objectives under the scope against the
  JAX package's on its jnp path under ``core.mixed_precision()``
  (``_g_loss_fn``, ``_d_loss_fn``): that path rounds the same matmul
  operands but keeps its activations in fp32 where the port's passes
  keep bf16 stashes, so the two differ by bf16 rounding, and this model
  carries bf16 rounding far at a batch of 8 (the T-Net heads' batch
  BatchNorms, the max-pools' winners, the pseudo-labels' argmax: the JAX
  package's own bf16 and fp32 G gradients differ by a large part of
  their norm in places). Each loss, map and gradient is held to the
  larger of the fp32 step's bound (5e-3 scale-relative; 2e-2 * (1 +
  max|g|)) and twice what bf16 rounding moves it by in the JAX package
  (its bf16 objective against its fp32 one).
* Each plain op that the scope must round between the passes (conv1's
  ``linear_bn_act``, the T-Net fc layers' ``core.dense``, the ``x @ T``
  transforms, ``_Trunk2.backward``'s ``dx`` / ``dw2`` and the pool-fc
  backward's ``dw1``), port under ``core.mixed_precision()`` against the
  JAX op under its scope: output and gradients within ``PASS_RTOL`` of
  their own scale (no floor at 1). The step-level bounds above cannot
  tell bf16 from fp32, so these are what would catch a missing rounding:
  the control leaves one such op in fp32 and must land above the bound
  (bf16 rounding moves these ops by 3e-3 to 5e-2 of their scale).
* A planted check that bf16 ran: the port's fp32 and bf16 objectives
  differ, as the JAX package's own tests require of its scope.
* ``train_steps_scan`` at K=2 equals two ``train_step`` calls, and equals
  the JAX ``train_steps_scan`` on the same batches with augmentation off
  (fp32, per-step metrics at the fp32 step's 5e-3).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.configs import (
    AdversarialConfig as JaxAdversarialConfig,
)
from adversarial_learning_on_pointclouds_tpu.data import augment as jax_augment
from adversarial_learning_on_pointclouds_tpu.models import (
    core as jax_core, init_discriminator, init_segmenter,
)
from adversarial_learning_on_pointclouds_tpu.ops import dispatch as jax_ops
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    disc_fused as jax_disc, pool_fc_epilogue as jax_pool,
    seg_head_train as jax_head, trunk_train as jax_trunk,
)
from adversarial_learning_on_pointclouds_tpu.train import (
    adversarial as jax_adv, state as jax_state,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    FCDiscriminator, PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    disc_fused, pool_fc_epilogue, seg_head_train, trunk_train,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import adversarial
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert

PASS_RTOL = 1e-3
STEP_RTOL = 5e-3
GRAD_TOL = 2e-2
YARD = 2.0
N, PARTS = 128, 50


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _close(a, b, rtol):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=rtol * max(np.abs(b).max(), 1.0),
                               rtol=0)


def _stash_close(a, b):
    """bf16 on both sides; equal, or one bf16 step apart."""
    assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
    a, b = _np(a), _np(b)
    step = np.abs(b) * 2.0 ** -7
    scale = max(np.abs(b).max(), 1.0)
    assert (np.abs(a - b) <= np.maximum(step, 1e-4 * scale)).all()


def _pass_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32

    def r(*s, scale=0.2):
        return (rng.standard_normal(s) * scale).astype(f)

    def pos(*s):
        return rng.uniform(0.5, 1.5, s).astype(f)

    def bf(a):   # a value that a bf16 stash holds exactly
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    return r, pos, bf


def _to_port(a):
    if isinstance(a, np.ndarray) or not hasattr(a, "dtype"):
        return torch.from_numpy(np.asarray(a))
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _cases():
    """pass -> (port function, JAX function, inputs as numpy / jnp)."""
    r, pos, bf = _pass_inputs()
    n, c1, c2, c3 = 130, 16, 32, 64
    idx = np.random.default_rng(1).integers(0, n, (2, c3)).astype(np.int32)
    z2 = jnp.asarray(bf(r(2, n, c2, scale=1.0)), jnp.bfloat16)
    trunk_b1 = (z2, pos(c2), r(c2), r(c2, c3), r(c3), r(c3), pos(c3),
                r(2, c3, scale=1e-3), r(2, c3, scale=1e-3), r(2, c3, scale=1.0),
                idx, r(c2), pos(c2))
    cpf, h1, h2, h3, k = 16, 64, 48, 32, 10
    zs = [jnp.asarray(bf(r(2, n, c, scale=1.0)), jnp.bfloat16)
          for c in (h1, h2, h3)]
    dys = [jnp.asarray(bf(r(2, n, c)), jnp.bfloat16) for c in (h1, h2, h3)]
    ws = [r(2, n, k, scale=1.0)]
    x_d = np.asarray(jax.nn.softmax(jnp.asarray(r(2, n, PARTS, scale=3.0))))
    d_w = [r(ci, co) for ci, co in ((PARTS, 64), (64, 128), (128, 256),
                                    (256, 512), (512, 1))]
    d_b = [r(c, scale=0.1) for c in (64, 128, 256, 512, 1)]
    g_d = r(2, n, 1, scale=1.0)
    mx = r(8, 64, scale=1.0)
    return {
        "trunk_F1": (trunk_train.f1_plain, jax_trunk._f1_call,
                     (r(2, n, c1, scale=1.0), r(c1, c2), r(c2))),
        "trunk_F2": (trunk_train.f2_plain, jax_trunk._f2_call,
                     (z2, pos(c2), r(c2), r(c2, c3), r(c3))),
        "trunk_B1": (trunk_train.b1_plain, jax_trunk._b1_call, trunk_b1),
        "head_P1": (seg_head_train.p1_plain, jax_head._p1_call,
                    (r(2, n, cpf, scale=1.0), r(2, h1), r(cpf, h1), r(h1))),
        "head_Pmid": (seg_head_train.pmid_plain, jax_head._pmid_call,
                      (zs[0], pos(h1), r(h1), r(h1, h2), r(h2))),
        "head_P4": (seg_head_train.p4_plain, jax_head._p4_call,
                    (zs[2], pos(h3), r(h3), r(h3, k), r(k))),
        "head_B4": (seg_head_train.b4_plain, jax_head._b4_call,
                    (zs[2], pos(h3), r(h3), r(h3, k), r(k), r(h3), pos(h3),
                     ws[0])),
        "head_Bmid": (seg_head_train.bmid_plain, jax_head._bmid_call,
                      (zs[1], dys[1], pos(h2), r(h2), pos(h2),
                       r(h2, scale=1e-2), r(h2, scale=1e-2), zs[0], pos(h1),
                       r(h1), r(h1, h2), r(h1), pos(h1))),
        "head_B1": (seg_head_train.b1_plain, jax_head._b1_call,
                    (zs[0], dys[0], pos(h1), r(h1), pos(h1),
                     r(h1, scale=1e-2), r(h1, scale=1e-2),
                     r(2, n, cpf, scale=1.0), r(cpf, h1))),
        "pool_fc": (pool_fc_epilogue.pool_fc_fwd_plain, jax_pool._fwd_call,
                    (mx, mx - 0.5, r(64, scale=1.0), r(64), r(64, 32), r(32),
                     pos(32), r(32), r(32), 2)),
        "disc_fwd": (disc_fused.disc_fwd_plain, jax_disc._fwd_call,
                     (x_d, d_w, d_b)),
        "disc_bwd": (disc_fused.disc_bwd_plain, jax_disc._bwd_call,
                     (x_d, g_d, d_w, d_b)),
        "disc_bwd_dx": (disc_fused.disc_bwd_dx_plain, jax_disc._bwd_dx_call,
                        (x_d, g_d, d_w, d_b)),
        "disc_bwd_dw": (disc_fused.disc_bwd_dw_plain, jax_disc._bwd_dw_call,
                        (x_d, g_d, d_w, d_b)),
    }


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


@pytest.mark.parametrize("name", sorted(_cases()))
def test_bf16_pass_matches_jax(name):
    port_fn, jax_fn, inputs = _cases()[name]
    with jax_core.mixed_precision():
        ref = jax_fn(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                       else [jnp.asarray(w) for w in a]
                       if isinstance(a, list) else a for a in inputs])
    got = port_fn(*[[_to_port(w) for w in a] if isinstance(a, list)
                    else a if isinstance(a, int) else _to_port(a)
                    for a in inputs], bf16=True)
    got, ref = _flat(got), _flat(ref)
    if name == "pool_fc":      # JAX returns (h1, h, z1, mu, var, inv) too
        ref = ref[:6]
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if b.dtype == jnp.bfloat16:
            _stash_close(a, b)
        elif b.dtype == jnp.int32:            # F2's winners
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).reshape(
                a.shape))
        else:
            assert a.dtype == torch.float32, (name, a.dtype)
            _close(a.reshape(b.shape), b, PASS_RTOL)


def test_bf16_stashes_are_bf16():
    """Under the scope the autograd functions keep bf16 stashes: the
    trunk's z2, the head's z1/z2/z3; their passes' ``dy3`` and the Bmid
    ``dy_prev`` are bf16, the trunk's ``dy2`` and the head's ``dpf``
    fp32. Out of the scope every stash is fp32."""
    r, pos, _ = _pass_inputs(3)
    x = torch.from_numpy(r(2, 64, 16, scale=1.0)).requires_grad_()
    trunk = [torch.from_numpy(a) for a in (
        r(16, 32), r(32), pos(32), r(32), r(32, 64), r(64), pos(64), r(64))]
    head = [torch.from_numpy(a) for a in (
        r(80, 48), r(48), pos(48), r(48), r(48, 32), r(32), pos(32), r(32),
        r(32, 24), r(24), pos(24), r(24), r(24, 10), r(10))]
    for bf16 in (False, True):
        want = torch.bfloat16 if bf16 else torch.float32
        with core.mixed_precision(enabled=bf16):
            g = trunk_train.trunk2_train(x, *trunk)[0]
            logp = seg_head_train.seg_head_train(x, g, *head)[0]
        assert g.grad_fn.saved_tensors[1].dtype == want          # z2
        assert [t.dtype for t in logp.grad_fn.saved_tensors[2:5]] == \
            [want] * 3                                           # z1..z3
        logp.sum().backward()
        assert x.grad.dtype == torch.float32
        x.grad = None
    z3 = torch.from_numpy(r(2, 64, 24)).to(torch.bfloat16)
    out = seg_head_train.b4(z3, *(torch.from_numpy(a) for a in (
        pos(24), r(24), r(24, 10), r(10), r(24), pos(24), r(2, 64, 10))),
        bf16=True)
    assert out[0].dtype == torch.bfloat16


class _Layer:
    """A ``Conv1d`` / ``Linear`` stand-in over a differentiable ``[in,
    out]`` weight, as ``core.dense`` reads one."""

    def __init__(self, w, b):
        self.weight, self.bias = w.t()[:, :, None], b


def _site_cases():
    """site -> (port op, JAX op, numpy inputs, the inputs whose gradients
    are compared); the ops return one tensor."""
    rng = np.random.default_rng(11)
    f = np.float32

    def r(*s, scale=0.2):
        return (rng.standard_normal(s) * scale).astype(f)

    gam, bet = rng.uniform(0.5, 1.5, 64).astype(f), r(64, scale=0.1)
    jax_bn = ({"scale": jnp.asarray(gam), "bias": jnp.asarray(bet)},
              {"mean": jnp.zeros(64), "var": jnp.ones(64)})

    def port_conv1(x, w, b):
        bn = torch.nn.BatchNorm1d(64).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(gam))
            bn.bias.copy_(torch.from_numpy(bet))
        return dispatch.linear_bn_act(_Layer(w, b), bn, x)

    def jax_conv1(x, w, b):
        return jax_ops.linear_bn_act({"w": w, "b": b}, *jax_bn, x, True)[0]

    def port_dense(h, w, b):
        return core.dense(_Layer(w, b), h)

    def jax_dense(h, w, b):
        return jax_core.dense({"w": w, "b": b}, h)

    def pos(*s):
        return rng.uniform(0.5, 1.5, s).astype(f)

    trunk = (r(2, 130, 16, scale=1.0), r(16, 32), r(32, scale=0.1), pos(32),
             r(32, scale=0.1), r(32, 64), r(64, scale=0.1),
             pos(64) * np.where(rng.random(64) < 0.3, -1, 1).astype(f),
             r(64, scale=0.1))
    pool = (r(8, 64, scale=1.0), r(64, 32), r(32, scale=0.1), pos(32),
            r(32, scale=0.1))
    rm1 = r(32, scale=0.3)
    eye = np.eye(16, dtype=f)
    return {
        "conv1": (port_conv1, jax_conv1, (r(2, 130, 3, scale=1.0),
                                          r(3, 64, scale=0.5), r(64)), (0, 1)),
        "fc2": (port_dense, jax_dense, (r(8, 64, scale=1.0), r(64, 32),
                                        r(32)), (0, 1)),
        "fc3": (port_dense, jax_dense, (r(8, 32, scale=1.0), r(32, 9),
                                        r(9)), (0, 1)),
        "x@T": (dispatch.batched_transform, jax_ops.batched_transform,
                (r(2, 130, 3, scale=1.0),
                 np.eye(3, dtype=f) + r(2, 3, 3, scale=0.3)), (0, 1)),
        "x@T_feat": (dispatch.batched_transform, jax_ops.batched_transform,
                     (r(2, 130, 16, scale=1.0), eye + r(2, 16, 16, scale=0.1)),
                     (0, 1)),
        "trunk_dx_dw2": (lambda *a: trunk_train.trunk2_train(*a)[0],
                         lambda *a: jax_trunk.trunk2_train(*a)[0],
                         trunk, (0, 1)),
        "pool_fc_dw1": (
            lambda *a: pool_fc_epilogue.relu_fc_bn_relu(
                *a, rm1=torch.from_numpy(rm1))[0],
            lambda *a: jax_pool.relu_fc_bn_relu(*a, rm1=jnp.asarray(rm1))[0],
            tuple(pool), (0, 1)),
    }


def _site_errors(name, port_bf16):
    """Output and gradient (of ``sum(sin(out))``) errors of the port op,
    in bf16 or fp32, against the JAX op under its bf16 scope, each as
    max|a - b| / max|b|."""
    port_fn, jax_fn, args, argnums = _site_cases()[name]
    j_args = [jnp.asarray(a) for a in args]
    with use_pallas(False), jax_core.mixed_precision():
        ref = jax_fn(*j_args)
        grads = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_fn(*a))),
                         argnums=argnums)(*j_args)
    t_args = [torch.from_numpy(a).requires_grad_() for a in args]
    with core.mixed_precision(enabled=port_bf16):
        got = port_fn(*t_args)
    torch.sin(got).sum().backward()

    def rel(a, b):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        return float(np.abs(a - b).max()) / float(np.abs(b).max())

    return [rel(got, ref)] + [rel(t_args[i].grad, g)
                              for i, g in zip(argnums, grads)]


@pytest.mark.parametrize("name", sorted(_site_cases()))
def test_bf16_plain_site_matches_jax(name):
    errs = _site_errors(name, True)
    assert max(errs) <= PASS_RTOL, errs


@pytest.mark.parametrize("name", ["conv1", "fc2", "fc3", "x@T", "x@T_feat"])
def test_bf16_site_left_in_fp32_fails(name):
    """Control: the same op out of the scope (that one matmul in fp32,
    the rest of the objective as it was) lands above the site bound."""
    assert max(_site_errors(name, False)) > 2 * PASS_RTOL


def _randomize_bn(tree_p, tree_s, rng):
    for key, sub in tree_p.items():
        if key.startswith("bn"):
            c = sub["scale"].shape[0]
            sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sub["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            tree_s[key] = {
                "mean": rng.normal(0, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        elif isinstance(sub, dict) and key in tree_s:
            _randomize_bn(sub, tree_s[key], rng)


@pytest.fixture(scope="module")
def models():
    return _make_models()


def _make_models():
    """G (random BatchNorm statistics) and D as numpy trees, and a batch
    of 2 x 8 x 128 points, normalized as both chains would."""
    g_params, g_state = init_segmenter(jax.random.PRNGKey(0), PARTS,
                                       feature_transform=True)
    g_params = jax.tree_util.tree_map(np.array, g_params)
    g_state = jax.tree_util.tree_map(np.asarray, g_state)
    _randomize_bn(g_params, g_state, np.random.default_rng(0))
    d_params = jax.tree_util.tree_map(
        np.array, init_discriminator(jax.random.PRNGKey(1), PARTS))
    rng = np.random.default_rng(1)
    x_l, x_u = (np.asarray(jax_augment.normalize_unit_sphere(jnp.asarray(
        rng.normal(size=(8, N, 3)).astype(np.float32)))) for _ in range(2))
    y_l = rng.integers(0, PARTS, size=(8, N)).astype(np.int32)
    return g_params, g_state, d_params, (x_l, y_l, x_u)


def _port_models(models):
    g_params, g_state, d_params, _ = models
    g = PointNetDenseCls(PARTS, feature_transform=True)
    g.load_state_dict(convert.segmenter_state_dict(g_params, g_state),
                      strict=True)
    d = FCDiscriminator(PARTS)
    d.load_state_dict(convert.discriminator_state_dict(d_params), strict=True)
    return g.train(), d


def _port_objectives(models, bf16):
    g, d = _port_models(models)
    x_l, y_l, x_u = (torch.from_numpy(np.array(a)) for a in models[3])
    cfg = AdversarialConfig(num_points=N, batch_size=8, bf16=bf16)
    with core.mixed_precision(enabled=bf16):
        total, aux = adversarial.g_loss_fn(g, d, x_l, y_l.long(), x_u, cfg,
                                           1.0)
        total.backward()
        d.zero_grad()
        d_loss, _ = adversarial.d_loss_fn(
            d, aux["probs_l"], aux["probs_u"], y_l, PARTS,
            torch.cat([aux["d_l"], aux["d_u"]]))
        d_loss.backward()
    return total, aux, d_loss, g, d


@pytest.fixture(scope="module")
def port_objectives(models):
    """``port_objectives(bf16)``: ``_port_objectives(models, bf16)``, made
    once for the module (the tests only read it)."""
    made = {}

    def get(bf16):
        if bf16 not in made:
            made[bf16] = _port_objectives(models, bf16)
        return made[bf16]
    return get


@pytest.fixture(scope="module")
def jax_objectives(models):
    """The JAX objectives and gradients on the jnp path, ``{bf16: ...}``."""
    return {bf16: _jax_objectives(models, bf16) for bf16 in (False, True)}


def _jax_objectives(models, bf16):
    g_params, g_state, d_params, batch = models
    x_l, y_l, x_u = map(jnp.asarray, batch)
    jcfg = JaxAdversarialConfig(num_points=N, batch_size=8,
                                feature_transform=True, bf16=bf16)
    with use_pallas(False), jax_core.mixed_precision(enabled=bf16):
        (g_loss, aux), g_grads = jax.jit(
            jax.value_and_grad(jax_adv._g_loss_fn, has_aux=True),
            static_argnums=(6,))(g_params, d_params, g_state, x_l, y_l, x_u,
                                 jcfg, jnp.float32(1.0))
        (d_loss, _), d_grads = jax.jit(
            jax.value_and_grad(jax_adv._d_loss_fn, has_aux=True),
            static_argnums=(4,))(d_params, aux["probs_l"], aux["probs_u"],
                                 y_l, PARTS)
    return g_loss, aux, g_grads, d_loss, d_grads


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _grad_err(got, want):
    """Largest gradient difference over the net, of (1 + max|g|)."""
    scale = max(float(np.abs(np.asarray(want[k])).max()) for k in want)
    return max(float(np.abs(_np(got[k]) - np.asarray(want[k])).max())
               for k in want) / (1 + scale)


def test_bf16_objectives_match_jax(models, jax_objectives, port_objectives):
    ref, yard = jax_objectives[True], jax_objectives[False]
    total, p_aux, p_d_loss, g, d = port_objectives(True)
    pairs = [(total, ref[0], yard[0]), (p_d_loss, ref[3], yard[3])]
    pairs += [(p_aux[k], ref[1][k], yard[1][k])
              for k in ("l_ce", "l_adv", "l_semi", "d_l", "d_u", "logp_l")]
    for got, want, fp32 in pairs:
        assert _rel(got, want) <= max(STEP_RTOL, YARD * _rel(fp32, want))
    for net, grads, j in ((g, convert.segmenter_state_dict, 2),
                          (d, convert.discriminator_state_dict, 4)):
        args = (models[1],) if net is g else ()
        want, fp32 = (grads(o[j], *args) for o in (ref, yard))
        names = [k for k, _ in net.named_parameters()]
        want = {k: want[k] for k in names}
        err = _grad_err({k: p.grad for k, p in net.named_parameters()}, want)
        moved = _grad_err({k: fp32[k] for k in names}, want)
        assert err <= max(GRAD_TOL, YARD * moved), (err, moved)


def test_bf16_really_runs(port_objectives):
    """Planted: the same objectives in fp32 and in bf16 differ (by about
    bf16's rounding, far above fp32's), as the JAX package requires of
    its scope (``tests/test_round2.py:275``, ``test_kernels.py:241``)."""
    f32, b16 = (port_objectives(bf16) for bf16 in (False, True))
    f, b = f32[0].item(), b16[0].item()
    diff = abs(f - b) / abs(f)
    assert 1e-6 < diff < 5e-2, diff
    assert not torch.equal(f32[1]["logp_l"], b16[1]["logp_l"])


def _scan_inputs(k=2, bsz=4, n=64, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k, bsz, n, 3)).astype(np.float32),
            rng.integers(0, PARTS, size=(k, bsz, n)).astype(np.int32),
            rng.normal(size=(k, bsz, n, 3)).astype(np.float32))


def test_train_steps_scan_equals_train_steps():
    """K=2 on the bench configuration (bf16, ``augment_fused``): the
    stacked metrics of one call equal two ``train_step`` calls."""
    cfg = AdversarialConfig(num_points=64, batch_size=4, augment=True,
                            bf16=True, pallas_augment=True, scan=2)
    base = adversarial.create_state(cfg, 10, device="cpu")
    txs = adversarial.make_txs(cfg, 10)
    batch = [torch.from_numpy(a) for a in _scan_inputs()]
    batch[1] = batch[1].long()
    states = [adversarial.create_state(
        cfg, 10, device="cpu", g_model=copy.deepcopy(base.g_model),
        d_model=copy.deepcopy(base.d_model)) for _ in range(2)]
    scan = adversarial.train_steps_scan(states[0], *batch, cfg=cfg,
                                        g_tx=txs[0], d_tx=txs[1])
    loop = [adversarial.train_step(states[1], *(t[i] for t in batch),
                                   cfg=cfg, g_tx=txs[0], d_tx=txs[1])
            for i in range(2)]
    assert set(scan) == set(loop[0])
    for key, v in scan.items():
        assert v.shape == (2,)
        assert torch.equal(v, torch.stack([m[key] for m in loop])), key
    assert states[0].step == 2 and int(states[0].device_step) == 2


def test_train_steps_scan_refuses_another_k():
    """``cfg.scan`` set: ``train_steps_scan`` takes exactly that many
    batches, and refuses other K before any step runs."""
    cfg = AdversarialConfig(num_points=64, batch_size=4, scan=3)
    state = adversarial.create_state(cfg, 10, device="cpu")
    txs = adversarial.make_txs(cfg, 10)
    batch = [torch.from_numpy(a) for a in _scan_inputs()]
    with pytest.raises(ValueError, match="cfg.scan is 3"):
        adversarial.train_steps_scan(state, batch[0], batch[1].long(),
                                     batch[2], cfg=cfg, g_tx=txs[0],
                                     d_tx=txs[1])
    assert state.step == 0


def test_train_steps_scan_matches_jax(models):
    """The JAX ``train_steps_scan`` and the port's on the same K=2
    batches from the same weights, augmentation off (normalize only):
    every metric of both steps (the second from Adam-updated weights)."""
    g_params, g_state, d_params, _ = models
    kw = dict(num_points=64, batch_size=4, feature_transform=True)
    cfg, jcfg = AdversarialConfig(**kw), JaxAdversarialConfig(**kw)
    g_tx, d_tx = jax_adv.make_txs(jcfg, 10)
    jstate = jax_state.GANTrainState(
        g_params=g_params, g_bn_state=g_state,
        g_opt_state=g_tx.init(g_params), d_params=d_params,
        d_opt_state=d_tx.init(d_params), step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(0))
    batch = _scan_inputs()
    with use_pallas(False):
        _, ref = jax_adv.train_steps_scan(jstate, *map(jnp.asarray, batch),
                                          cfg=jcfg, g_tx=g_tx, d_tx=d_tx)
    g, d = _port_models(models)
    state = adversarial.create_state(cfg, 10, device="cpu", g_model=g,
                                     d_model=d)
    txs = adversarial.make_txs(cfg, 10)
    x_l, y_l, x_u = (torch.from_numpy(a) for a in batch)
    got = adversarial.train_steps_scan(state, x_l, y_l.long(), x_u, cfg=cfg,
                                       g_tx=txs[0], d_tx=txs[1])
    for key in ("loss_g", "loss_ce", "loss_adv", "loss_semi", "loss_d"):
        _close(got[key], ref[key], 5e-3)
    assert np.abs(_np(got["acc"]) - np.asarray(ref["acc"])).max() <= \
        2.0 / (4 * 64)
    assert dataclasses.asdict(cfg)["scan"] == 0
