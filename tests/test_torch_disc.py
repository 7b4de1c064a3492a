"""The port's discriminator against the JAX package's.

The plain twins of the four discriminator passes (``ops/kernels/
disc_fused.py``) and each ``FCDiscriminator`` method (its output and
every gradient it returns) against the JAX package's fused custom VJPs
(``disc_fused.apply`` / ``apply_frozen`` / ``apply_detached`` /
``apply_with_known_logits``, Pallas in interpret mode on the CPU) and
against its jnp path (``apply_discriminator`` under ``use_pallas(False)``),
on the same numpy-seeded inputs: B=2, N=64, k=50, and a ragged N=50
against the jnp path. Bound: 1e-5 scale-relative, fp32 stacks of
products that differ only in summation order. ``chip_smoke.py`` holds
the CUDA passes against the same plain twins on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.models import (
    apply_discriminator, init_discriminator,
)
from adversarial_learning_on_pointclouds_tpu.ops import use_pallas
from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    disc_fused as jax_disc,
)
from adversarial_learning_on_pointclouds_tpu.utils import torch_export
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    FCDiscriminator,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import build
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    disc_fused,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import convert

B, K = 2, 50
RTOL = 1e-5
NAMES = [f"conv{i}" for i in range(1, 6)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=RTOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)


@pytest.fixture(scope="module")
def params():
    p = init_discriminator(jax.random.PRNGKey(3), K)
    return jax.tree_util.tree_map(np.asarray, p)


def _inputs(n, seed=0):
    """Probability maps with a few one-hot rows (the D step's reals) and
    the logits' cotangent."""
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 2, (B, n, K))
    x = np.exp(z - z.max(-1, keepdims=True))
    x /= x.sum(-1, keepdims=True)
    x[:, ::7] = np.eye(K)[rng.integers(0, K, (B, len(range(0, n, 7))))]
    g = rng.normal(0, 1, (B, n, 1))
    return x.astype(np.float32), g.astype(np.float32)


def _port_model(params):
    model = FCDiscriminator(K)
    model.load_state_dict(convert.discriminator_state_dict(params),
                          strict=True)
    return model


def _ws_bs(params):
    return ([torch.tensor(params[n]["w"]) for n in NAMES],
            [torch.tensor(params[n]["b"]) for n in NAMES])


def _jax_vjp(fn, params, x, g):
    out, vjp = jax.vjp(fn, params, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    return out, dx, dp


def _jax_ref(params, x, g, path):
    """Logits, dx and the parameter gradients for cotangent ``g``: the
    fused custom VJP (interpret mode) or the jnp layers."""
    if path == "pallas":
        return _jax_vjp(jax_disc.apply, params, x, g)
    with use_pallas(False):
        return _jax_vjp(apply_discriminator, params, x, g)


@pytest.mark.parametrize("n,path", [(64, "pallas"), (64, "jnp"), (50, "jnp")],
                         ids=["pallas", "jnp", "ragged-jnp"])
def test_plain_twins_match_jax(params, n, path):
    x, g = _inputs(n)
    out, dx, dp = _jax_ref(params, x, g, path)
    ws, bs = _ws_bs(params)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    _close(disc_fused.disc_fwd_plain(tx, ws, bs), out)
    _close(disc_fused.disc_bwd_dx_plain(tx, tg, ws, bs), dx)
    dws, dbs = disc_fused.disc_bwd_dw_plain(tx, tg, ws, bs)
    full = disc_fused.disc_bwd_plain(tx, tg, ws, bs)
    _close(full[0], dx)
    for i, name in enumerate(NAMES):
        for got in (dws[i], full[1][i]):
            _close(got, dp[name]["w"])
        for got in (dbs[i], full[2][i]):
            _close(got, dp[name]["b"])


def _run_method(model, method, x, known=None):
    """``sum(tanh(out))`` through one ``FCDiscriminator`` method, backward:
    ``(out, x.grad, {name: (weight grad [in, out], bias grad)})``."""
    tx = torch.from_numpy(x).requires_grad_()
    if method == "known":
        out = model.with_known_logits(tx, torch.from_numpy(known))
    else:
        out = getattr(model, method)(tx)
    torch.tanh(out).sum().backward()
    layers = [model.conv1, model.conv2, model.conv3, model.conv4,
              model.classifier]
    grads = {n: (None if m.weight.grad is None
                 else m.weight.grad.flatten(1).t(), m.bias.grad)
             for n, m in zip(NAMES, layers)}
    return out, tx.grad, grads


def _jax_method(params, x, method, path):
    """JAX's logits and the gradients of ``sum(tanh(out))``."""
    xj = jnp.asarray(x)
    if path == "jnp":
        with use_pallas(False):
            fn = apply_discriminator
            out = fn(params, xj)
            dp, dx = jax.grad(lambda p, v: jnp.sum(jnp.tanh(fn(p, v))),
                              argnums=(0, 1))(params, xj)
        return out, dx, dp
    if method == "known":
        logits = jax_disc.apply(params, xj)
        fn = lambda p, v: jax_disc.apply_with_known_logits(p, v, logits)  # noqa: E731
    else:
        fn = {"forward": jax_disc.apply, "frozen": jax_disc.apply_frozen,
              "detached": jax_disc.apply_detached}[method]
    out = fn(params, xj)
    dp, dx = jax.grad(lambda p, v: jnp.sum(jnp.tanh(fn(p, v))),
                      argnums=(0, 1))(params, xj)
    return out, dx, dp


@pytest.mark.parametrize("method", ["forward", "frozen", "detached", "known"])
@pytest.mark.parametrize("n,path", [(64, "pallas"), (64, "jnp"), (50, "jnp")],
                         ids=["pallas", "jnp", "ragged-jnp"])
def test_methods_match_jax(params, method, n, path):
    """Each method's logits and the gradients it returns; the gradients it
    must not return stay ``None``: ``frozen`` gives the parameters none,
    ``detached`` and ``with_known_logits`` give the input none."""
    x, _ = _inputs(n, seed=1)
    ref_out, ref_dx, ref_dp = _jax_method(params, x, method, path)
    model = _port_model(params)
    known = np.array(ref_out) if method == "known" else None
    out, dx, grads = _run_method(model, method, x, known)
    _close(out, ref_out)
    if method in ("forward", "frozen"):
        _close(dx, ref_dx)
    else:
        assert dx is None
    for name, (dw, db) in grads.items():
        if method == "frozen":
            assert dw is None and db is None, name
        else:
            _close(dw, ref_dp[name]["w"])
            _close(db, ref_dp[name]["b"])


def test_state_dict_keys_are_the_references(params):
    want = torch_export.discriminator_state_dict(params)
    got = FCDiscriminator(K).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    sd = convert.discriminator_state_dict(params)
    assert all(torch.equal(sd[k], want[k]) for k in want)


def test_seeded_init():
    """Seeded from an explicit generator with torch's default bounds."""
    def make(seed):
        return FCDiscriminator(
            K, generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv4.weight"], c["conv4.weight"])
    assert a["conv4.weight"].abs().max() <= 256 ** -0.5


def test_grad_layout_covers_the_gradients():
    layout, size = disc_fused.grad_layout(K)
    sizes = [int(np.prod(s)) for _, s in layout]
    assert [at for at, _ in layout] == list(np.cumsum([0] + sizes[:-1]))
    assert size == sum(sizes) == 175744 + 961


def _unbuildable():
    raise AssertionError("a CPU tensor reached the kernel library")


def test_cpu_passes_skip_the_library(monkeypatch, params):
    """CPU tensors run every pass's plain twin: the kernel library is
    never built and no launch is counted."""
    monkeypatch.setattr(build, "library", _unbuildable)
    counts = {k: p.launches for k, p in disc_fused.PASSES.items()}
    x, _ = _inputs(64, seed=2)
    model = _port_model(params)
    for method in ("forward", "frozen", "detached", "known"):
        _run_method(model, method, x, np.zeros((B, 64, 1), np.float32))
    assert {k: p.launches for k, p in disc_fused.PASSES.items()} == counts


def test_kernel_wrappers_refuse_what_they_do_not_take(params):
    """Inputs wider than the kernels' 64 channels raise on the card's path
    before any launch; on the CPU the plain twin takes any width."""
    ws, bs = _ws_bs(jax.tree_util.tree_map(
        np.asarray, init_discriminator(jax.random.PRNGKey(0), 70)))
    x = torch.rand(1, 8, 70)
    assert disc_fused.disc_fwd(x, ws, bs).shape == (1, 8, 1)
    with pytest.raises(ValueError, match="input channels"):
        disc_fused._check(x, ws, bs)
