"""The port's ``augment_fused`` against the JAX package's.

The TPU kernel draws its bits from the TPU's on-core generator, which the
JAX package's interpret mode on the CPU stubs to zeros; the port draws
Philox4x32-10 bits instead (``ops/kernels/augment_fused.py``). So:

* on all-zero bits the port's plain twin equals the JAX kernel in
  interpret mode (angle 0, every jitter clipped to +clip, and with
  dropout every point the first): at 1e-6, the float32 rounding of the
  same few operations;
* on Philox bits it equals a numpy transcription of the TPU kernel's body
  (``augment_fused.py::_augment_kernel``) fed the same bits, at 1e-6
  relative (numpy's and torch's cos, sin and log differ in the last
  bits);
* the torch Philox reproduces Random123's known answers;
* the angle, the jitter and the dropout ratio have the distributions the
  reference draws (bounds at five standard errors).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    augment_fused as jax_af,
)
from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.data import augment
from adversarial_learning_on_pointclouds_tpu_torch.ops import build
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    augment_fused as af,
)

M32 = 0xFFFFFFFF
# Random123's kat_vectors for philox4x32_10: counter, key, output.
KNOWN = {
    "zeros": ((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    "ones": ((M32, M32, M32, M32), (M32, M32),
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    "pi": ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
           (0xa4093822, 0x299f31d0),
           (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
}
MODES = {"rotate": (True, False, False), "jitter": (False, True, False),
         "dropout": (False, False, True), "all": (True, True, True)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's CPU work (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_philox_known_answers(name):
    ctr, key, want = KNOWN[name]
    got = af.philox4x32(*ctr, *key)
    assert [int(w) for w in got] == list(want)


def _points(bsz, n, seed=0):
    return np.random.default_rng(seed).normal(size=(bsz, n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("n", [128, 130], ids=["tileable", "ragged"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_zero_bits_match_jax_interpret(mode, n):
    x = _points(3, n)
    rotate, jitter, dropout = MODES[mode]
    want = np.asarray(jax_af.augment_fused(
        jnp.int32(5), jnp.asarray(x), rotate=rotate, jitter=jitter,
        dropout=dropout))
    zeros = (torch.zeros(3, 2, dtype=torch.int64),
             torch.zeros(3, n, 8, dtype=torch.int64))
    got = af.augment_fused_plain(torch.tensor(0), torch.from_numpy(x), 5, 0,
                                 rotate, jitter, dropout, bits=zeros).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if dropout:                                 # u = 0 <= ratio = 0
        assert (got == got[:, :1]).all()


def _np_uniform(bits):
    bits = np.asarray(bits, np.uint64).astype(np.uint32)
    return ((bits >> 9) | np.uint32(0x3F800000)).view(np.float32) - \
        np.float32(1.0)


def _np_augment_kernel(points, cloud, point, rotate, jitter, dropout,
                       sigma=0.01, clip=0.05, max_ratio=0.875):
    """``_augment_kernel`` (augment_fused.py:60-91) in numpy float32, per
    cloud, on given bits: the angle and ratio from ``cloud[b]``, the
    jitter's ``b1``/``b2`` and the dropout ``u`` from ``point[b]``."""
    f32 = np.float32
    out = []
    for b in range(points.shape[0]):
        pts = points[b]
        if rotate:
            angle = _np_uniform(cloud[b, 0]) * f32(af.TWO_PI)
            c, s = np.cos(angle), np.sin(angle)
            x0, x1, x2 = pts[:, 0], pts[:, 1], pts[:, 2]
            pts = np.stack([c * x0 - s * x2, x1, s * x0 + c * x2], axis=-1)
        if jitter:
            u1 = np.maximum(_np_uniform(point[b, :, 0:3]), f32(1e-7))
            u2 = _np_uniform(point[b, :, 4:7])
            r = np.sqrt(f32(-2.0) * np.log(u1))
            noise = f32(sigma) * (r * np.cos(f32(af.TWO_PI) * u2))
            pts = pts + np.clip(noise, f32(-clip), f32(clip))
        if dropout:
            ratio = _np_uniform(cloud[b, 1]) * f32(max_ratio)
            drop = _np_uniform(point[b, :, 3:4]) <= ratio
            pts = np.where(drop, pts[0:1, :], pts)
        out.append(pts)
    return np.stack(out)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_philox_bits_match_numpy_transcription(mode):
    x = _points(4, 130, seed=1)
    step = torch.tensor(3)
    cloud, point = af.augment_bits(af.step_seed(1234, step, 1), 4, 130)
    got = af.augment_fused_plain(step, torch.from_numpy(x), 1234, 1,
                                 *MODES[mode])
    want = _np_augment_kernel(x, cloud.numpy(), point.numpy(), *MODES[mode])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def many():
    """4096 clouds x 64 points through each part of the pass alone."""
    x = torch.from_numpy(_points(4096, 64, seed=2))
    step = torch.tensor(5)
    return x, {m: af.augment_fused(step, x, 99, 0, *f)
               for m, f in MODES.items()}


def test_angle_is_uniform(many):
    x, out = many
    y = out["rotate"]
    assert torch.equal(y[..., 1], x[..., 1])          # about the Y axis
    torch.testing.assert_close(y.norm(dim=-1), x.norm(dim=-1), rtol=1e-5,
                               atol=1e-6)
    r2 = x[:, 0, 0] ** 2 + x[:, 0, 2] ** 2
    c = (x[:, 0, 0] * y[:, 0, 0] + x[:, 0, 2] * y[:, 0, 2]) / r2
    s = (x[:, 0, 0] * y[:, 0, 2] - x[:, 0, 2] * y[:, 0, 0]) / r2
    angle = torch.atan2(s, c).remainder(2 * np.pi).numpy()
    se = 2 * np.pi / np.sqrt(12 * angle.size)         # std error of mean
    assert abs(angle.mean() - np.pi) < 5 * se
    hist = np.histogram(angle, bins=8, range=(0, 2 * np.pi))[0]
    expect = angle.size / 8
    assert np.abs(hist - expect).max() < 5 * np.sqrt(expect)


def test_jitter_is_clipped_gaussian(many):
    x, out = many
    noise = (out["jitter"] - x).numpy().astype(np.float64)
    assert np.abs(noise).max() <= 0.05 + 1e-6
    se = 0.01 / np.sqrt(noise.size)
    assert abs(noise.mean()) < 5 * se
    assert abs(noise.std() - 0.01) < 5 * 0.01 / np.sqrt(2 * noise.size)
    # Box-Muller's tails: about 4.55% of draws beyond 2 sigma.
    tail = (np.abs(noise) > 0.02).mean()
    assert abs(tail - 0.0455) < 5 * np.sqrt(0.0455 * 0.9545 / noise.size)


def test_dropout_ratio_is_uniform(many):
    x, out = many
    y = out["dropout"]
    frac = (y[:, 1:] == y[:, :1]).all(-1).double().mean(1).numpy()
    se = 0.875 / np.sqrt(12 * frac.size)
    assert abs(frac.mean() - 0.4375) < 5 * se + 0.01
    assert frac.max() <= 0.875 + 5 * np.sqrt(0.875 * 0.125 / 63)
    kept = ~(y[:, 1:] == y[:, :1]).all(-1)
    assert torch.equal(y[:, 1:][kept], x[:, 1:][kept])   # untouched


def test_seeds_and_steps():
    """The same (seed, step, stream) augments alike; another seed, step
    or stream augments otherwise; the keys of 4 steps x 2 streams are
    distinct int32 values in [0, 2^31), the first Philox word at counter
    (step, stream, 0, 0) keyed by the seed."""
    x = torch.from_numpy(_points(2, 64, seed=3))
    step = torch.tensor(7)
    a, b = (af.augment_fused(step, x, 0, 0, dropout=True) for _ in range(2))
    assert torch.equal(a, b)
    for other in (af.augment_fused(step + 1, x, 0, 0, dropout=True),
                  af.augment_fused(step, x, 1, 0, dropout=True),
                  af.augment_fused(step, x, 0, 1, dropout=True)):
        assert (other != a).float().mean() > 0.9
    keys = {int(af.step_seed(0, step + k, s)) for k in range(4)
            for s in (0, 1)}
    assert len(keys) == 8
    assert all(0 <= v < 2 ** 31 for v in keys)
    s = af.step_seed(3, step, 1)
    assert s.dtype == torch.int32 and s.shape == (1,)
    word = af.philox4x32(7, 1, 0, 0, 3, 0)[0]
    assert int(s) == int(word) & 0x7FFFFFFF


def test_chain_from_cfg_runs_the_fused_pass(monkeypatch):
    """``cfg.pallas_augment``: normalize, then ``augment_fused`` of the
    given stream at the given step, keyed by ``cfg.seed``, labels
    untouched; a CPU tensor never builds the kernel library; no step
    raises."""
    monkeypatch.setattr(build, "library", lambda: pytest.fail("built"))
    cfg = AdversarialConfig(num_points=64, augment=True, point_dropout=True,
                            pallas_augment=True)
    x = torch.from_numpy(_points(2, 64, seed=4))
    y = torch.arange(128).reshape(2, 64)
    step = torch.tensor(11)
    gen = torch.Generator().manual_seed(0)
    pts, labels = augment.chain_from_cfg(gen, cfg, x, y, step, 1)
    want = af.augment_fused_plain(step, augment.normalize_unit_sphere(x),
                                  cfg.seed, 1, True, True, True)
    assert torch.equal(pts, want) and torch.equal(labels, y)
    with pytest.raises(ValueError, match="step"):
        augment.chain_from_cfg(gen, cfg, x, y)
    off = dataclasses.replace(cfg, augment=False, point_dropout=False)
    assert torch.equal(augment.chain_from_cfg(gen, off, x),
                       augment.normalize_unit_sphere(x))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pair_plain_equals_two_single_passes(mode):
    """The pair's plain pass is the two single-stream plain passes (streams
    0 and 1), bit for bit, on streams of two shapes (a ragged N too)."""
    a = torch.from_numpy(_points(3, 130, seed=5))
    b = torch.from_numpy(_points(2, 64, seed=6))
    step = torch.tensor(9)
    got = af.augment_fused_pair_plain(step, a, b, 77, *MODES[mode])
    want = (af.augment_fused_plain(step, a, 77, 0, *MODES[mode]),
            af.augment_fused_plain(step, b, 77, 1, *MODES[mode]))
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_pair_on_cpu_tensors_runs_the_plain_pass(monkeypatch):
    """CPU tensors take the plain pair pass: no library, no launch counted;
    the two streams on two devices raise."""
    monkeypatch.setattr(build, "library", lambda: pytest.fail("built"))
    before = af.augment_fused.launches
    a = torch.from_numpy(_points(2, 64, seed=7))
    b = torch.from_numpy(_points(2, 64, seed=8))
    step = torch.tensor(2)
    got = af.augment_fused_pair(step, a, b, 5, dropout=True)
    want = af.augment_fused_pair_plain(step, a, b, 5, dropout=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert af.augment_fused.launches == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        af.augment_fused_pair(step, a, b.to("meta"), 5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_chain_pair_from_cfg_equals_two_chains(fused):
    """Normalize, resample (clouds of 100 points to 64, labels riding the
    gather) and the augmentation of both streams through
    ``chain_pair_from_cfg`` give what two ``chain_from_cfg`` calls give
    from the same generator, stream 0 then 1, bit for bit."""
    cfg = AdversarialConfig(num_points=64, augment=True, point_dropout=True,
                            pallas_augment=fused)
    x_l = torch.from_numpy(_points(2, 100, seed=9))
    y_l = torch.arange(200).reshape(2, 100)
    x_u = torch.from_numpy(_points(2, 100, seed=10))
    step = torch.tensor(4)
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    (pl, ll), pu = augment.chain_pair_from_cfg(gens[0], cfg, (x_l, y_l),
                                               (x_u, None), step)
    wl, wy = augment.chain_from_cfg(gens[1], cfg, x_l, y_l, step, 0)
    wu = augment.chain_from_cfg(gens[1], cfg, x_u, None, step, 1)
    assert pl.shape == (2, 64, 3) and pu.shape == (2, 64, 3)
    assert torch.equal(pl, wl) and torch.equal(ll, wy)
    assert torch.equal(pu, wu)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_train_step_launches_the_pair_once_a_step(monkeypatch):
    """With ``pallas_augment`` the G+D step augments both streams through
    ``augment_fused_pair``, once a step, stream 0 labeled and 1 unlabeled,
    and never through the single-stream entry."""
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    calls = []
    pair = af.augment_fused_pair

    def counted(step, a, b, seed, **kw):
        calls.append((int(step), a.clone(), b.clone()))
        return pair(step, a, b, seed, **kw)

    monkeypatch.setattr(af, "augment_fused_pair", counted)
    monkeypatch.setattr(af, "augment_fused",
                        lambda *a, **k: pytest.fail("single-stream entry"))
    cfg = AdversarialConfig(num_points=64, batch_size=2, augment=True,
                            pallas_augment=True)
    state = adversarial.create_state(cfg, 10, device="cpu")
    txs = adversarial.make_txs(cfg, 10)
    x_l = torch.from_numpy(_points(2, 64, seed=11))
    y_l = torch.randint(0, cfg.num_parts, (2, 64),
                        generator=torch.Generator().manual_seed(0))
    x_u = torch.from_numpy(_points(2, 64, seed=12))
    for _ in range(2):
        adversarial.train_step(state, x_l, y_l, x_u, cfg=cfg, g_tx=txs[0],
                               d_tx=txs[1])
    # The labeled batch goes first (stream 0), the unlabeled second.
    want = [augment.normalize_unit_sphere(x) for x in (x_l, x_u)]
    assert [k for k, _, _ in calls] == [0, 1]
    for _, a, b in calls:
        assert torch.equal(a, want[0]) and torch.equal(b, want[1])
