"""The dry run's G+D step layer by layer (``dryrun_multichip.layer_runs``)
on the CPU, at the dry run's shape: 2 x 4 clouds x 64 points, config 4
with the feature transform and augmentation, from the seeded weights.

``layer_runs(2, "cpu")`` records the step five ways: one process and two
gloo ranks (each with its own augmentation draws), then the one
process's augmented batch replayed through the plain versions in fp32
at W = 1 and 2 and in float64. The record holds every BatchNorm's batch
moments (and the column sums behind the kernel-fed ones), the trunks'
pooled rows, the T-Net heads' fc1 rows and transforms, the encoder's
per-point feature, the seg head's log-probs, D's logits and the semi
loss's mask and pseudo-labels.

* The record covers every BatchNorm of G on both streams and every
  layer the dry run's fault could sit in, and replaying the augmented
  batch reproduces the step bit for bit.
* W = 2 against W = 1 on the CPU: no quantity sits more than
  ``SITE_FACTOR`` times the fp32 yardstick from float64, no mask entry
  or pseudo-label differs, every loss within ``STEP_RTOL``.
* fp32 against float64: the yardstick is fp32 rounding, not a fault
  (losses within 1e-5, every batch variance within 1e-2 element by
  element).
* ``fault_site`` names a planted error: a variance moved to 5x the
  yardstick, one flipped mask entry.

The repaired arithmetic: the T-Net fc heads' in-launch BatchNorm
(``csrc/small_fc.cuh``'s BN epilogue under ``relu_fc_bn_relu`` and
``fc_head_train``) takes the variance in a second pass about the batch
mean where the one-pass form cancels (``core.rows_moments``: ``m2``
from ``ONE_PASS_LIMIT`` times the second pass's variance on, fewer than
half of fp32's bits left in one pass). On the card's draw of the dry
run's batch one column of STN3d's fc1 on stream b had a batch variance
of 1.4e-5 about a mean of 1.85 (m2 / var 2.45e5), where the one-pass
``m2 - mu_c^2`` keeps about two digits; the plain twins
(``pool_fc_fwd_plain``, ``fc_head_train._moments``, both through
``core.rows_moments``) and the kernel's emulation change alike.

* At the dry run's rows (4 a stream; groups 2 for the paired heads), on
  columns shaped like the card's: mean, variance and ``inv`` within
  ``TIGHT`` of float64 moments of the same fp32 ``z``; the old one-pass
  form (the JAX kernels') misses ``TIGHT`` by more than 100x, in the
  JAX package's ``pool_fc_epilogue._fwd_call`` too (interpret mode).
  Columns whose one pass does not cancel keep it, bit for bit.
* Around the limit (``m2 / var`` within 1% of it, 4 rows), the twin and
  the kernel's emulation (its warp's order of sums) take the same branch,
  which is taken on the second pass's variance; the control: taken on
  the one-pass variance, the two orders part.
* On ordinary columns at those rows the kernel's emulation (3xTF32
  split-K, the two-pass epilogue) and the plain twins hold float64 and
  the JAX kernels within ``tests/test_torch_fc_numerics.py``'s ``BOUND``.
* The whole step on the batch the card drew (``tests/data/
  dryrun_card_batch_w2.npz``, saved from the card: the CPU's generator
  cannot draw it): W = 2 against W = 1 and fp32 against float64 within
  ``STEP_RTOL``; with the old one-pass moments planted, fp32 misses
  float64 there.

Also ``dryrun_multichip.worst`` (what ``chip_smoke.py``'s phase 25 prints
beside the CPU's) and ``ablation_adversarial_gain.main_plain`` (the
σ=0.30 cell with the kernels off: ``main`` inside ``use_kernels(False)``).
"""

import copy
import os

import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds_tpu.ops.kernels import (
    fc_head_train as jax_fc,
)
from adversarial_learning_on_pointclouds_tpu_torch import (
    ablation_adversarial_gain, dryrun_multichip,
)
from adversarial_learning_on_pointclouds_tpu_torch.models import (
    PointNetDenseCls, core,
)
from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
    fc_head_train, pool_fc_epilogue,
)
from adversarial_learning_on_pointclouds_tpu_torch.parallel import steps
from tests.test_torch_fc_numerics import (
    BOUND, _head_args, _jax, _jax_pool, _pool_args, _rel, bn_moments,
    head_fwd_emulated, pool_emulated, warp_sum,
)

RANKS = 2
TIGHT = 1e-5       # element-wise relative, moments against float64
ILL_STD = 3.7e-3   # the card's column: sd 3.7e-3 about 1.85
CARD_BATCH = os.path.join(os.path.dirname(__file__), "data",
                          "dryrun_card_batch_w2.npz")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(one_thread):
    return dryrun_multichip.layer_runs(RANKS, "cpu")


@pytest.fixture(scope="module")
def rows(runs):
    return dryrun_multichip.layer_table(runs)


def _bns():
    g = PointNetDenseCls(50, True)
    return [k for k, m in g.named_modules()
            if isinstance(m, torch.nn.BatchNorm1d)]


# The BatchNorms whose moments come from a kernel's column sums
# (``batch_moments``): the trunks' bn2/bn3 and the seg head's bn1-bn3.
KERNEL_FED = ("feat.stn.bn2", "feat.stn.bn3", "feat.fstn.bn2",
              "feat.fstn.bn3", "feat.bn2", "feat.bn3", "bn1", "bn2", "bn3")
ROWS = ("feat.stn.pooled", "feat.stn.fc1", "feat.stn.transform",
        "feat.fstn.pooled", "feat.fstn.fc1", "feat.fstn.transform",
        "feat.pooled", "feat.point_feature", "seg.log_probs", "d.logits")


def test_record_covers_the_step(runs):
    rec = runs["f64"]["record"]
    want = {f"{bn}.{q}/{s}" for bn in _bns() for q in ("mean", "var")
            for s in "ab"}
    want |= {f"{bn}.{q}/{s}" for bn in KERNEL_FED for q in ("s", "ss")
             for s in "ab"}
    want |= {f"{r}/{s}" for r in ROWS for s in "ab"}
    want |= {"semi.pseudo/b", "semi.mask/b"}
    assert set(rec) == want
    for run in runs.values():
        assert list(run["record"]) == list(rec)
    # The sums are the moments' own: mean = s / m over 4 clouds x 64.
    for bn in KERNEL_FED:
        for s in "ab":
            np.testing.assert_allclose(rec[f"{bn}.s/{s}"] / (4 * 64),
                                       rec[f"{bn}.mean/{s}"], rtol=1e-12,
                                       atol=1e-15)
    assert rec["seg.log_probs/b"].shape == (4, 64, 50)
    assert rec["feat.stn.fc1/a"].shape == (4, 512)
    assert rec["semi.mask/b"].shape == (4, 64)


def test_replayed_batch_reproduces_the_step(runs):
    """The plain fp32 run on the batch the one process drew is that
    process's step bit for bit (on the CPU both are the plain path)."""
    one, cpu = runs["one"], runs["cpu"]
    assert one["metrics"] == cpu["metrics"]
    for name, v in one["record"].items():
        np.testing.assert_array_equal(v, cpu["record"][name], err_msg=name)
    for a, b in zip(one["batch"], cpu["batch"]):
        np.testing.assert_array_equal(a, b)


def test_ranks_hold_one_process_layer_by_layer(runs, rows):
    assert dryrun_multichip.fault_site(rows) is None
    for r in rows:
        if r["kind"] == "count":
            assert r["ranks_one"] == 0 and r["cpu_ranks_cpu"] == 0, r
    for k, v in runs["one"]["metrics"].items():
        got = runs["ranks"]["metrics"][k]
        if k == "acc":
            assert abs(got - v) <= 2.0 / (2 * RANKS * 64), (k, got, v)
        else:
            assert dryrun_multichip.rel(got, v) < dryrun_multichip.STEP_RTOL


def test_fp32_against_float64_is_rounding(runs, rows):
    for k, v in runs["f64"]["metrics"].items():
        assert dryrun_multichip.rel(runs["cpu"]["metrics"][k], v) < 1e-5, k
    for r in rows:
        if r["name"].split("/")[0].endswith(".var"):
            assert 0 < r["cpu"] < 1e-2, r
        if r["kind"] == "count":
            assert r["cpu"] == 0, r


def test_fault_site_names_a_planted_error(runs):
    rows = dryrun_multichip.layer_table(runs)
    name = "bn2.var/b"
    yard = next(r["cpu"] for r in rows if r["name"] == name)
    planted = copy.deepcopy(runs)
    ref = planted["f64"]["record"][name]
    planted["ranks"]["record"][name] = ref * (1 + 5 * yard)
    assert dryrun_multichip.fault_site(
        dryrun_multichip.layer_table(planted)) == name
    planted = copy.deepcopy(runs)
    mask = planted["one"]["record"]["semi.mask/b"]
    mask[0, 0] = 1 - mask[0, 0]
    assert dryrun_multichip.fault_site(
        dryrun_multichip.layer_table(planted)) == "semi.mask/b"


# ---------------------------------------------------------------------------
# The repair: the fc heads' BN variance in a second pass
# ---------------------------------------------------------------------------

def _ill_rows(rows, cols=64, seed=11, per=4):
    """``[rows, cols]`` positive fp32 values, each block of ``per`` rows
    about a column mean in [0.5, 2] with a spread of exactly ``ILL_STD``
    in every other column (``m2 / var`` 1.8e4-2.9e5; the card's column
    2.45e5) and 0.1 in the rest (at most 401)."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(0.5, 2.0, cols)
    sd = np.where(np.arange(cols) % 2 == 0, ILL_STD, 0.1)
    u = rng.standard_normal((rows // per, per, cols))
    u = (u - u.mean(1, keepdims=True)) / u.std(1, keepdims=True)
    return torch.from_numpy(
        (mean + sd * u.reshape(rows, cols)).astype(np.float32))


def _f64_moments(z, groups):
    zg = z.double().reshape(groups, z.shape[0] // groups, -1)
    mu = zg.mean(1)
    var = ((zg - mu[:, None]) ** 2).mean(1)
    return mu, var, torch.rsqrt(var + core.BN_EPS)


def _one_pass(z, rm, groups):
    """The old moments (and the JAX kernels'): one pass about ``rm``,
    ``var = max(m2 - mu_c^2, 0)``."""
    zc = (z - rm).reshape(groups, z.shape[0] // groups, -1)
    mu_c = zc.sum(1) / zc.shape[1]
    var = torch.clamp((zc * zc).sum(1) / zc.shape[1] - mu_c * mu_c, min=0.0)
    return mu_c + rm, var, torch.rsqrt(var + core.BN_EPS)


def _elt(got, ref) -> float:
    got, ref = (np.asarray(t, np.float64).reshape(-1) for t in (got, ref))
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def _pool_one_pass(mx, mn, s3c, t3, w1, b1, g1, be1, rm1, groups,
                   bf16=False):
    """``pool_fc_fwd_plain`` with the old one-pass moments."""
    h = torch.relu(mx) if s3c is None else torch.relu(
        torch.where(s3c >= 0, mx, mn) * s3c + t3)
    z1 = torch.matmul(core.operand(h, bf16), core.operand(w1, bf16)) + b1
    mu, var, inv = _one_pass(z1, rm1, groups)
    zhat = (z1.reshape(groups, -1, z1.shape[1]) - mu[:, None]) * inv[:, None]
    h1 = torch.relu(zhat * g1 + be1).reshape(z1.shape)
    return h1, h, z1, mu, var, inv


def _held(got, ref, ill, z, groups):
    """The moments against float64: the cancelling columns (``ill``)
    within ``TIGHT``; the rest, which keep one pass, within 8 ulps of
    ``m2 / var`` (the bits one pass may lose)."""
    zg = z.double().reshape(groups, -1, z.shape[-1])
    lost = float(((zg ** 2).mean(1) / zg.var(1, unbiased=False)).max())
    for g, r in zip(got, ref):
        g, r = g.reshape(-1, ill.numel()), r.reshape(-1, ill.numel())
        assert _elt(g[:, ill], r[:, ill]) < TIGHT
        assert _elt(g[:, ~ill], r[:, ~ill]) < lost * 2.0 ** -20


def test_fc_bn_moments_hold_float64_where_one_pass_cancels():
    """relu_fc_bn_relu's twin at the paired heads' 2 x 4 rows and the fc
    head's at 4, on the card's kind of column: identity weights, so z is
    the given fp32 rows exactly and only the moments' arithmetic is
    held. The columns spread 0.1 keep the one-pass variance (the JAX
    kernels'); those spread ``ILL_STD`` take the second pass."""
    z = _ill_rows(8)
    cols = z.shape[1]
    ill = torch.arange(cols) % 2 == 0
    eye, zero, one = torch.eye(cols), torch.zeros(cols), torch.ones(cols)
    pool = pool_fc_epilogue.pool_fc_fwd_plain(z, None, None, None, eye,
                                              zero, one, zero, zero, 2)
    assert torch.equal(pool[2], z)
    mu64, var64, inv64 = _f64_moments(z, 2)
    _held(pool[3:], (mu64, var64, inv64), ill, z, 2)
    old = _one_pass(z, zero, 2)
    # Where one pass keeps its bits (m2 well under ONE_PASS_LIMIT times
    # var), the repaired moments are the old ones bit for bit.
    zg = z.double().reshape(2, 4, -1)
    keep = (zg ** 2).mean(1) / var64 < core.ONE_PASS_LIMIT / 2
    assert torch.equal(keep, ~ill.expand(2, -1))
    assert torch.equal(old[1][keep], pool[4][keep])
    assert _elt(old[1][:, ill], var64[:, ill]) > 100 * TIGHT
    assert _elt(old[2][:, ill], inv64[:, ill]) > 10 * TIGHT
    jax_var = np.asarray(_jax_pool([z, None, None, None, eye, zero, one,
                                    zero, zero], 2)[4])
    assert _elt(jax_var[:, ill.numpy()], var64[:, ill]) > 100 * TIGHT

    rng = np.random.default_rng(12)
    w2 = torch.from_numpy((rng.standard_normal((cols, 32)) * 0.1).astype(
        np.float32))
    w3 = torch.from_numpy((rng.standard_normal((32, 9)) * 0.1).astype(
        np.float32))
    z4 = z[:4]
    head = fc_head_train.fc_head_fwd_plain(
        z4, eye, zero, one, zero, w2, torch.zeros(32), torch.ones(32),
        torch.zeros(32), w3, torch.zeros(9), zero, torch.zeros(32))
    assert torch.equal(head[1], z4)
    _held(head[3:6], _f64_moments(z4, 1), ill, z4, 1)
    var64 = _f64_moments(z4, 1)[1]
    assert _elt(_one_pass(z4, zero, 1)[1][:, ill], var64[:, ill]) \
        > 100 * TIGHT


@pytest.mark.parametrize("kind", ["pool", "head"])
def test_fc_bn_two_pass_holds_float64_and_jax_at_the_dry_run_rows(kind):
    """Ordinary columns at 4 rows a stream: the kernel's emulation (3xTF32
    split-K, the two-pass epilogue) and the plain twin within BOUND of
    float64, the JAX kernel within BOUND of the twin."""
    if kind == "pool":
        args = _pool_args(8, 2)
        f64 = pool_emulated(args, 2, "f64")
        emu = pool_emulated(args, 2, "3xtf32")
        plain = pool_fc_epilogue.pool_fc_fwd_plain(*args, 2)
        pairs = list(zip(plain, _jax_pool(args, 2)))
    else:
        args = _head_args(4, 3)
        f64 = head_fwd_emulated(args, "f64")
        emu = head_fwd_emulated(args, "3xtf32")
        plain = fc_head_train.fc_head_fwd_plain(*args)
        jax_out = _jax(jax_fc._fwd_call, args, False)
        pairs = [(plain[0], jax_out[0])]
    for got, ref in zip(emu, f64):
        assert _rel(got, ref) < BOUND
    for got, ref in zip(plain, f64):
        assert _rel(got, ref) < BOUND
    for got, ref in pairs:
        assert _rel(got, np.asarray(ref).reshape(got.shape)) < BOUND


def _limit_rows(rows=4, cols=4096, seed=13):
    """``[rows, cols]`` fp32 rows whose columns' ``m2 / var`` (about 0)
    spreads over 0.99-1.01 of ``ONE_PASS_LIMIT``: a mean in [0.5, 2], a
    spread of ``mean / sqrt(ratio - 1)``."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(0.5, 2.0, cols)
    ratio = core.ONE_PASS_LIMIT * rng.uniform(0.99, 1.01, cols)
    u = rng.standard_normal((rows, cols))
    u = (u - u.mean(0)) / u.std(0)
    return torch.from_numpy(
        (mean + mean / np.sqrt(ratio - 1) * u).astype(np.float32))


def _parts(z, sum_):
    """``(m2, one-pass var, second pass's var)`` of ``z``'s columns about
    0, summed by ``sum_`` over the rows of ``[1, rows, cols]``."""
    d = z[None]
    b = d.shape[1]
    mu_c = sum_(d) / b
    m2 = sum_(d * d) / b
    e = d - mu_c[:, None]
    return m2, torch.clamp(m2 - mu_c * mu_c, min=0.0), sum_(e * e) / b


def test_fc_bn_branch_at_the_limit_is_the_same_in_any_order_of_sums():
    """Columns around ``ONE_PASS_LIMIT`` at the dry run's 4 rows: the
    twin (``core.rows_moments``, torch's sums) and the kernel's emulation
    (``bn_moments``, the warp's lanes and shuffle tree) take the same
    branch in every column whose float64 ``m2 / var`` is more than 1e-5
    from the limit, since the branch is taken on the second pass's
    variance; the twin's variance is the branch's, bit for bit; where the
    second pass is taken both hold float64 within ``TIGHT``, where one
    pass is kept within the bits it loses. The control: on the one-pass
    variance (which moves by ``m2 / var`` ulps) the two orders part in
    some of those columns, where the two forms differ by more than
    ``TIGHT``."""
    z = _limit_rows()
    zero = torch.zeros(z.shape[1])
    zd = z.double()
    var64 = zd.var(0, unbiased=False)
    ratio = (zd ** 2).mean(0) / var64
    clear = ((ratio / core.ONE_PASS_LIMIT - 1).abs() > 1e-5)[None]
    (m2_t, one_t, var2_t), (m2_w, one_w, var2_w) = (
        _parts(z, lambda x: x.sum(1)), _parts(z, warp_sum))
    second_t = var2_t * core.ONE_PASS_LIMIT <= m2_t
    second_w = var2_w * core.ONE_PASS_LIMIT <= m2_w
    assert torch.equal(second_t[clear], second_w[clear])
    assert 0.3 < second_t.float().mean() < 0.7
    twin = core.rows_moments(z, zero)
    emu = bn_moments(z, zero, 1)
    assert torch.equal(twin[1], torch.where(second_t, var2_t, one_t))
    inv64 = torch.rsqrt(var64 + core.BN_EPS)
    two = second_t[0]
    for mom in (twin, emu):
        assert _elt(mom[1][0, two], var64[two]) < TIGHT
        assert _elt(mom[2][0, two], inv64[two]) < TIGHT
        assert _elt(mom[1][0, ~two], var64[~two]) \
            < core.ONE_PASS_LIMIT * 2.0 ** -20
    old_t = one_t * core.ONE_PASS_LIMIT <= m2_t
    old_w = one_w * core.ONE_PASS_LIMIT <= m2_w
    parted = (old_t != old_w) & clear
    assert int(parted.sum()) > 0
    assert _elt(one_t[parted], var2_t[parted]) > TIGHT


def _card_batch():
    """The dry run's global batch (W = 2: 2 x 4 clouds x 64 points) as the
    card's augmentation drew it (``layer_runs(2, "cuda")["one"]["batch"]``
    on an H100; the CUDA generator draws another augmentation than the
    CPU's): STN3d's fc1 BN on stream b holds a column of variance 1.4e-5
    about a mean of 1.85."""
    with np.load(CARD_BATCH) as f:
        return f["x_l"], f["y_l"], f["x_u"]


@pytest.fixture(scope="module")
def card(one_thread):
    return dryrun_multichip.layer_runs(RANKS, "cpu", augmented=_card_batch())


def test_step_on_the_card_batch_holds_the_dry_run_bound(card):
    """The card's failure replayed on the CPU, which missed it too (W = 2
    against 1: ``loss_semi`` rel 1.17e-4 before the repair)."""
    assert dryrun_multichip.fault_site(
        dryrun_multichip.layer_table(card)) is None
    one, f64 = card["one"]["metrics"], card["f64"]["metrics"]
    for k, v in one.items():
        if k != "acc":
            assert dryrun_multichip.rel(card["ranks"]["metrics"][k], v) \
                < dryrun_multichip.STEP_RTOL, k
            assert dryrun_multichip.rel(v, f64[k]) \
                < dryrun_multichip.STEP_RTOL, k


def test_one_pass_fc_bn_misses_float64_on_the_card_batch(card, monkeypatch):
    """The control: the old one-pass moments planted in the paired heads'
    twin, the same fp32 step misses float64 by more than twice
    STEP_RTOL (4.8e-5 measured)."""
    _, _, kw, _ = dryrun_multichip.calls(RANKS, "cpu")[0]
    monkeypatch.setattr(pool_fc_epilogue, "pool_fc_fwd_plain",
                        _pool_one_pass)
    got = steps.run_many([("p", dryrun_multichip.probe_step, dict(
        cfg_kw=kw["cfg_kw"], batch=kw["batches"][0],
        weights=dryrun_multichip.initial_weights(kw["cfg_kw"]),
        device="cpu", augmented=_card_batch()), "float32")])["p"]
    f64 = card["f64"]["metrics"]
    worst = max(dryrun_multichip.rel(got["metrics"][k], f64[k])
                for k in f64 if k != "acc")
    assert worst > 2 * dryrun_multichip.STEP_RTOL


def test_worst_reads_each_check():
    metrics = dict(loss_g=2.0, loss_semi=4.0, acc=0.5)
    ref = {k: {"metrics": [dict(metrics)]} for k in (
        "step", "no_paired_heads", "paired_trunks", "paired_conv1",
        "point_train")}
    got = copy.deepcopy(ref)
    got["step"]["metrics"][0]["loss_semi"] = 4.0 * (1 + 3e-5)
    got["paired_conv1"]["metrics"][0]["acc"] = 0.25     # not a loss
    ref["point_eval"] = np.zeros((2, 3))
    got["point_eval"] = np.full((2, 3), 2e-4)
    w = dryrun_multichip.worst(got, ref)
    assert w["step"] == pytest.approx(3e-5 / (1 + 3e-5))
    assert w["paired_conv1"] == 0.0
    assert w["point_eval"] == pytest.approx(2e-4)
    assert set(w) == {"step", "no_paired_heads", "paired_trunks",
                      "paired_conv1", "point_train", "point_eval"}


def test_main_plain_runs_the_sweep_with_the_kernels_off(monkeypatch):
    seen = []
    monkeypatch.setattr(ablation_adversarial_gain, "main", lambda argv: (
        seen.append((argv, dispatch.kernels_enabled())) or {"ok": 1}))
    assert ablation_adversarial_gain.main_plain(["--quick"]) == {"ok": 1}
    assert seen == [(["--quick"], False)]
    assert dispatch.kernels_enabled()
