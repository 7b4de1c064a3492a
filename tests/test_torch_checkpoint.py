"""The port's checkpoints (``utils/checkpoint.py``).

* Round trips of ``TrainState`` and ``GANTrainState`` (models, torch
  optimizers, schedules, the augmentation generator, ``step`` and
  ``device_step``): the restored state takes the same next step, bit for
  bit, as the one it was saved from.
* The four ``AsyncSaver`` policies as the JAX package's tests pin them
  (``tests/test_round3.py``, ``tests/test_round4.py``): every, latest
  (stale snapshots skipped, the final one durable, no backpressure),
  best (improvements only, ties skipped, a metric-less save
  unconditional; the newest directory is the best epoch) and none; a
  writer failure raised once at ``save`` and again at ``close``.
* ``restore_fields`` for the generator only; ``load_params_only`` from a
  directory and from a reference ``.pth`` (with the ``_D.pth``
  companion); a full restore from a ``.pth`` refuses.
* A snapshot is unchanged by an in-place step taken right after ``save``
  returns, while the writer thread has not yet written it.
"""

import dataclasses
import os
import threading
import time

import pytest
import torch

from adversarial_learning_on_pointclouds_tpu_torch.configs import (
    AdversarialConfig, SegmentConfig,
)
from adversarial_learning_on_pointclouds_tpu_torch.train import (
    adversarial, segment,
)
from adversarial_learning_on_pointclouds_tpu_torch.utils import checkpoint

B, N = 4, 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file's small CPU steps run: the
    suite's parallel workers would otherwise oversubscribe the cores,
    which slows such steps many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEG = SegmentConfig(batch_size=B, num_points=N, augment=True,
                    feature_transform=True)
ADV = AdversarialConfig(batch_size=B, num_points=N, augment=True,
                        feature_transform=False)


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, N, 3, generator=g),
            torch.randint(0, 50, (B, N), generator=g))


def _seg_state(seed=0, steps=0):
    cfg = dataclasses.replace(SEG, seed=seed)
    state = segment.create_state(cfg, 2, device="cpu")
    for i in range(steps):
        segment.train_step(state, *_batch(i), cfg=cfg, tx=state.tx)
    return state


def _gan_state(seed=0, steps=0):
    cfg = dataclasses.replace(ADV, seed=seed)
    state = adversarial.create_state(cfg, 2, device="cpu")
    for i in range(steps):
        x, y = _batch(i)
        adversarial.train_step(state, x, y, _batch(i + 7)[0], cfg=cfg,
                               g_tx=state.g_tx, d_tx=state.d_tx)
    return state


def _equal_tree(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_tree(x, y)
    else:
        assert a == b


def test_train_state_roundtrip(tmp_path):
    state = _seg_state(steps=3)
    checkpoint.save(str(tmp_path), 3, state)
    fresh = _seg_state(seed=1)
    restored = checkpoint.restore(str(tmp_path), fresh)
    assert restored is fresh and fresh.step == 3
    assert int(fresh.device_step) == 3
    _equal_tree(checkpoint.snapshot(fresh), checkpoint.snapshot(state))
    x, y = _batch(9)
    m1 = segment.train_step(state, x, y, cfg=SEG, tx=state.tx)
    m2 = segment.train_step(fresh, x, y, cfg=SEG, tx=fresh.tx)
    assert float(m1["loss"]) == float(m2["loss"])
    _equal_tree(fresh.model.state_dict(), state.model.state_dict())
    assert fresh.scheduler.get_last_lr() == state.scheduler.get_last_lr()


def test_gan_state_roundtrip(tmp_path):
    state = _gan_state(steps=2)
    checkpoint.save(str(tmp_path), 0, state)
    checkpoint.save(str(tmp_path), 1, _gan_state(seed=5))
    fresh = _gan_state(seed=1)
    checkpoint.restore(str(tmp_path), fresh, step=0)
    _equal_tree(checkpoint.snapshot(fresh), checkpoint.snapshot(state))
    x, y = _batch(3)
    xu = _batch(4)[0]
    txs = dict(cfg=ADV, g_tx=state.g_tx, d_tx=state.d_tx)
    m1 = adversarial.train_step(state, x, y, xu, **txs)
    m2 = adversarial.train_step(fresh, x, y, xu, **txs)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}


def test_restore_checks_kind_and_refuses_pth(tmp_path):
    checkpoint.save(str(tmp_path / "seg"), 0, _seg_state())
    with pytest.raises(ValueError, match="TrainState"):
        checkpoint.restore(str(tmp_path / "seg"), _gan_state())
    with pytest.raises(ValueError, match="resume_full"):
        checkpoint.restore(str(tmp_path / "g.pth"), _seg_state())
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "missing"), _seg_state())


def test_latest_step_selection(tmp_path):
    state = _seg_state()
    for step in (0, 7, 3):
        checkpoint.save(str(tmp_path), step, state)
    os.makedirs(tmp_path / "9")  # a directory without a state file
    assert checkpoint.latest_step(str(tmp_path)) == 7
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None


def test_restore_fields_generator_only(tmp_path):
    state = _gan_state(steps=1)
    checkpoint.save(str(tmp_path), 0, state)
    fresh = _gan_state(seed=2)
    d_before = checkpoint.snapshot(fresh)["d_model"]
    out = checkpoint.restore_fields(str(tmp_path), fresh, ("g_model",))
    assert out == {"g_model": fresh.g_model}
    _equal_tree(fresh.g_model.state_dict(), state.g_model.state_dict())
    _equal_tree(checkpoint.snapshot(fresh)["d_model"], d_before)
    assert fresh.step == 0
    with pytest.raises(KeyError):
        checkpoint.restore_fields(str(tmp_path), fresh, ("model",))


def test_load_params_only_from_directory(tmp_path):
    state = _seg_state(steps=3)
    checkpoint.save(str(tmp_path), 3, state)
    fresh = _seg_state(seed=1)
    opt_before = checkpoint.snapshot(fresh)["optimizer"]
    checkpoint.load_params_only(str(tmp_path), fresh)
    _equal_tree(fresh.model.state_dict(), state.model.state_dict())
    # Optimizer, schedule, generator and step stay fresh (the reference's
    # --model restarts them).
    assert fresh.step == 0 and int(fresh.device_step) == 0
    _equal_tree(checkpoint.snapshot(fresh)["optimizer"], opt_before)


def test_load_params_only_from_pth(tmp_path):
    src = _gan_state(steps=1)
    pth = str(tmp_path / "g.pth")
    torch.save(src.g_model.state_dict(), pth)
    fresh = _gan_state(seed=3)
    d_fresh = checkpoint.snapshot(fresh)["d_model"]
    checkpoint.load_params_only(pth, fresh)
    _equal_tree(fresh.g_model.state_dict(), src.g_model.state_dict())
    _equal_tree(checkpoint.snapshot(fresh)["d_model"], d_fresh)
    torch.save(src.d_model.state_dict(), str(tmp_path / "g_D.pth"))
    checkpoint.load_params_only(pth, fresh)
    _equal_tree(fresh.d_model.state_dict(), src.d_model.state_dict())
    assert fresh.step == 0
    seg = _seg_state()
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.load_params_only(pth, seg)  # no feature transform
    loaded = checkpoint.load_saved_segmenter(pth, device="cpu")
    assert not hasattr(loaded.feat, "fstn") and loaded.k == 50
    _equal_tree(loaded.state_dict(), src.g_model.state_dict())


def _recording_write(written, delay=0.0):
    def fake_write(ckpt_dir, step, snap):
        time.sleep(delay)
        written.append(step)
    return fake_write


@pytest.fixture
def fake_io(monkeypatch):
    """The policies on plain values: no snapshot, writes only recorded."""
    written = []
    monkeypatch.setattr(checkpoint, "snapshot", lambda state: state)

    def use(delay=0.0):
        monkeypatch.setattr(checkpoint, "_write",
                            _recording_write(written, delay))
        return written
    return use


def test_policy_every_saves_every_epoch(tmp_path, fake_io):
    written = fake_io(0.01)
    with checkpoint.AsyncSaver() as saver:
        for step in range(10):
            saver.save(str(tmp_path), step, {"w": step})
    assert written == list(range(10))


def test_policy_latest_skips_stale_and_keeps_the_final(tmp_path, fake_io):
    written = fake_io(0.05)
    t0 = time.perf_counter()
    with checkpoint.AsyncSaver(policy="latest") as saver:
        for step in range(20):
            saver.save(str(tmp_path), step, {"w": step})
    elapsed = time.perf_counter() - t0
    assert written and written[-1] == 19
    assert len(written) < 20 and written == sorted(written)
    assert elapsed < 0.9, f"keep-up mode still backpressures: {elapsed:.2f}s"


def test_policy_best_saves_improvements_only(tmp_path, fake_io):
    written = fake_io()
    with checkpoint.AsyncSaver(policy="best") as saver:
        for epoch, m in enumerate([0.10, 0.30, 0.20, 0.45, 0.45, 0.40]):
            saver.save(str(tmp_path), epoch, {"w": epoch}, metric=m)
    assert written == [0, 1, 3]
    written.clear()
    with checkpoint.AsyncSaver(policy="best") as saver:
        saver.save(str(tmp_path), 0, {}, metric=0.9)
        saver.save(str(tmp_path), 1, {}, metric=0.1)  # worse: skipped
        saver.save(str(tmp_path), 2, {})  # no metric: unconditional
    assert written == [0, 2]


def test_policy_none_writes_nothing(tmp_path, fake_io):
    written = fake_io()
    with checkpoint.AsyncSaver(policy="none") as saver:
        for step in range(5):
            saver.save(str(tmp_path), step, {"w": step})
    assert written == []


def test_policy_best_newest_directory_is_best(tmp_path):
    d = str(tmp_path / "best")
    states = [_seg_state(seed=s) for s in range(3)]
    with checkpoint.AsyncSaver(policy="best") as saver:
        for epoch, m in enumerate([0.2, 0.6, 0.3]):
            saver.save(d, epoch, states[epoch], metric=m)
    assert checkpoint.latest_step(d) == 1
    got = checkpoint.restore(d, _seg_state(seed=9))
    _equal_tree(got.model.state_dict(), states[1].model.state_dict())


def test_writer_failure_raised_once_then_sticky(tmp_path, monkeypatch):
    calls = {"n": 0}

    def failing_once(ckpt_dir, step, snap):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("disk full")

    monkeypatch.setattr(checkpoint, "snapshot", lambda state: state)
    monkeypatch.setattr(checkpoint, "_write", failing_once)
    saver = checkpoint.AsyncSaver()
    saver.save(str(tmp_path), 0, {})
    deadline = time.perf_counter() + 5.0
    while saver._err is None and time.perf_counter() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="disk full"):
        saver.save(str(tmp_path), 1, {})
    saver.save(str(tmp_path), 2, {})  # raised once, not again
    with pytest.raises(RuntimeError, match="earlier checkpoint write"):
        saver.close()


def test_snapshot_survives_an_in_place_step_after_save(tmp_path,
                                                       monkeypatch):
    """``AsyncSaver.save`` returns before its thread writes; the train
    step right after it updates parameters and Adam moments in place.
    The checkpoint must hold the state as it was at ``save``: without the
    host copy the writer would see the next step's values."""
    state = _seg_state(steps=1)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    exp_avg = [s["exp_avg"].clone()
               for s in state.optimizer.state.values()]
    gate = threading.Event()
    real_write = checkpoint._write

    def gated_write(*item):
        gate.wait(30)
        return real_write(*item)

    monkeypatch.setattr(checkpoint, "_write", gated_write)
    with checkpoint.AsyncSaver() as saver:
        saver.save(str(tmp_path), 1, state)
        segment.train_step(state, *_batch(5), cfg=SEG, tx=state.tx)
        gate.set()
    changed = [k for k, v in state.model.state_dict().items()
               if not torch.equal(v, before[k])]
    assert changed  # the step did move the live state
    saved = torch.load(os.path.join(str(tmp_path), "1", "state.pt"),
                       weights_only=True)
    _equal_tree(saved["model"], before)
    _equal_tree([s["exp_avg"] for s in saved["optimizer"]["state"].values()],
                exp_avg)
    assert saved["step"] == 1 and int(saved["device_step"]) == 1
