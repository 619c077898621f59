"""The port's checkpoints, resume, warm start, watchdog and preemption.

Mirrors the JAX package's tests/test_train.py:126-324 on the port's
trainer (tensorflow_ocr_tpu_torch/train/trainer.py): the round trip,
async saves and an async failure that re-raises, pruning, the time
cadence, preemption, warm_start, the stall watchdog and a data
iterator's state. Plus: a run resumed from a checkpoint equals an
uninterrupted one bit for bit (pixellink_resnet50 at 64x64, batch 2,
float32, on the plain versions of the xla and fused arms), restore is
strict, restore for inference never reads the optimizer's state, and a
Predictor serves a checkpoint's EMA parameters and BN buffers.
"""

import os
import time

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu_torch.config import Config, InferConfig
from tensorflow_ocr_tpu_torch.infer import OPERATING_POINT_FILE, Predictor
from tensorflow_ocr_tpu_torch.train import trainer as T
from test_torch_step import scene_batch

torch.set_num_threads(1)
SIZE = 64


def tiny_cfg(root=None, **train):
    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = SIZE
    cfg.train.log_every_steps = 1
    cfg.train.stall_warn_secs = 0
    cfg.train.save_checkpoint_steps = 0
    if root is not None:
        cfg.train.checkpoint_path = str(root)
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def batches(n, seed=0, size=SIZE):
    rng = np.random.RandomState(seed)
    return [scene_batch(rng, 2, size) for _ in range(n)]


def leaves(state):
    return T.flat_tree(T.state_tensors(state))


def assert_same_state(a, b):
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def trained(cfg, steps=1):
    tr = T.Trainer(cfg, device="cpu")
    tr.setup()
    tr.run(batches(steps), steps)
    return tr


class Rows:
    """A toy data iterator with the get_state/set_state protocol."""

    def __init__(self, items):
        self.items, self.i = items, 0

    def __next__(self):
        self.i += 1
        return self.items[self.i - 1]

    def get_state(self):
        return str(self.i).encode()

    def set_state(self, state):
        self.i = int(state)


def test_checkpoint_roundtrip(tmp_path):
    cfg = tiny_cfg(tmp_path / "ckpt")
    state = trained(cfg).state
    d = T.save_checkpoint(cfg.train.checkpoint_path, state)
    assert d.endswith("ckpt_1") and os.path.exists(os.path.join(d,
                                                                T.CKPT_FILE))
    assert T.latest_checkpoint(cfg.train.checkpoint_path) == d
    fresh = T.create_train_state(cfg, "cpu",
                                 generator=torch.Generator().manual_seed(9))
    restored = T.restore_checkpoint(d, fresh)
    assert restored is fresh and int(restored.step) == 1
    assert_same_state(restored, state)
    # nothing but ckpt_* directories is left under the root
    assert os.listdir(cfg.train.checkpoint_path) == ["ckpt_1"]


def test_async_checkpoint_save(tmp_path):
    """block=False snapshots the state before it returns and writes on a
    thread; the next save joins the previous one."""
    cfg = tiny_cfg(tmp_path / "ckpt_async")
    state = trained(cfg).state
    want = {k: v.clone() for k, v in leaves(state).items()}
    d = T.save_checkpoint(cfg.train.checkpoint_path, state, block=False)
    with torch.no_grad():  # the snapshot was taken: later updates are not in
        state.ema[next(iter(state.ema))].add_(1.0)
    T.wait_for_pending_save()
    assert T._PENDING_SAVE is None
    got = T.flat_tree(T.load_checkpoint(d))
    assert all(torch.equal(got[k], want[k]) for k in want)
    state.step += 1
    d2 = T.save_checkpoint(cfg.train.checkpoint_path, state, block=False)
    T.wait_for_pending_save()
    assert T.latest_checkpoint(cfg.train.checkpoint_path) == d2


def test_async_checkpoint_failure_reraises(tmp_path):
    """A failed async write surfaces in wait_for_pending_save, not on the
    writer thread alone."""
    state = T.create_train_state(tiny_cfg(), "cpu")
    bad_root = tmp_path / "not_a_dir"
    bad_root.write_text("occupied")
    T.save_checkpoint(str(bad_root), state, block=False)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        T.wait_for_pending_save()
    T.wait_for_pending_save()  # the error is consumed


def test_checkpoint_retention_prunes_oldest(tmp_path):
    root = str(tmp_path / "ckpt_keep")
    cfg = tiny_cfg(root)
    state = T.create_train_state(cfg, "cpu")
    for k in range(4):
        state.step.fill_(k)
        T.save_checkpoint(root, state, max_to_keep=2)
    assert sorted(os.listdir(root)) == ["ckpt_2", "ckpt_3"]
    fresh = T.create_train_state(cfg, "cpu")
    assert int(T.restore_checkpoint(T.latest_checkpoint(root),
                                    fresh).step) == 3
    assert T.prune_checkpoints(root, 0) == []


def test_time_based_checkpoint_cadence(tmp_path):
    """save_interval_secs saves with the step cadence off; the retention
    cap applies."""
    cfg = tiny_cfg(tmp_path / "ckpt_time", save_interval_secs=1e-6,
                   max_checkpoints_to_keep=1)
    trained(cfg, steps=3)
    assert os.listdir(cfg.train.checkpoint_path) == ["ckpt_3"]


def test_step_cadence_saves_with_the_data_position(tmp_path):
    cfg = tiny_cfg(tmp_path / "ckpt_steps", save_checkpoint_steps=2)
    tr = T.Trainer(cfg, device="cpu")
    tr.setup()
    it = Rows(batches(5))
    tr.run(it, 5)
    root = cfg.train.checkpoint_path
    assert sorted(os.listdir(root)) == ["ckpt_3", "ckpt_5"]
    with open(os.path.join(root, "ckpt_3", T.DATA_ITER_STATE_FILE),
              "rb") as f:
        assert f.read() == b"3"


def test_preemption_checkpoints_and_stops(tmp_path):
    cfg = tiny_cfg(tmp_path / "ckpt")
    tr = T.Trainer(cfg, device="cpu")
    tr.setup()
    tr._preempted = True  # as the SIGTERM handler leaves it
    tr.run(iter(batches(1) * 50), max_steps=50)
    assert int(tr.state.step) == 1  # stopped after the first step
    assert T.latest_checkpoint(cfg.train.checkpoint_path).endswith("ckpt_1")


def test_sigterm_handler_sets_the_flag(tmp_path):
    import signal

    prev = signal.getsignal(signal.SIGTERM)
    try:
        tr = T.Trainer(tiny_cfg(tmp_path), device="cpu",
                       install_signal_handler=True)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.01)
        assert tr._preempted
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_restore_data_iter(tmp_path):
    it = Rows(list(range(10)))
    for _ in range(4):
        next(it)
    cfg = tiny_cfg(tmp_path / "ckpt")
    d = T.save_checkpoint(cfg.train.checkpoint_path,
                          T.create_train_state(cfg, "cpu"), it)
    other = Rows(list(range(10)))
    assert T.restore_data_iter(d, other) and next(other) == 4
    assert not T.restore_data_iter(d, iter(range(3)))  # no set_state
    assert not T.restore_data_iter(str(tmp_path), Rows([]))  # no file


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_resume_equals_uninterrupted(tmp_path, impl):
    """4 steps whole against 2 steps, an async save, a fresh Trainer with
    restore=True (the data iterator resumed) and 2 more steps:
    bit-equal."""
    cfg = tiny_cfg(tmp_path / "ckpt")
    cfg.model.name = "pixellink_resnet50"
    cfg.model.bottleneck_impl = impl
    data = batches(4, seed=3)
    whole = T.Trainer(cfg, device="cpu")
    whole.setup()
    whole.run(Rows(data), 4)

    first = T.Trainer(cfg, device="cpu")
    first.setup()
    it = Rows(data)
    first.run(it, 2)
    T.save_checkpoint(cfg.train.checkpoint_path, first.state, it,
                      block=False)
    cfg.train.restore = True
    resumed = T.Trainer(cfg, device="cpu")
    resumed.setup()
    it = Rows(data)
    resumed.run(it, 2)
    assert it.i == 4 and int(resumed.state.step) == 4
    assert_same_state(resumed.state, whole.state)


def test_restore_is_strict(tmp_path):
    cfg = tiny_cfg(tmp_path / "ckpt")
    state = T.create_train_state(cfg, "cpu")
    d = T.save_checkpoint(cfg.train.checkpoint_path, state)
    saved = T.load_checkpoint(d)
    name = next(iter(saved["model"]))
    for edit, err in (("missing", KeyError), ("extra", KeyError),
                      ("shape", ValueError)):
        bad = {k: dict(v) if isinstance(v, dict) else v
               for k, v in saved.items()}
        if edit == "missing":
            del bad["model"][name]
        elif edit == "extra":
            bad["ema"]["head.unknown.weight"] = torch.zeros(1)
        else:
            bad["model"][name] = torch.zeros(3, 1)
        root = tmp_path / edit
        T.write_checkpoint(str(root), bad)
        with pytest.raises(err):
            T.restore_checkpoint(T.latest_checkpoint(str(root)),
                                 T.create_train_state(cfg, "cpu"))


def test_restore_for_inference_skips_the_optimizer(tmp_path):
    """Step, parameters, BN buffers and EMA restored into a state whose
    optimizer has another kind of state (momentum against Adam)."""
    cfg = tiny_cfg(tmp_path / "ckpt")
    state = trained(cfg, steps=2).state
    d = T.save_checkpoint(cfg.train.checkpoint_path, state)
    cfg.train.optimizer = "momentum"
    other = T.create_train_state(cfg, "cpu",
                                 generator=torch.Generator().manual_seed(5))
    T.restore_checkpoint_for_inference(d, other)
    assert int(other.step) == 2
    for part in ("model", "ema"):
        a, b = T.state_tensors(state)[part], T.state_tensors(other)[part]
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(not v["momentum_buffer"].any()
               for v in T.state_tensors(other)["optimizer"].values())
    with pytest.raises(KeyError):
        T.restore_checkpoint(d, other)  # the optimizers' states differ


def test_warm_start_merges_matching_and_honours_exclude_scopes():
    a = {"backbone.conv.weight": torch.zeros(2, 3),
         "head.pixel_logits.weight": torch.zeros(2),
         "head.link_logits.weight": torch.zeros(4)}
    pre = {"backbone.conv.weight": torch.ones(2, 3),
           "head.pixel_logits.weight": torch.ones(2),
           "head.link_logits.weight": torch.ones(5),  # another shape
           "other.weight": torch.ones(1)}
    merged, n = T.warm_start(a, pre)
    assert n == 2 and float(merged["backbone.conv.weight"].sum()) == 6
    assert not merged["head.link_logits.weight"].any()
    merged, n = T.warm_start(a, pre, exclude_scopes=("head",))
    assert n == 1 and not merged["head.pixel_logits.weight"].any()


def test_setup_warm_starts_from_a_port_checkpoint(tmp_path, capsys):
    """pretrained_model_path: parameters and BN running statistics of the
    checkpoint, a fresh optimizer and step; a .npz path is a slim
    checkpoint."""
    src = trained(tiny_cfg(tmp_path / "pre"), steps=2).state
    T.save_checkpoint(str(tmp_path / "pre"), src)
    cfg = tiny_cfg(pretrained_model_path=str(tmp_path / "pre"))
    state = T.Trainer(cfg, device="cpu").setup()
    assert int(state.step) == 0
    a, b = src.model.state_dict(), state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    n = len(list(state.model.parameters()))
    assert f"warm-started {n} tensors" in capsys.readouterr().out
    # a .npz is a converted slim checkpoint (train/pretrained.py): the
    # tiny backbone has none of resnet_v1_50's names, so nothing is taken
    np.savez(tmp_path / "slim.npz", **{
        "resnet_v1_50/conv1/weights": np.ones((7, 7, 3, 64), np.float32)})
    cfg.train.pretrained_model_path = str(tmp_path / "slim.npz")
    T.Trainer(cfg, device="cpu").setup()
    assert "warm-started 0 tensors" in capsys.readouterr().out


def test_stall_watchdog_warns_and_resets(capsys):
    dog = T.StallWatchdog(0.2, name="t")
    try:
        time.sleep(0.7)
        out = capsys.readouterr().out
        # before any heartbeat: the likely slow first step
        assert "[watchdog:t]" in out and "first step not complete" in out
        assert "nvcc" in out and "CUDA-graph capture" in out
        dog.beat(5)
        time.sleep(0.1)
        assert "[watchdog:t]" not in capsys.readouterr().out
        time.sleep(0.7)
        out = capsys.readouterr().out
        assert "may be hung" in out and "last step 5" in out
    finally:
        dog.stop()


def test_stall_watchdog_disabled(capsys):
    dog = T.StallWatchdog(0)
    assert dog._thread is None
    dog.stop()
    assert capsys.readouterr().out == ""


class _Writer:
    def __init__(self, fail=False):
        self.scalars, self.images, self.fail = [], [], fail

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def add_detection_summaries(self, step, **maps):
        if self.fail:
            raise RuntimeError("no image panel")
        self.images.append((step, {k: v.shape for k, v in maps.items()}))


def test_summaries_every_window_and_image_panel(caplog):
    """Scalars every log window, the image panel every save_summary_steps
    steps; a failing panel never stops training."""
    cfg = tiny_cfg(save_summary_steps=2)
    cfg.train.log_every_steps = 2
    w = _Writer()
    tr = T.Trainer(cfg, device="cpu", summary_writer=w)
    tr.setup()
    tr.run(batches(3), 3)
    assert {s for _, _, s in w.scalars} == {0, 2}
    assert ("total_loss", pytest.approx(w.scalars[0][1]), 0) in w.scalars
    assert [s for s, _ in w.images] == [0, 2]
    assert w.images[0][1] == {"images": (1, SIZE, SIZE, 3),
                              "gt_score": (1, SIZE // 4, SIZE // 4, 1),
                              "pred_score": (1, SIZE // 4, SIZE // 4, 1)}
    tr = T.Trainer(cfg, device="cpu", summary_writer=_Writer(fail=True))
    tr.setup()
    tr.run(batches(3), 3)
    assert int(tr.state.step) == 3
    assert "image summaries failed" in caplog.text


@pytest.mark.parametrize("use_ema", [True, False])
def test_predictor_serves_the_newest_checkpoint(tmp_path, use_ema):
    """Predictor(checkpoint_path=root): the EMA (or raw) parameters and the
    BN running statistics of the newest ckpt_*, the root's operating
    point adopted; the same logits as a state_dict Predictor."""
    root = tmp_path / "ckpt"
    cfg = tiny_cfg(root)
    state = trained(cfg, steps=2).state
    T.save_checkpoint(str(root), state)
    with torch.no_grad():  # the EMA differs from the parameters
        for v in state.ema.values():
            v.add_(0.01)
    T.save_checkpoint(str(root), state)  # ckpt_2 again, replaced
    (root / OPERATING_POINT_FILE).write_text('{"pixel": 0.6, "link": 0.4}')
    pred = Predictor("pixellink_tiny", checkpoint_path=str(root),
                     device="cpu", dtype=torch.float32, use_ema=use_ema)
    assert pred.calibrated and (pred.pixel_thresh, pred.link_thresh) == (
        0.6, 0.4)
    weights = dict(state.model.state_dict())
    if use_ema:
        weights.update(state.ema)
    ref = Predictor("pixellink_tiny", weights=weights, device="cpu",
                    dtype=torch.float32)
    x = torch.from_numpy(batches(1)[0]["images"])
    with torch.inference_mode():
        got, want = pred.model(x), ref.model(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # one ckpt_<step> directory serves as well; a root without one raises
    one = Predictor("pixellink_tiny", checkpoint_path=str(root / "ckpt_2"),
                    device="cpu", dtype=torch.float32,
                    infer=InferConfig(use_calibrated_thresholds=False))
    assert not one.calibrated
    with pytest.raises(FileNotFoundError):
        Predictor("pixellink_tiny", checkpoint_path=str(tmp_path / "none"),
                  device="cpu")


def test_predictor_serves_infer_checkpoint_path(tmp_path):
    """Predictor(infer=InferConfig(checkpoint_path=root)) with no weights
    serves root's newest ckpt_* and its operating point, as JAX's
    Predictor reads cfg.infer.checkpoint_path; a root with no checkpoint
    leaves the seed-0 init; checkpoint_path= overrides the config's."""
    root = tmp_path / "ckpt"
    state = trained(tiny_cfg(root), steps=1).state
    T.save_checkpoint(str(root), state)
    (root / OPERATING_POINT_FILE).write_text('{"pixel": 0.7, "link": 0.3}')
    kw = dict(device="cpu", dtype=torch.float32)
    pred = Predictor("pixellink_tiny", infer=InferConfig(
        checkpoint_path=str(root)), **kw)
    assert pred.calibrated and (pred.pixel_thresh, pred.link_thresh) == (
        0.7, 0.3)
    weights = dict(state.model.state_dict())
    weights.update(state.ema)
    want = Predictor("pixellink_tiny", weights=weights, **kw).model
    init = Predictor("pixellink_tiny", **kw).model
    empty = Predictor("pixellink_tiny", infer=InferConfig(
        checkpoint_path=str(tmp_path / "none")), **kw)
    assert not empty.calibrated
    other = tmp_path / "other"
    T.save_checkpoint(str(other), trained(tiny_cfg(other), steps=2).state)
    over = Predictor("pixellink_tiny", checkpoint_path=str(root),
                     infer=InferConfig(checkpoint_path=str(other)), **kw)
    x = torch.from_numpy(batches(1)[0]["images"])
    with torch.inference_mode():
        for got, ref in ((pred.model, want), (empty.model, init),
                         (over.model, want)):
            a, b = got(x), ref(x)
            assert all(torch.equal(a[k], b[k]) for k in b)
        assert not torch.equal(pred.model(x)["pixel_logits"],
                               init(x)["pixel_logits"])
