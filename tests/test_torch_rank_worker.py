"""One rank of the port's data-parallel and H-sharded CPU tests.

Imports no JAX. The tests spawn it with :func:`run_ranks`; each rank
joins a gloo process group through a file under the test's temporary
directory (no TCP port, so parallel test workers cannot collide), reads
its inputs from that directory (``spec.json``, ``weights.pt`` and the
``.npz`` inputs the test wrote), runs one task and writes
``out_<rank>.pt``:

    python tests/test_torch_rank_worker.py <task> <rank> <world> <dir>

Tasks: ``step`` (one train step, from a batch the test wrote or from
the rank's own loader), ``multi`` (one multi-step dispatch),
``spatial`` (the H-sharded or (data, space) forward of the spec's
arm: ``bottleneck_impl`` and ``pallas_convs``), ``trainer``
(Trainer.run from the host loader: resume bit-equal to an uninterrupted
run, with the whole global batch read on each rank and with per-rank
readers; a preemption flag on one rank; the world-size checks).
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(task: str, world: int, workdir, timeout: float = 180) -> list:
    """Run ``task`` on ``world`` gloo ranks in ``workdir``; asserts each
    exits 0 and returns what each wrote (``out_<rank>.pt``)."""
    workdir = str(workdir)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(r), str(world),
         workdir], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {task}:\n{out[-6000:]}"
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]


def write_inputs(workdir, spec: dict, weights=None, **arrays) -> None:
    """What the ranks read: ``spec.json``, ``weights.pt`` and one
    ``<name>.npz`` per keyword (a dict of arrays)."""
    workdir = str(workdir)
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    if weights is not None:
        torch.save(dict(weights), os.path.join(workdir, "weights.pt"))
    for name, tree in arrays.items():
        np.savez(os.path.join(workdir, f"{name}.npz"), **tree)


def _config(spec):
    from tensorflow_ocr_tpu_torch.config import Config

    cfg = Config()
    cfg.model.name = spec["model"]
    cfg.model.compute_dtype = "float32"
    cfg.model.freeze_bn = spec.get("freeze_bn", False)
    cfg.loss.name = spec.get("loss", "ohem")
    cfg.data.geometry = spec.get("geometry", "RBOX")
    cfg.data.input_size = spec.get("size", 64)
    cfg.train.grad_reduce = spec.get("grad_reduce", "mean")
    for k, v in spec.get("data", {}).items():
        setattr(cfg.data, k, v)
    return cfg


def _npz(workdir, name):
    with np.load(os.path.join(workdir, f"{name}.npz")) as f:
        return {k: f[k] for k in f.files}


def task_step(group, workdir, spec):
    """One train step on this rank's rows of ``batch.npz``, or with
    ``reader`` (a loader seed) on the rows this rank's ``ResumableLoader``
    prepares of its first global batch (``spec["data"]``'s directory and
    batch size)."""
    from tensorflow_ocr_tpu_torch.parallel.mesh import shard_batch
    from tensorflow_ocr_tpu_torch.train import trainer as TT

    cfg = _config(spec)
    state = TT.create_train_state(cfg, "cpu", weights=torch.load(
        os.path.join(workdir, "weights.pt")))
    if "reader" in spec:
        from tensorflow_ocr_tpu_torch.data.resumable import ResumableLoader

        it = ResumableLoader(cfg.data, seed=spec["reader"], group=group)
        batch = TT.device_batch(next(it), "cpu", group=group,
                                global_batch_size=cfg.data.batch_size)
        it.stop()
    else:
        batch = TT.to_device(shard_batch(group, _npz(workdir, "batch")),
                             "cpu")
    m = TT.train_step(state, batch, cfg, TT.make_loss_fn(cfg), group=group)
    return {"state": TT.state_tensors(state), "metrics": m}


def task_multi(group, workdir, spec):
    from tensorflow_ocr_tpu_torch.train import trainer as TT

    cfg = _config(spec)
    state = TT.create_train_state(cfg, "cpu", weights=torch.load(
        os.path.join(workdir, "weights.pt")))
    data = {k: torch.from_numpy(v) for k, v in _npz(workdir, "data").items()}
    idx = torch.from_numpy(_npz(workdir, "idx")["idx"])
    multi = TT.make_multi_train_step(state, cfg, augment=spec["augment"],
                                     group=group)
    m = multi(state, data, idx)
    return {"state": TT.state_tensors(state), "metrics": m}


@contextlib.contextmanager
def arm_calls():
    """Counts what a forward runs of the kernel arms, inside the block:
    ``route`` the (k, input height) of each ``ops/conv.py`` conv2d call
    (the PALLAS_CONVS route), ``fused3x3`` the input height of each fused
    3x3, ``ghost_eval`` the GhostBottleneck units on the ghost eval."""
    from tensorflow_ocr_tpu_torch.models import resnet
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    calls = {"route": [], "fused3x3": [], "ghost_eval": 0}
    conv2d, fused3, ghost_eval = (CV.conv2d, FU.fused_conv3x3,
                                  resnet.GhostBottleneck._eval)

    def route(x, w, *a):
        calls["route"].append((w.shape[-1], x.shape[2]))
        return conv2d(x, w, *a)

    def fused3x3(x, ab, w):
        calls["fused3x3"].append(x.shape[2])
        return fused3(x, ab, w)

    def counted_eval(self, o):
        calls["ghost_eval"] += 1
        return ghost_eval(self, o)

    CV.conv2d, FU.fused_conv3x3 = route, fused3x3
    resnet.GhostBottleneck._eval = counted_eval
    try:
        yield calls
    finally:
        CV.conv2d, FU.fused_conv3x3 = conv2d, fused3
        resnet.GhostBottleneck._eval = ghost_eval


def arm_model(spec, weights):
    """The float32 model of ``spec`` (its ``bottleneck_impl``) with
    ``weights``."""
    from tensorflow_ocr_tpu_torch.models import build_model

    model = build_model(spec["model"], dtype=torch.float32,
                        bottleneck_impl=spec.get("bottleneck_impl", "xla"))
    model.load_state_dict(weights)
    return model


def task_spatial(group, workdir, spec):
    from tensorflow_ocr_tpu_torch.models import layers
    from tensorflow_ocr_tpu_torch.parallel import spatial

    layers.PALLAS_CONVS = spec.get("pallas_convs", False)
    model = arm_model(spec, torch.load(os.path.join(workdir, "weights.pt")))
    mesh = (spatial.make_spatial_mesh(group.world, "cpu")
            if spec["data_axis"] == 1 else
            spatial.make_hybrid_mesh(spec["data_axis"],
                                     group.world // spec["data_axis"], "cpu"))
    run = (spatial.spatial_forward if mesh.data == 1
           else spatial.hybrid_forward)(model, mesh)
    with arm_calls() as calls:
        maps = run(_npz(workdir, "images")["images"])
    return {"maps": maps, "calls": calls}


def _trainer_cfg(workdir, tag, **train):
    from tensorflow_ocr_tpu_torch.config import Config

    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    cfg.model.compute_dtype = "float32"
    cfg.data.training_data_path = os.path.join(workdir, "scenes")
    cfg.data.input_size, cfg.data.batch_size = 64, 4
    cfg.data.max_polys, cfg.data.min_text_size = 16, 4
    cfg.data.num_workers = 1
    cfg.train.checkpoint_path = os.path.join(workdir, tag)
    cfg.train.calibrate_at_checkpoint = False
    cfg.train.log_every_steps = 1
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _host_run(group, cfg, steps, per_rank=False):
    """Trainer.run over ResumableLoader -> PrefetchLoader ->
    DevicePrefetcher(group) for ``steps`` steps; returns the trainer. The
    loader reads the whole global batch, or with ``per_rank`` only this
    rank's rows of it."""
    from tensorflow_ocr_tpu_torch.data.pipeline import (DevicePrefetcher,
                                                        PrefetchLoader)
    from tensorflow_ocr_tpu_torch.data.resumable import ResumableLoader
    from tensorflow_ocr_tpu_torch.train import trainer as TT

    trainer = TT.Trainer(cfg, "cpu", group=group)
    trainer.setup()
    source = ResumableLoader(cfg.data, seed=cfg.train.seed,
                             group=group if per_rank else None)
    loader = DevicePrefetcher(PrefetchLoader(cfg.data, source=source),
                              "cpu", group=group)
    try:
        trainer.run(loader, max_steps=steps)
    finally:
        loader.stop()
    return trainer


def task_trainer(group, workdir, spec):
    from tensorflow_ocr_tpu_torch.configs import baseline_config
    from tensorflow_ocr_tpu_torch.parallel.mesh import make_mesh
    from tensorflow_ocr_tpu_torch.train import trainer as TT

    out = {}
    # resume from rank 0's checkpoint = the uninterrupted run
    whole = _host_run(group, _trainer_cfg(workdir, "whole"), 4)
    first = _host_run(group, _trainer_cfg(workdir, "split",
                                          save_checkpoint_steps=2), 3)
    out["saved"] = sorted(os.listdir(first.cfg.train.checkpoint_path))
    resumed = _host_run(group, _trainer_cfg(workdir, "split",
                                            restore=True), 1)
    a = TT.flat_tree(TT.state_tensors(whole.state))
    b = TT.flat_tree(TT.state_tensors(resumed.state))
    out["unequal"] = [k for k in a if not torch.equal(a[k], b[k])]
    out["state"] = {k: v.clone() for k, v in a.items()}

    # per-rank readers: the whole reader's run, and its resume from rank
    # 0's checkpoint, bit for bit
    rows = TT.flat_tree(TT.state_tensors(_host_run(
        group, _trainer_cfg(workdir, "rows"), 4, per_rank=True).state))
    out["rows_unequal"] = [k for k in a if not torch.equal(a[k], rows[k])]
    first = _host_run(group, _trainer_cfg(workdir, "rows_split",
                                          save_checkpoint_steps=2), 3,
                      per_rank=True)
    out["rows_saved"] = sorted(os.listdir(first.cfg.train.checkpoint_path))
    resumed = _host_run(group, _trainer_cfg(workdir, "rows_split",
                                            restore=True), 1, per_rank=True)
    b = TT.flat_tree(TT.state_tensors(resumed.state))
    out["rows_resumed_unequal"] = [k for k in a
                                   if not torch.equal(a[k], b[k])]

    # a preemption flag on rank 1 alone, raised before step 2's check
    cfg = _trainer_cfg(workdir, "preempt")
    trainer = TT.Trainer(cfg, "cpu", group=group)
    trainer.setup()
    data = _npz(workdir, "batch")

    class Batches:
        i = 0

        def __next__(self):
            if self.i == 2 and group.rank == 1:
                trainer._preempted = True
            self.i += 1
            return data

    trainer.run(Batches(), max_steps=6)
    out["preempt_step"] = int(trainer.state.step)
    out["preempt_saved"] = sorted(os.listdir(cfg.train.checkpoint_path))

    # the world size is checked against num_devices and preset 5
    errors = []
    for cfg in (_trainer_cfg(workdir, "w", num_devices=4),
                baseline_config(5)):
        try:
            TT.Trainer(cfg, "cpu")
        except ValueError as e:
            errors.append(str(e))
    try:
        _trainer_cfg(workdir, "w", num_devices=4).validate()
    except ValueError as e:
        errors.append(str(e))
    out["errors"] = errors
    out["world_ok"] = make_mesh(group.world, "cpu").world
    _trainer_cfg(workdir, "w", num_devices=group.world).validate()
    return out


def main():
    task, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from tensorflow_ocr_tpu_torch.parallel import make_mesh, multihost

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    init = "file://" + os.path.join(workdir, f"init_{task}")
    assert multihost.initialize(init, world, rank, device="cpu")
    assert multihost.initialize()  # idempotent
    group = make_mesh(world, "cpu")
    assert (group.rank, group.world, group.backend) == (rank, world, "gloo")
    out = {"task_step": task_step, "task_multi": task_multi,
           "task_spatial": task_spatial,
           "task_trainer": task_trainer}[f"task_{task}"](group, workdir,
                                                         spec)
    assert "jax" not in sys.modules
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
