"""A multi-rank dry run of the port's data-parallel and sharded paths.

The port's counterpart of ``__graft_entry__.py:24`` ``dryrun_multichip``:
:func:`dryrun_multirank` starts ``n`` ranks of this module on one host
(gloo on the CPU, or NCCL with one GPU a rank) joined through a file,
and each runs, at a tiny size from seeded weights:

1. a data-parallel train step of pixellink_tiny (OHEM), each rank on its
   rows of one global batch;
2. an EAST step of east_tiny (RBOX, the EAST loss);
3. the hybrid (data, space) forward of pixellink_tiny (2 x n/2 where n
   is a multiple of 4, else 1 x n), held against the rank's own forward
   of the whole batch;
4. a 2-step multi-step dispatch over a dataset every rank holds;
5. a checkpoint written by rank 0 and restored by every rank into a
   fresh state, bit-equal to the live one.

After each step and the dispatch the ranks' states must be bit-equal
(their checksums all-gathered). Run it as

    python -c "from tensorflow_ocr_tpu_torch.parallel.dryrun import \\
        dryrun_multirank; dryrun_multirank(2)"
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

SIZE = 64


def dryrun_multirank(n: int, backend: str = "gloo",
                     timeout_s: float = 300.0) -> None:
    """Run the checks above on ``n`` ranks (``backend`` gloo: CPU
    tensors; nccl: ``cuda:<rank>``); raises unless every rank passes."""
    work = tempfile.mkdtemp(prefix="dryrun_multirank_")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tensorflow_ocr_tpu_torch.parallel.dryrun",
         "--rank", str(r), "--world", str(n), "--backend", backend,
         "--work", work], env=env, cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"dryrun_multirank({n}, {backend}): rank "
                           f"{bad[0]} failed:\n{outs[bad[0]][-4000:]}")
    print(f"dryrun_multirank({n}, {backend}): ok")


def scenes(rng: np.random.RandomState, b: int, size: int, k: int = 4):
    """``b`` uint8 images of ``size``² with ``k`` text quads each (about
    one in five tagged ignored) and their EAST geometry."""
    from tensorflow_ocr_tpu_torch.data.icdar import east_poly_geometry

    polys = np.zeros((b, k, 4, 2), np.float32)
    for i in range(b):
        for j in range(k):
            x0, y0 = rng.uniform(0, 0.6 * size, 2)
            w, h = rng.uniform(0.2, 0.4) * size, rng.uniform(0.2, 0.3) * size
            polys[i, j] = [[x0, y0], [x0 + w, y0 + 2], [x0 + w, y0 + h],
                           [x0, y0 + h - 2]]
    batch = {"images": rng.randint(0, 256, (b, size, size, 3)).astype(
                 np.uint8),
             "polys": polys, "tags": rng.rand(b, k) < 0.2,
             "valid": np.ones((b, k), bool)}
    geo = [east_poly_geometry(p) for p in polys]
    for i, key in enumerate(("shrunk", "rects", "angles")):
        batch[key] = np.stack([g[i] for g in geo])
    return batch


def _config(name, loss="ohem"):
    from tensorflow_ocr_tpu_torch.config import Config

    cfg = Config()
    cfg.model.name, cfg.loss.name = name, loss
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = SIZE
    cfg.train.calibrate_at_checkpoint = False
    return cfg


def _agree(group, state, what: str) -> None:
    """Every rank's state bit-equal to rank 0's (per-tensor checksums of
    the bytes, all-gathered)."""
    import torch.distributed as dist

    from tensorflow_ocr_tpu_torch.train import trainer as T

    sums = torch.stack([
        t.detach().reshape(-1).contiguous().view(torch.uint8).to(
            torch.float64).mul(torch.arange(1, t.numel() * t.element_size()
                                            + 1, device=t.device,
                                            dtype=torch.float64)).sum()
        for t in T.flat_tree(T.state_tensors(state)).values()])
    if group.backend == "nccl":
        sums = sums.to(group.device)
    else:  # gloo gathers host tensors
        sums = sums.cpu()
    parts = [torch.empty_like(sums) for _ in range(group.world)]
    dist.all_gather(parts, sums, group=group.group)
    if not all(torch.equal(parts[0], p) for p in parts[1:]):
        raise AssertionError(f"{what}: the ranks' states differ")


def _rank_main(rank: int, world: int, backend: str, work: str) -> None:
    from tensorflow_ocr_tpu_torch.parallel import make_mesh, multihost
    from tensorflow_ocr_tpu_torch.parallel import spatial
    from tensorflow_ocr_tpu_torch.train import trainer as T

    torch.set_num_threads(1)
    device = "cpu" if backend == "gloo" else "cuda"
    multihost.initialize("file://" + os.path.join(work, "init"), world,
                         rank, device=device, backend=backend)
    group = make_mesh(world, device)
    rng = np.random.RandomState(0)  # the same draws on every rank
    batch = scenes(rng, 2 * world, SIZE)

    for name, loss in (("pixellink_tiny", "ohem"), ("east_tiny", "east")):
        cfg = _config(name, loss)
        state = T.create_train_state(cfg, group.device)
        local = T.device_batch(batch, group.device, True, group,
                               2 * world)
        m = T.train_step(state, local, cfg, T.make_loss_fn(cfg),
                         group=group)
        if not np.isfinite(float(m["total_loss"])):
            raise AssertionError(f"{name} step: loss {m['total_loss']}")
        _agree(group, state, f"{name} step")

    # the hybrid forward against this rank's forward of the whole batch
    data = 2 if world % 4 == 0 else 1
    mesh = spatial.make_hybrid_mesh(data, world // data, device)
    model = T.build_model("pixellink_tiny", dtype=torch.float32).to(
        group.device)
    hw = (32 * mesh.space, 32)
    images = rng.randint(0, 256, (2 * data, *hw, 3)).astype(np.float32)
    maps = spatial.hybrid_forward(model, mesh)(images)
    with torch.no_grad():
        want = model(torch.from_numpy(images).to(group.device))
    for k, v in want.items():
        err = float((maps[k] - v).abs().max())
        if err > 1e-4 * float(v.abs().max()):
            raise AssertionError(f"hybrid forward {k}: error {err}")

    # the multi-step dispatch, then a checkpoint round trip
    cfg = _config("pixellink_tiny")
    cfg.train.checkpoint_path = os.path.join(work, "ckpt")
    trainer = T.Trainer(cfg, device, group=group)
    trainer.setup()
    ds = T.device_dataset(batch, cfg, group.device)
    multi = T.make_multi_train_step(trainer.state, cfg, T.label_keys(cfg),
                                    group=group)
    idx = torch.from_numpy(np.stack([rng.permutation(2 * world)
                                     for _ in range(2)]))
    m = multi(trainer.state, ds, idx.to(group.device))
    multi.release()
    if not np.isfinite(float(m["total_loss"])):
        raise AssertionError("multi-step dispatch: non-finite loss")
    _agree(group, trainer.state, "multi-step dispatch")
    trainer.save()
    ck = T.latest_checkpoint(cfg.train.checkpoint_path)
    fresh = T.create_train_state(cfg, group.device)
    T.restore_checkpoint(ck, fresh)
    a = T.flat_tree(T.state_tensors(trainer.state))
    b = T.flat_tree(T.state_tensors(fresh))
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    if bad or int(fresh.step) != 2:
        raise AssertionError(f"checkpoint round trip: {bad[:4]}")
    group.barrier()
    import torch.distributed as dist

    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--work", required=True)
    a = ap.parse_args()
    _rank_main(a.rank, a.world, a.backend, a.work)


if __name__ == "__main__":
    main()
